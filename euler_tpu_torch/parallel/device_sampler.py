"""Device-resident neighbor sampling (counterpart of
euler_tpu/parallel/device_sampler.py), replicated tables on one device.

Two tables live on the device: neighbor rows [N+1, C] int32 (each node's
neighbors capped at C, front-packed, pad id N in empty slots) and their
inclusive cumulative weights [N+1, C] float32. Row N is an all-pad row.
A hop draws, per (row, slot), a column of the row's neighbor list:
inverse-CDF over the cumulative weights, or floor(u·degree) on
unit-weight tables (`uniform=True`, one row gather per hop).

Two more layouts, as the reference has them:
- fused: one [N+1, 2C] int32 table, the neighbor ids beside the
  cumulative weights' float32 bits (`fuse_tables_host`); a hop reads
  one row and draws as the inverse-CDF path does (`sample_hop_fused`);
- alias: beside the split tables, a [N+1, C] int32 table of packed
  Vose alias words (`build_alias_tables`); a hop draws a column with
  two uniforms and one word read (`sample_hop(alias_table=...)`).

Every draw is split into uniforms → pick. `sample_hop` takes the
uniforms as a tensor, or draws them from the caller's torch.Generator.
Given the same uniforms the picks are bit-exact with the JAX package's.
The generator's bits are not JAX's: a torch stream and a threefry key
give different uniforms from the same seed.

The table builders are copies of the reference's numpy code, so a table
built here is byte-identical to the reference's from the same CSR.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.platform import DeviceLike, resolve_device

_ROADMAP_SHARDED = "not ported yet: ROADMAP.md Queue A, 'Multi-GPU'"

# Row-chunk sizes for table-scale host passes (reference: _CHUNK_ROWS,
# _ALIAS_CHUNK_ROWS): the Vose build holds ~8 float64/int64 working
# arrays a chunk, so it chunks finer.
_CHUNK_ROWS = 262_144
_ALIAS_CHUNK_ROWS = 32_768
# rows a thread fills at a time in a table build (_fill_table_parallel)
_FILL_CHUNK_ROWS = 16_384

# Packed alias word layout (reference: the note at ALIAS_SENTINEL): one
# int32 per slot, bits 16..30 the alias column, bits 0..15 the
# acceptance probability quantized to uint16 (P(keep) = prob / 65535).
# Pad slots and dead rows (total weight <= 0) hold -1, so a row's
# active column count is (word >= 0).sum(-1).
ALIAS_SENTINEL = np.int32(-1)
_ALIAS_PROB_MAX = 65535


def _edge_uniforms(seed: int, rows: np.ndarray,
                   pos: np.ndarray) -> np.ndarray:
    """Stateless per-edge uniforms in [0, 1): a splitmix64 finalizer
    over (seed, global row, position-within-row).

    Copy of euler_tpu/parallel/device_sampler.py:_edge_uniforms."""
    with np.errstate(over="ignore"):
        x = (rows.astype(np.uint64) << np.uint64(32)) \
            ^ pos.astype(np.uint64)
        x ^= np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * \
            np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


def _fill_table_rows(C: int, pad: int, global_rows: np.ndarray,
                     deg: np.ndarray, nbr_rows: np.ndarray,
                     ws: np.ndarray, seed: int,
                     out_nbr: np.ndarray = None,
                     out_w: np.ndarray = None):
    """[k, C] (nbr, weight) table rows for k nodes from their
    concatenated CSR neighbor lists. Rows with degree <= C front-pack
    their edges; hubs keep a weighted C-subset drawn without
    replacement (Efraimidis–Spirakis keys u^(1/w) over the stateless
    per-edge uniforms; zero-weight edges only fill leftover slots; rows
    of total weight <= 0 stay all-pad). out_nbr/out_w: optional
    pre-initialized (pad / zero) destinations filled in place.

    Copy of euler_tpu/parallel/device_sampler.py:_fill_table_rows."""
    k = int(len(deg))
    nbr_tab = out_nbr if out_nbr is not None \
        else np.full((k, C), pad, dtype=np.int32)
    w_tab = out_w if out_w is not None \
        else np.zeros((k, C), dtype=np.float32)
    if k == 0:
        return nbr_tab, w_tab
    deg = np.asarray(deg, dtype=np.int64)
    edge_node = np.repeat(np.arange(k, dtype=np.int64), deg)
    offs0 = np.concatenate([[0], np.cumsum(deg)])
    pos_in_row = (np.arange(len(nbr_rows), dtype=np.int64)
                  - np.repeat(offs0[:-1], deg))
    small = deg <= C
    if small.any():
        keep = small[edge_node]
        nbr_tab[edge_node[keep], pos_in_row[keep]] = nbr_rows[keep]
        w_tab[edge_node[keep], pos_in_row[keep]] = ws[keep]
        del keep
    hubs = ~small
    if hubs.any():
        hub_edge = hubs[edge_node]
        he_node = edge_node[hub_edge]
        he_w = ws[hub_edge].astype(np.float64)
        he_nbr = nbr_rows[hub_edge]
        u = _edge_uniforms(seed, np.asarray(global_rows)[he_node],
                           pos_in_row[hub_edge])
        with np.errstate(divide="ignore", over="ignore"):
            key = np.where(he_w > 0,
                           np.exp(np.log(np.maximum(u, 1e-300)) /
                                  np.maximum(he_w, 1e-300)),
                           u - 2.0)
        del u
        # (row asc, key desc) at full key precision; equal keys break by
        # within-row edge order
        order = np.lexsort((-key, he_node))
        del key
        he_node = he_node[order]
        counts = np.bincount(he_node, minlength=k).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(he_node.size, dtype=np.int64) - starts[he_node]
        top = rank < C
        rows_t, cols_t = he_node[top], rank[top]
        sel = order[top]
        nbr_tab[rows_t, cols_t] = he_nbr[sel]
        w_tab[rows_t, cols_t] = he_w[sel].astype(np.float32)
        tot_by_row = np.bincount(edge_node[hub_edge],
                                 weights=ws[hub_edge], minlength=k)
        dead = hubs & (tot_by_row <= 0)
        if dead.any():
            nbr_tab[dead] = pad
            w_tab[dead] = 0.0
    return nbr_tab, w_tab


def _fill_table_parallel(C: int, offsets: np.ndarray, nbr_rows: np.ndarray,
                         ws: np.ndarray, seed: int, out_nbr: np.ndarray,
                         out_w: np.ndarray) -> None:
    """_fill_table_rows over every row of a CSR, in chunks of
    _FILL_CHUNK_ROWS rows filled by a pool of threads (numpy releases
    the GIL in its sorts and elementwise passes). A row's slots depend
    only on its own edges and its global row (the per-edge uniforms are
    stateless), so the tables equal one pass over all rows byte for
    byte, as the reference builds them."""
    n = len(offsets) - 1
    bounds = list(range(0, n, _FILL_CHUNK_ROWS)) + [n]

    def fill(lo: int, hi: int) -> None:
        a, b = int(offsets[lo]), int(offsets[hi])
        _fill_table_rows(C, n, np.arange(lo, hi, dtype=np.int64),
                         np.diff(offsets[lo:hi + 1]), nbr_rows[a:b],
                         ws[a:b], seed, out_nbr=out_nbr[lo:hi],
                         out_w=out_w[lo:hi])

    chunks = list(zip(bounds[:-1], bounds[1:]))
    with ThreadPoolExecutor(min(len(chunks), os.cpu_count() or 1)
                            or 1) as pool:
        for f in [pool.submit(fill, lo, hi) for lo, hi in chunks]:
            f.result()


def _detect_uniform_rows(nbr_tab: np.ndarray, w_tab: np.ndarray,
                         pad: Optional[int] = None) -> bool:
    """True iff every row's positive-weight slots carry one equal weight,
    are exactly its non-pad slots, and are front-packed — then the
    uniform draw is distribution-identical to the inverse-CDF draw.
    pad: the pad row id when nbr_tab is a row chunk of a larger table.

    Copy of euler_tpu/parallel/device_sampler.py:_detect_uniform_rows."""
    if pad is None:
        pad = nbr_tab.shape[0] - 1
    C = nbr_tab.shape[1]
    nonpad = nbr_tab != pad
    pos = w_tab > 0
    if not (pos == nonpad).all():
        return False
    deg = nonpad.sum(axis=1)
    if not (nonpad == (np.arange(C) < deg[:, None])).all():
        return False
    rmax = w_tab.max(axis=1, keepdims=True)
    return bool(((w_tab == 0) | (w_tab == rmax)).all())


def _check_alias_layout(alias: bool, fused: bool, shard_rows: bool) -> None:
    """The reference's own refusals (device_sampler.py:
    _check_alias_layout), with its messages."""
    if alias and fused:
        raise ValueError(
            "DeviceNeighborTable(alias=True) needs the split nbr/cum "
            "layout — the fused [N+1, 2C] table has no slot for the "
            "alias words. Build with fused=False.")
    if alias and shard_rows:
        raise ValueError(
            "DeviceNeighborTable(alias=True) supports replicated tables "
            "only: the alias draw derives pad from the table shape, "
            "which row-sharding pads to the model-axis multiple. Use "
            "the weighted inverse-CDF path with row-sharded tables.")


def _check_layout(fused: bool, alias: bool, shard_rows: bool) -> None:
    _check_alias_layout(alias, fused, shard_rows)
    if shard_rows:
        raise NotImplementedError(
            f"row-sharded tables are {_ROADMAP_SHARDED}")


def _vose_rows(w: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Per-row Vose alias construction, vectorized over rows: w [R, C]
    slot weights, active [R, C] the columns a draw can land on → packed
    int32 words [R, C]; rows whose active weight totals <= 0 come back
    all-sentinel. A two-pointer pass over each row's sorted scaled
    probabilities finalizes one column per live row per iteration, at
    most C + 1 iterations.

    Copy of euler_tpu/parallel/device_sampler.py:_vose_rows."""
    R, C = w.shape
    out = np.full((R, C), ALIAS_SENTINEL, dtype=np.int32)
    if R == 0:
        return out
    w = np.where(active, w, 0.0).astype(np.float64)
    K = active.sum(axis=1).astype(np.int64)                 # [R]
    W = w.sum(axis=1)                                       # [R]
    live = (K > 0) & (W > 0)
    if not live.any():
        return out
    with np.errstate(invalid="ignore", divide="ignore"):
        p = w * (K[:, None] / W[:, None])                   # target 1.0
    # inactive columns sort to the far right and are never entered
    # (l starts at K-1); dead rows are skipped entirely
    p = np.where(active & live[:, None], p, np.inf)
    order = np.argsort(p, axis=1, kind="stable")            # ascending
    p_ord = np.take_along_axis(p, order, axis=1)            # [R, C]
    prob = np.ones((R, C))          # final prob, by sorted position
    alias = order.copy()            # final alias target column, ditto
    s = np.zeros(R, dtype=np.int64)                 # next small (left)
    l = np.maximum(K - 1, 0)                        # current large
    rem = np.take_along_axis(p_ord, l[:, None], axis=1)[:, 0]
    done = ~live
    for _ in range(C + 1):
        a = np.flatnonzero(~done)
        if a.size == 0:
            break
        fin = s[a] >= l[a]
        f = a[fin]
        if f.size:
            # terminal column: mass conservation leaves rem ≈ 1 here
            prob[f, l[f]] = np.clip(rem[f], 0.0, 1.0)
            done[f] = True
        r = a[~fin]
        if r.size:
            sm = rem[r] >= 1.0
            rs = r[sm]          # finalize the next small against l
            if rs.size:
                ps = p_ord[rs, s[rs]]
                prob[rs, s[rs]] = np.clip(ps, 0.0, 1.0)
                alias[rs, s[rs]] = order[rs, l[rs]]
                rem[rs] += ps - 1.0
                s[rs] += 1
            rd = r[~sm]         # current large depleted: it becomes a
            if rd.size:         # small, finalized against the next one
                prob[rd, l[rd]] = np.clip(rem[rd], 0.0, 1.0)
                alias[rd, l[rd]] = order[rd, l[rd] - 1]
                l[rd] -= 1
                rem[rd] = p_ord[rd, l[rd]] + rem[rd] - 1.0
    q = np.rint(prob * _ALIAS_PROB_MAX).astype(np.int64)
    words = (alias.astype(np.int64) << 16) | q
    # scatter back from sorted position to actual column, live active
    # slots only — everything else keeps the sentinel
    keep = live[:, None] & (np.arange(C)[None, :] < K[:, None])
    ri, pi = np.nonzero(keep)
    out[ri, order[ri, pi]] = words[ri, pi].astype(np.int32)
    return out


def _alias_rows_block(nb: np.ndarray, w: np.ndarray,
                      pad: int) -> np.ndarray:
    """Packed alias words for one row block with an explicit pad id. A
    front-packed row's active columns are its non-pad prefix, any other
    row's all C columns.

    Copy of euler_tpu/parallel/device_sampler.py:_alias_rows_block."""
    C = nb.shape[1]
    cols = np.arange(C)
    nonpad = nb != pad
    deg = nonpad.sum(axis=1)
    front = (nonpad == (cols < deg[:, None])).all(axis=1)
    active = np.where(front[:, None], cols < deg[:, None], True)
    return _vose_rows(w, active)


def build_alias_tables(nbr_tab: np.ndarray,
                       cum_tab: Optional[np.ndarray] = None,
                       w_tab: Optional[np.ndarray] = None,
                       chunk_rows: int = _ALIAS_CHUNK_ROWS) -> np.ndarray:
    """[N+1, C] neighbor table and its slot weights (given directly, or
    as the inclusive cumsum) → [N+1, C] packed int32 alias table. Row
    chunks of chunk_rows bound the working set; no full-table float
    copy is made.

    Copy of euler_tpu/parallel/device_sampler.py:build_alias_tables,
    its row blocks built on a pool of threads; counted as rows rebuilt
    (alias_rows_rebuilt_total)."""
    if (cum_tab is None) == (w_tab is None):
        raise ValueError(
            "build_alias_tables needs exactly one of cum_tab / w_tab")
    n_rows, C = nbr_tab.shape
    if C > 255:
        raise ValueError(
            f"alias words pack the column index into 8 bits — cap C "
            f"must be <= 255, got {C}")
    pad = n_rows - 1
    out = np.empty((n_rows, C), dtype=np.int32)
    step = max(int(chunk_rows), 1)

    def block(lo: int) -> None:
        hi = min(lo + step, n_rows)
        nb = np.asarray(nbr_tab[lo:hi])
        if w_tab is not None:
            w = np.asarray(w_tab[lo:hi]).astype(np.float32, copy=False)
        else:
            cc = np.asarray(cum_tab[lo:hi]).astype(np.float32,
                                                   copy=False)
            w = np.diff(cc, axis=1,
                        prepend=np.zeros((cc.shape[0], 1), np.float32))
        out[lo:hi] = _alias_rows_block(nb, w, pad)

    # each row block is independent: a pool of threads builds them
    # (numpy releases the GIL in its passes), the words unchanged
    starts = range(0, n_rows, step)
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)
                            or 1) as pool:
        for f in [pool.submit(block, lo) for lo in starts]:
            f.result()
    _alias_patch_counter("rebuilt").inc(n_rows)
    return out


def _alias_patch_counter(kind: str):
    """alias_rows_{patched,rebuilt}_total on the obs registry: table rows
    re-derived by patch_rows against rows built by full alias builds
    (copy of euler_tpu/parallel/device_sampler.py:_alias_patch_counter)."""
    from euler_tpu_torch import obs

    helps = {
        "patched": "alias/table rows re-derived by incremental patching",
        "rebuilt": "alias table rows built by full-table builds",
    }
    return obs.default_registry().counter(
        f"alias_rows_{kind}_total", helps[kind])


def fuse_tables_host(nbr_tab: np.ndarray, cum_tab: np.ndarray) -> np.ndarray:
    """[N+1, C] neighbor ids and [N+1, C] float32 cumulative weights →
    one [N+1, 2C] int32 table, the weights' bits in the right half.

    Copy of euler_tpu/parallel/device_sampler.py:fuse_tables_host."""
    return np.concatenate(
        [np.asarray(nbr_tab).astype(np.int32, copy=False),
         np.asarray(cum_tab).astype(np.float32, copy=False)
            .view(np.int32)], axis=1)


class DeviceNeighborTable:
    """Neighbor rows + cumulative weights on one device.

    Attributes: neighbors [N+1, C] int32, cum_weights [N+1, C] float32,
    pad_row N, cap C, uniform_rows (every row unit-weight), and the
    truncation stats hub_frac / edge_keep_frac / max_degree.

    DeviceNeighborTable(graph, ...) reads a graph engine as the
    reference's constructor does (euler_tpu/parallel/device_sampler.py:
    62-93): rows in graph.all_node_ids() order, so the same rows index
    the feature store built from the same graph; each node's neighbors
    from get_full_neighbor under the edge-type filter, as engine rows
    (a neighbor the engine does not hold maps to the pad row).
    from_csr builds the same tables from CSR arrays, from_arrays uploads
    prebuilt ones.

    fused=True places only the [N+1, 2C] fused table (fused_table;
    neighbors and cum_weights are None), as the reference's _place
    does. alias=True also places the [N+1, C] alias table
    (alias_table); it needs the split layout. Row-sharded tables
    (shard_rows=True) are not ported yet.

    patch_rows(graph, dirty_ids) re-derives the rows of a delta's dirty
    ids after graph.apply_delta, as the reference's does; it binds new
    tensors and never writes the old ones (see its docstring)."""

    def __init__(self, graph, cap: int = 32, edge_types=None,
                 seed: int = 0, keep_host: bool = False,
                 shard_rows: bool = False, fused: bool = False,
                 alias: bool = False, device: DeviceLike = None):
        _check_layout(fused, alias, shard_rows)
        dev = resolve_device(device)
        ids = graph.all_node_ids()
        n = len(ids)
        offs, nbrs, ws, _ = graph.get_full_neighbor(ids, edge_types)
        del ids
        nbr_rows = graph.node_rows(nbrs, missing=n)
        del nbrs
        self._build(offs, nbr_rows, ws, cap, seed, dev, keep_host, fused,
                    alias)
        # patch_rows re-derives dirty rows under the same filter and keys
        self._edge_types = edge_types

    @classmethod
    def from_csr(cls, offsets: np.ndarray, neighbors: np.ndarray,
                 weights: Optional[np.ndarray] = None, cap: int = 32,
                 seed: int = 0, device: DeviceLike = None,
                 keep_host: bool = False, fused: bool = False,
                 alias: bool = False) -> "DeviceNeighborTable":
        """Build from CSR adjacency: node i's neighbor rows are
        neighbors[offsets[i]:offsets[i+1]] (values in [0, N], N = pad),
        with edge weights (default 1). Same tables as the reference's
        DeviceNeighborTable(graph, cap, seed, fused, alias) over that
        adjacency; the alias words come from the exact slot weights,
        before the cumsum, as the reference builds them. keep_host
        keeps the numpy split tables as host_tables."""
        _check_layout(fused, alias, False)
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self._build(offsets, neighbors, weights, cap, seed, dev, keep_host,
                    fused, alias)
        return self

    def _build(self, offsets, neighbors, weights, cap: int, seed: int,
               dev: torch.device, keep_host: bool, fused: bool,
               alias: bool) -> None:
        offsets = np.asarray(offsets, np.int64)
        n = len(offsets) - 1
        deg = np.diff(offsets)
        nbr_rows = np.asarray(neighbors, np.int32)
        ws = np.ones(len(nbr_rows), np.float32) if weights is None \
            else np.asarray(weights, np.float32)
        C = int(cap)
        nbr_tab = np.full((n + 1, C), n, dtype=np.int32)
        w_tab = np.zeros((n + 1, C), dtype=np.float32)
        _fill_table_parallel(C, offsets, nbr_rows, ws, seed,
                             out_nbr=nbr_tab[:n], out_w=w_tab[:n])
        stats = {
            "hub_frac": float((deg > C).mean()) if n else 0.0,
            "edge_keep_frac": float(np.minimum(deg, C).sum()
                                    / max(len(nbr_rows), 1)),
            "max_degree": int(deg.max()) if n else 0,
            "uniform_rows": _detect_uniform_rows(nbr_tab, w_tab),
        }
        alias_tab = build_alias_tables(nbr_tab, w_tab=w_tab) \
            if alias else None
        cum = np.cumsum(w_tab, axis=1, dtype=np.float32)
        del w_tab
        self._place(nbr_tab, cum, stats, dev, fused, alias_tab)
        self._seed, self._edge_types = int(seed), None
        if keep_host:
            self.host_tables = (nbr_tab, cum)

    @classmethod
    def from_arrays(cls, nbr_tab: np.ndarray, cum_tab: np.ndarray,
                    stats: Optional[dict] = None,
                    device: DeviceLike = None, fused: bool = False,
                    alias: bool = False,
                    shard_rows: bool = False) -> "DeviceNeighborTable":
        """Upload prebuilt [N+1, C] tables. uniform_rows comes from
        stats or is recomputed chunk-wise from the tables; alias=True
        builds the alias table from the cum rows, chunk-wise."""
        _check_layout(fused, alias, shard_rows)
        stats = dict(stats or {})
        if stats.get("uniform_rows") is None:
            pad = int(nbr_tab.shape[0]) - 1
            u = True
            for lo in range(0, cum_tab.shape[0], _CHUNK_ROWS):
                cc = np.asarray(cum_tab[lo:lo + _CHUNK_ROWS],
                                dtype=np.float32)
                w = np.diff(cc, axis=1,
                            prepend=np.zeros((cc.shape[0], 1), np.float32))
                if not _detect_uniform_rows(
                        np.asarray(nbr_tab[lo:lo + _CHUNK_ROWS]), w,
                        pad=pad):
                    u = False
                    break
            stats["uniform_rows"] = u
        alias_tab = build_alias_tables(np.asarray(nbr_tab),
                                       cum_tab=np.asarray(cum_tab)) \
            if alias else None
        self = cls.__new__(cls)
        self._place(np.ascontiguousarray(nbr_tab, np.int32),
                    np.ascontiguousarray(cum_tab, np.float32),
                    stats, resolve_device(device), fused, alias_tab)
        # prebuilt tables carry no build provenance: patch_rows assumes
        # seed 0 and no edge-type filter, as the reference's from_arrays
        self._seed, self._edge_types = 0, None
        return self

    def _place(self, nbr_tab: np.ndarray, cum_tab: np.ndarray, stats: dict,
               dev: torch.device, fused: bool = False,
               alias_tab: Optional[np.ndarray] = None) -> None:
        self.device = dev
        self.cap = int(nbr_tab.shape[1])
        self.pad_row = int(nbr_tab.shape[0]) - 1
        for k in ("hub_frac", "edge_keep_frac", "max_degree"):
            setattr(self, k, stats.get(k))
        self.uniform_rows = bool(stats["uniform_rows"])
        self.fused = bool(fused)
        if self.fused:
            # one [N+1, 2C] table, one row gather per hop; the split
            # views are not uploaded (reference _place)
            self.fused_table = torch.from_numpy(
                fuse_tables_host(nbr_tab, cum_tab)).to(dev)
            self.neighbors = self.cum_weights = None
        else:
            self.fused_table = None
            self.neighbors, self.cum_weights = _upload(nbr_tab, dev), \
                _upload(cum_tab, dev)
        self.alias_table = None if alias_tab is None else \
            _upload(alias_tab, dev)
        self.host_tables = None

    @property
    def tables(self):
        """Tensors to merge into a model's static batch: nbrcum_table
        alone for the fused layout, else nbr_table and cum_table (and
        alias_table with the alias layout)."""
        if self.fused:
            return {"nbrcum_table": self.fused_table}
        out = {"nbr_table": self.neighbors, "cum_table": self.cum_weights}
        if self.alias_table is not None:
            out["alias_table"] = self.alias_table
        return out

    def patch_rows(self, graph, dirty_ids) -> dict:
        """O(dirty) table maintenance after graph.apply_delta(...), as
        the reference's patch_rows (euler_tpu/parallel/
        device_sampler.py:211-348): only the rows of the dirty ids are
        re-derived (one neighbor query, one _fill_table_rows block, one
        Vose rebuild of their alias words); new nodes (engine rows past
        the old pad) grow the tables and the old pad sentinels are
        remapped to the new pad id. The patched tables equal a build
        from scratch on the final edge set byte for byte (a row's
        content depends only on its own edges and its row; engine rows
        are append-only). Ids the graph does not know drop out.

        The tables are new tensors after a patch, never the old ones
        written in place, as the reference's `.at[rows].set` gives new
        arrays: without growth each is cloned on its device and the
        dirty rows are scattered into the clone ("row_scatter"); growth
        uploads the grown host tables ("replace"); an empty patch
        uploads nothing ("none"). An estimator that merged `tables`
        before the patch keeps reading the old rows (and a K-step CUDA
        graph captured on them stays valid); `static_batch.update(
        table.tables)` merges the new ones, and the loop then captures
        again. Kept host_tables are patched in place without growth.

        Split tables only: the fused layout raises the reference's
        ValueError (row-sharded tables are not built by the port).
        uniform_rows can only turn False, max_degree tracks the max.
        Counted as alias_rows_patched_total. Returns {rows_patched,
        rows_total, grown_rows, rebuild_frac, upload}."""
        if self.fused:
            raise ValueError(
                "patch_rows supports replicated split tables only — the "
                "fused bitcast layout and row-sharded shape padding "
                "would both need a full re-place anyway; rebuild those "
                "tables instead")
        dirty_ids = np.asarray(dirty_ids, dtype=np.uint64).ravel()
        old_pad = self.pad_row
        n_new = int(graph.node_count)
        if n_new < old_pad:
            raise ValueError(
                f"graph shrank ({n_new} nodes < table's {old_pad}) — "
                "deltas are append-only; rebuild the table")
        C = self.cap
        grown = n_new - old_pad
        has_alias = self.alias_table is not None
        dev = self.device
        nbr = cum = alias_tab = None
        if grown:
            if self.host_tables is not None:
                nbr, cum = self.host_tables
            else:
                nbr, cum = _download(self.neighbors), \
                    _download(self.cum_weights)
            # the old pad sentinels point at the moved pad row (alias
            # words are column-relative and need no remap)
            g_nbr = np.full((n_new + 1, C), n_new, dtype=np.int32)
            g_cum = np.zeros((n_new + 1, C), dtype=np.float32)
            old_rows = nbr[:old_pad]
            g_nbr[:old_pad] = np.where(old_rows == old_pad, n_new,
                                       old_rows)
            g_cum[:old_pad] = cum[:old_pad]
            nbr, cum = g_nbr, g_cum
            if has_alias:
                alias_tab = np.full((n_new + 1, C), ALIAS_SENTINEL,
                                    dtype=np.int32)
                alias_tab[:old_pad] = _download(self.alias_table)[:old_pad]
        # dirty ids → engine rows, resolved once; ids the graph does not
        # know resolve to the pad row and drop out
        all_rows = graph.node_rows(dirty_ids, missing=n_new) \
            .astype(np.int64)
        ok = all_rows < n_new
        order = np.argsort(all_rows[ok], kind="stable")
        sorted_rows = all_rows[ok][order]
        keep_first = np.ones(sorted_rows.size, bool)
        keep_first[1:] = sorted_rows[1:] != sorted_rows[:-1]
        rows = sorted_rows[keep_first]      # unique, ascending
        stats = {"rows_patched": int(rows.size), "rows_total": n_new,
                 "grown_rows": int(grown),
                 "rebuild_frac": float(rows.size / max(n_new, 1)),
                 "upload": ("replace" if grown else
                            "row_scatter" if rows.size else "none")}
        if rows.size:
            # the dirty ids in row order, so the neighbor lists line up
            # one to one with `rows`
            ids = dirty_ids[ok][order][keep_first]
            offs, nbrs, ws, _ = graph.get_full_neighbor(
                ids, self._edge_types)
            deg = np.diff(offs.astype(np.int64))
            nbr_rows = graph.node_rows(nbrs, missing=n_new).astype(np.int32)
            blk_nbr, blk_w = _fill_table_rows(
                C, n_new, rows, deg, nbr_rows, ws.astype(np.float32),
                self._seed)
            blk_cum = np.cumsum(blk_w, axis=1, dtype=np.float32)
            blk_alias = (_alias_rows_block(blk_nbr, blk_w, n_new)
                         if has_alias else None)
            if grown:
                nbr[rows] = blk_nbr
                cum[rows] = blk_cum
                if has_alias:
                    alias_tab[rows] = blk_alias
            else:
                if self.host_tables is not None:
                    self.host_tables[0][rows] = blk_nbr
                    self.host_tables[1][rows] = blk_cum
                at = torch.from_numpy(rows).to(dev)
                self.neighbors = _scattered(self.neighbors, at, blk_nbr)
                self.cum_weights = _scattered(self.cum_weights, at, blk_cum)
                if has_alias:
                    self.alias_table = _scattered(self.alias_table, at,
                                                  blk_alias)
            self.uniform_rows = bool(
                self.uniform_rows
                and _detect_uniform_rows(blk_nbr, blk_w, pad=n_new))
            if deg.size:
                self.max_degree = max(int(self.max_degree or 0),
                                      int(deg.max()))
        self.pad_row = n_new
        if grown:
            self.neighbors, self.cum_weights = _upload(nbr, dev), \
                _upload(cum, dev)
            if has_alias:
                self.alias_table = _upload(alias_tab, dev)
            if self.host_tables is not None:
                self.host_tables = (nbr, cum)
        _alias_patch_counter("patched").inc(stats["rows_patched"])
        return stats


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host table on `dev`, in memory of its own (on the CPU too,
    where from_numpy would share the array's)."""
    return torch.from_numpy(a).to(dev, copy=True)


def _download(t: torch.Tensor) -> np.ndarray:
    """A device table as a host array of its own."""
    return t.to("cpu", copy=True).numpy()


def _scattered(t: torch.Tensor, rows: torch.Tensor,
               block: np.ndarray) -> torch.Tensor:
    """A clone of `t` with `block` written into its `rows`: one device
    copy and one row scatter, `t` left as it was."""
    out = t.clone()
    out.index_copy_(0, rows, torch.from_numpy(block).to(t.device))
    return out


def _pick_cols(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """row [n, C], col [n, k] → row[i, col[i, j]] [n, k]. A plain
    gather: the reference's f32 masked lane-sum is exact only while
    table ids fit 24 bits, and a gather has no such bound."""
    return torch.gather(row, 1, col.long())


def _alias_pick(alias_rows: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor):
    """alias_rows [n, C] packed words, u1/u2 [n, k] uniforms → (col
    [n, k] int64, deg [n]): col0 = floor(u1·deg) over the row's active
    columns (deg = its non-sentinel words), kept with P = prob/65535,
    else its packed alias column. Dead rows (all sentinel) give deg 0
    and col 0; callers resolve them to the pad row. Counterpart of
    euler_tpu/parallel/device_sampler.py:_alias_pick."""
    C = alias_rows.shape[1]
    deg = (alias_rows >= 0).sum(-1).to(torch.int32)            # [n]
    col0 = torch.minimum(
        (u1 * deg[:, None].to(torch.float32)).to(torch.int32),
        (deg[:, None] - 1).clamp_min(0))                       # [n, k]
    word = torch.gather(alias_rows, 1, col0.long())            # [n, k]
    prob = torch.bitwise_and(word, _ALIAS_PROB_MAX)
    ali = torch.bitwise_right_shift(word, 16)      # arithmetic: -1 → -1
    keep = u2 * float(_ALIAS_PROB_MAX) < prob.to(torch.float32)
    col = torch.where(keep, col0, ali)
    return col.clamp(0, C - 1).long(), deg


def draw_uniforms(shape, generator: Optional[torch.Generator],
                  uniforms: Optional[torch.Tensor], device) -> torch.Tensor:
    """A draw's uniforms: the given ones (a replay, checked against
    `shape`), else `shape` float32 uniforms from the generator."""
    if uniforms is None:
        if generator is None:
            raise ValueError("a draw needs uniforms or a generator")
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    if tuple(uniforms.shape) != tuple(shape):
        raise ValueError(f"uniforms must be {list(shape)}, got "
                         f"{list(uniforms.shape)}")
    return uniforms


def sample_hop(nbr_table: torch.Tensor, cum_table: torch.Tensor,
               rows: torch.Tensor, count: int,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None,
               uniform: bool = False,
               alias_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One neighbor draw per (row, slot): rows [n] → [n * count] int32.

    uniforms: [n, count] float32 in [0, 1) ([2, n, count] for the alias
    draw), e.g. replayed from another implementation; else drawn from
    `generator` on the rows' device.
    uniform=False: inverse-CDF over each row's C cumulative weights
    (zero-degree rows resolve to the pad slot). uniform=True
    (unit-weight tables, DeviceNeighborTable.uniform_rows): column =
    floor(u·degree) with degree counted from the row's pad slots — no
    cum-row gather. alias_table: the Vose alias draw (_alias_pick) over
    the table's packed words, a flat pick for count < 4 and a row pick
    for count >= 4, dead rows resolved to pad; it excludes
    uniform=True, as in the reference."""
    n = rows.shape[0]
    C = nbr_table.shape[1]
    idx = rows.long()
    if alias_table is not None:
        if uniform:
            raise ValueError(
                "sample_hop: uniform=True and alias_table are exclusive "
                "— resolve the precedence at the call site (the alias "
                "draw already covers unit-weight tables)")
        u = draw_uniforms((2, n, count), generator, uniforms, rows.device)
        col, deg = _alias_pick(alias_table[idx], u[0], u[1])
        pad = nbr_table.shape[0] - 1
        if count < 4:
            out = nbr_table.reshape(-1)[idx[:, None] * C + col]
        else:
            out = _pick_cols(nbr_table[idx], col)
        # dead rows (zero degree / zero total weight) resolve to pad
        return torch.where(deg[:, None] > 0, out,
                           torch.full_like(out, pad)).reshape(-1)
    uniforms = draw_uniforms((n, count), generator, uniforms, rows.device)
    nbr = nbr_table[idx]                                   # [n, C]
    if uniform:
        pad = nbr_table.shape[0] - 1
        deg = (nbr != pad).sum(-1).to(torch.float32)       # [n]
        col = torch.minimum(
            (uniforms * deg[:, None]).to(torch.int32),
            (deg[:, None].to(torch.int32) - 1).clamp_min(0))
    else:
        cum = cum_table[idx]                               # [n, C]
        u = uniforms * cum[:, -1:]                         # [n, k]
        col = (cum[:, None, :] <= u[:, :, None]).sum(-1)   # [n, k]
        col = col.clamp(0, C - 1)
    return _pick_cols(nbr, col).reshape(-1)


def sample_fanout_rows(nbr_table: torch.Tensor, cum_table: torch.Tensor,
                       roots: torch.Tensor, fanouts: Sequence[int],
                       generator: Optional[torch.Generator] = None,
                       uniforms: Optional[Sequence[torch.Tensor]] = None,
                       uniform: bool = False,
                       alias_table: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """Multi-hop fanout: [roots, hop1, hop2, ...], layer h holding
    roots.shape[0] * prod(fanouts[:h]) rows. uniforms: optional one
    tensor per hop ([n_h, k_h], or [2, n_h, k_h] with alias_table; a
    replay); else each hop draws from `generator` in hop order."""
    if uniforms is not None and len(uniforms) != len(fanouts):
        raise ValueError(f"need one uniforms tensor per hop "
                         f"({len(fanouts)}), got {len(uniforms)}")
    layers = [roots]
    cur = roots
    for h, k in enumerate(fanouts):
        cur = sample_hop(nbr_table, cum_table, cur, int(k),
                         generator=generator,
                         uniforms=None if uniforms is None else uniforms[h],
                         uniform=uniform, alias_table=alias_table)
        layers.append(cur)
    return layers


def sample_hop_fused(fused_table: torch.Tensor, rows: torch.Tensor,
                     count: int, generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sample_hop's inverse-CDF draw over a fused [N+1, 2C] table: one
    row gather gives the C neighbor ids and, bit-cast back to float32
    (exact), the C cumulative weights. uniforms [n, count] as
    sample_hop's; the picks equal the split tables' weighted picks for
    the same uniforms. Counterpart of
    euler_tpu/parallel/device_sampler.py:sample_hop_fused."""
    C = fused_table.shape[1] // 2
    n = rows.shape[0]
    u = draw_uniforms((n, count), generator, uniforms, rows.device)
    row = fused_table[rows.long()]                         # [n, 2C]
    nbr = row[:, :C]
    cum = row[:, C:].view(torch.float32)
    u = u * cum[:, -1:]
    col = (cum[:, None, :] <= u[:, :, None]).sum(-1).clamp(0, C - 1)
    return _pick_cols(nbr, col).reshape(-1)


def sample_fanout_rows_fused(fused_table: torch.Tensor, roots: torch.Tensor,
                             fanouts: Sequence[int],
                             generator: Optional[torch.Generator] = None,
                             uniforms: Optional[Sequence[torch.Tensor]] = None
                             ) -> List[torch.Tensor]:
    """sample_fanout_rows over a fused table (counterpart of the
    reference's sample_fanout_rows_fused)."""
    if uniforms is not None and len(uniforms) != len(fanouts):
        raise ValueError(f"need one uniforms tensor per hop "
                         f"({len(fanouts)}), got {len(uniforms)}")
    layers = [roots]
    cur = roots
    for h, k in enumerate(fanouts):
        cur = sample_hop_fused(fused_table, cur, int(k), generator=generator,
                               uniforms=None if uniforms is None
                               else uniforms[h])
        layers.append(cur)
    return layers


def slot_weights(cum_rows: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative-weight rows [n, C] → per-slot edge weights
    [n, C]: the inverse of the table's cumsum (counterpart of
    euler_tpu/parallel/device_sampler.py:slot_weights)."""
    return torch.diff(cum_rows, dim=1,
                      prepend=torch.zeros_like(cum_rows[:, :1]))
