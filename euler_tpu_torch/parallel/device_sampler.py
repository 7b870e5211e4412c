"""Device-resident neighbor sampling (counterpart of
euler_tpu/parallel/device_sampler.py), replicated split tables on one
device.

Two tables live on the device: neighbor rows [N+1, C] int32 (each node's
neighbors capped at C, front-packed, pad id N in empty slots) and their
inclusive cumulative weights [N+1, C] float32. Row N is an all-pad row.
A hop draws, per (row, slot), a column of the row's neighbor list:
inverse-CDF over the cumulative weights, or floor(u·degree) on
unit-weight tables (`uniform=True`, one row gather per hop).

Every draw is split into uniforms → pick. `sample_hop` takes the
uniforms as a tensor, or draws them from the caller's torch.Generator.
Given the same uniforms the picks are bit-exact with the JAX package's.
The generator's bits are not JAX's: a torch stream and a threefry key
give different uniforms from the same seed.

The table builders are copies of the reference's numpy code, so a table
built here is byte-identical to the reference's from the same CSR.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.platform import DeviceLike, resolve_device

_ROADMAP_LAYOUTS = ("not ported yet: ROADMAP.md Queue A, 'Alias and fused "
                    "sampler layouts'")
_ROADMAP_SHARDED = "not ported yet: ROADMAP.md Queue A, 'Multi-GPU'"

# Row-chunk size for table-scale host passes (reference: _CHUNK_ROWS).
_CHUNK_ROWS = 262_144


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


def _check_layout(fused: bool, alias: bool, shard_rows: bool) -> None:
    if fused or alias:
        raise NotImplementedError(
            f"fused/alias tables are {_ROADMAP_LAYOUTS}")
    if shard_rows:
        raise NotImplementedError(
            f"row-sharded tables are {_ROADMAP_SHARDED}")


def check_split_tables(batch) -> None:
    """A model's batch must carry the split nbr/cum tables: the fused
    and alias layouts raise."""
    if batch.get("nbrcum_table") is not None \
            or batch.get("alias_table") is not None:
        raise NotImplementedError(
            f"fused/alias tables are {_ROADMAP_LAYOUTS}")


class DeviceNeighborTable:
    """Neighbor rows + cumulative weights on one device.

    Attributes: neighbors [N+1, C] int32, cum_weights [N+1, C] float32,
    pad_row N, cap C, uniform_rows (every row unit-weight), and the
    truncation stats hub_frac / edge_keep_frac / max_degree."""

    def __init__(self):
        raise TypeError("use DeviceNeighborTable.from_csr or from_arrays")

    @classmethod
    def from_csr(cls, offsets: np.ndarray, neighbors: np.ndarray,
                 weights: Optional[np.ndarray] = None, cap: int = 32,
                 seed: int = 0, device: DeviceLike = None,
                 keep_host: bool = False) -> "DeviceNeighborTable":
        """Build from CSR adjacency: node i's neighbor rows are
        neighbors[offsets[i]:offsets[i+1]] (values in [0, N], N = pad),
        with edge weights (default 1). Same tables as the reference's
        DeviceNeighborTable(graph, cap, seed) over that adjacency.
        keep_host keeps the numpy tables as host_tables."""
        dev = resolve_device(device)
        offsets = np.asarray(offsets, np.int64)
        n = len(offsets) - 1
        deg = np.diff(offsets)
        nbr_rows = np.asarray(neighbors, np.int32)
        ws = np.ones(len(nbr_rows), np.float32) if weights is None \
            else np.asarray(weights, np.float32)
        C = int(cap)
        nbr_tab = np.full((n + 1, C), n, dtype=np.int32)
        w_tab = np.zeros((n + 1, C), dtype=np.float32)
        _fill_table_rows(C, n, np.arange(n, dtype=np.int64), deg,
                         nbr_rows, ws, seed,
                         out_nbr=nbr_tab[:n], out_w=w_tab[:n])
        stats = {
            "hub_frac": float((deg > C).mean()) if n else 0.0,
            "edge_keep_frac": float(np.minimum(deg, C).sum()
                                    / max(len(nbr_rows), 1)),
            "max_degree": int(deg.max()) if n else 0,
            "uniform_rows": _detect_uniform_rows(nbr_tab, w_tab),
        }
        cum = np.cumsum(w_tab, axis=1, dtype=np.float32)
        del w_tab
        self = cls._place(nbr_tab, cum, stats, dev)
        if keep_host:
            self.host_tables = (nbr_tab, cum)
        return self

    @classmethod
    def from_arrays(cls, nbr_tab: np.ndarray, cum_tab: np.ndarray,
                    stats: Optional[dict] = None,
                    device: DeviceLike = None, fused: bool = False,
                    alias: bool = False,
                    shard_rows: bool = False) -> "DeviceNeighborTable":
        """Upload prebuilt [N+1, C] tables. uniform_rows comes from
        stats or is recomputed chunk-wise from the tables."""
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
        return cls._place(np.ascontiguousarray(nbr_tab, np.int32),
                          np.ascontiguousarray(cum_tab, np.float32),
                          stats, resolve_device(device))

    @classmethod
    def _place(cls, nbr_tab: np.ndarray, cum_tab: np.ndarray, stats: dict,
               dev: torch.device) -> "DeviceNeighborTable":
        self = cls.__new__(cls)
        self.device = dev
        self.cap = int(nbr_tab.shape[1])
        self.pad_row = int(nbr_tab.shape[0]) - 1
        for k in ("hub_frac", "edge_keep_frac", "max_degree"):
            setattr(self, k, stats.get(k))
        self.uniform_rows = bool(stats["uniform_rows"])
        self.neighbors = torch.from_numpy(nbr_tab).to(dev)
        self.cum_weights = torch.from_numpy(cum_tab).to(dev)
        self.host_tables = None
        return self

    @property
    def tables(self):
        """Tensors to merge into a model's static batch."""
        return {"nbr_table": self.neighbors, "cum_table": self.cum_weights}


def _pick_cols(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """row [n, C], col [n, k] → row[i, col[i, j]] [n, k]. A plain
    gather: the reference's f32 masked lane-sum is exact only while
    table ids fit 24 bits, and a gather has no such bound."""
    return torch.gather(row, 1, col.long())


def sample_hop(nbr_table: torch.Tensor, cum_table: torch.Tensor,
               rows: torch.Tensor, count: int,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None,
               uniform: bool = False) -> torch.Tensor:
    """One neighbor draw per (row, slot): rows [n] → [n * count] int32.

    uniforms: [n, count] float32 in [0, 1), e.g. replayed from another
    implementation; else drawn from `generator` on the rows' device.
    uniform=False: inverse-CDF over each row's C cumulative weights
    (zero-degree rows resolve to the pad slot). uniform=True
    (unit-weight tables, DeviceNeighborTable.uniform_rows): column =
    floor(u·degree) with degree counted from the row's pad slots — no
    cum-row gather."""
    n = rows.shape[0]
    C = nbr_table.shape[1]
    if uniforms is None:
        if generator is None:
            raise ValueError("sample_hop needs uniforms or a generator")
        uniforms = torch.rand((n, count), generator=generator,
                              device=rows.device, dtype=torch.float32)
    elif tuple(uniforms.shape) != (n, count):
        raise ValueError(f"uniforms must be [{n}, {count}], got "
                         f"{tuple(uniforms.shape)}")
    idx = rows.long()
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
                       uniform: bool = False) -> List[torch.Tensor]:
    """Multi-hop fanout: [roots, hop1, hop2, ...], layer h holding
    roots.shape[0] * prod(fanouts[:h]) rows. uniforms: optional one
    [n_h, k_h] tensor per hop (replay); else each hop draws from
    `generator` in hop order."""
    if uniforms is not None and len(uniforms) != len(fanouts):
        raise ValueError(f"need one uniforms tensor per hop "
                         f"({len(fanouts)}), got {len(uniforms)}")
    layers = [roots]
    cur = roots
    for h, k in enumerate(fanouts):
        cur = sample_hop(nbr_table, cum_table, cur, int(k),
                         generator=generator,
                         uniforms=None if uniforms is None else uniforms[h],
                         uniform=uniform)
        layers.append(cur)
    return layers


def slot_weights(cum_rows: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative-weight rows [n, C] → per-slot edge weights
    [n, C]: the inverse of the table's cumsum (counterpart of
    euler_tpu/parallel/device_sampler.py:slot_weights)."""
    return torch.diff(cum_rows, dim=1,
                      prepend=torch.zeros_like(cum_rows[:, :1]))
