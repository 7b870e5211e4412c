"""Per-device memory arithmetic for the device table layouts (copy of
euler_tpu/parallel/memory_plan.py:24-163; tests/test_torch_partition.py
holds the two to the same numbers).

Given the layout rules the builders use (DeviceNeighborTable [N+1, C]
int32 + [N+1, C] float32, or the fused [N+1, 2C] int32;
DeviceFeatureStore [N+1, D] in bf16/int8 with a [D] float32 scale;
placement.put_row_sharded padding rows to a multiple of the 'model'
axis), compute how many bytes each device holds for a given mesh. This
is arithmetic, not a measurement. HBM_BYTES keeps the reference's chip
generations and adds the H100's 80 GiB ("h100").
"""

from __future__ import annotations

from typing import Dict, Optional


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def plan_tables(n_nodes: int, cap: int = 32, feat_dim: int = 100,
                label_dim: int = 16, mp: int = 1, fused: bool = False,
                quantize: Optional[str] = "int8",
                feat_dtype_bytes: int = 2,
                pad_dim_to: Optional[int] = None,
                shard_rows: bool = True,
                act_cache_dim: int = 0,
                act_cache_dtype_bytes: int = 2,
                act_cache_sharded: bool = False) -> Dict:
    """Per-chip bytes for one replica group's HBM-resident tables.

    mp — size of the 'model' mesh axis; with shard_rows the row-sharded
    tables hold ceil(rows/mp) rows per chip (put_row_sharded pads rows
    to a multiple of mp). shard_rows=False models the replicated
    placement (every chip holds full tables). The activation cache
    (DeviceSampledScalableSage) is replicated by default;
    act_cache_sharded models models/graphsage.shard_act_cache — the
    cache row-sharded over 'model' (GSPMD keeps it sharded through the
    train step; test_act_cache_row_sharded), dividing its bytes by mp
    like the tables.
    """
    rows = n_nodes + 1  # + the trailing pad row (builders' convention)

    def per_chip(r: int) -> int:
        if mp <= 1 or not shard_rows:
            return r
        return _ceil_div(r, mp)

    entries: Dict[str, int] = {}
    if fused:
        # fuse_tables packs cum f32 bits + nbr i32 into one [N+1, 2C]
        # i32 row: same bytes as split, half the gathers
        entries["nbrcum_table"] = per_chip(rows) * 2 * cap * 4
    else:
        entries["nbr_table"] = per_chip(rows) * cap * 4
        entries["cum_table"] = per_chip(rows) * cap * 4
    d = feat_dim if (pad_dim_to is None or pad_dim_to <= feat_dim) \
        else pad_dim_to
    fb = 1 if quantize == "int8" else feat_dtype_bytes
    entries["feature_table"] = per_chip(rows) * d * fb
    if quantize == "int8":
        entries["feature_scale"] = d * 4  # [D] f32, replicated
    if label_dim:
        entries["label_table"] = per_chip(rows) * label_dim * 4
    if act_cache_dim:
        # independent of shard_rows: shard_act_cache only needs a
        # non-trivial model axis, not sharded graph tables
        c_rows = _ceil_div(rows, mp) if (act_cache_sharded and mp > 1) \
            else rows
        entries["act_cache"] = c_rows * act_cache_dim * act_cache_dtype_bytes
    return {
        "per_chip_table_bytes": entries,
        "per_chip_total_bytes": sum(entries.values()),
        "rows": rows,
        "mp": mp,
        "fused": fused,
        "shard_rows": bool(shard_rows and mp > 1),
    }


# Per-device memory of the generations the plans are quoted against: the
# reference's chips, and the H100 (80 GiB) the port runs on.
HBM_BYTES = {"v4": 32 << 30, "v5e": 16 << 30, "v5p": 95 << 30,
             "h100": 80 << 30}


def plan_partitioned_table(n_nodes: int, feat_dim: int = 100,
                           k_shards: int = 4,
                           hub_cache_frac: float = 0.01,
                           quantize: Optional[str] = "int8",
                           feat_dtype_bytes: int = 2,
                           label_dim: int = 0,
                           device_rows: Optional[int] = None,
                           hbm_budget_bytes: Optional[int] = None,
                           chip: str = "v4") -> Dict:
    """Per-chip bytes for the PartitionedFeatureStore tier, by the same
    layout rules the builder uses (the reference's tests pin them
    against a real store):

      shard      ceil((device_rows + 1 pad sentinel) padded-to-K / K)
                 rows × D × elem bytes on each chip
      hub cache  round(hub_cache_frac · N) rows × D × elem bytes,
                 REPLICATED on every chip (the rows also stay in the
                 partition — the cache is a routing copy, not a move)
      scale      [D] f32 replicated when int8-quantized
      labels     optional [rows, label_dim] f32, sharded like the table
      host       rows past device_rows never upload (the
                 CachedGraphEngine overflow tier) — reported, not
                 counted against HBM

    Emits a verdict ("fits on <chip>-<4K> HBM at N nodes, K shards,
    f hub" or the factor it misses by) against hbm_budget_bytes
    (default: the chip generation's HBM)."""
    if k_shards < 1:
        raise ValueError(f"k_shards must be >= 1, got {k_shards}")
    if not 0.0 <= float(hub_cache_frac) < 1.0:
        raise ValueError(
            f"hub_cache_frac must be in [0, 1), got {hub_cache_frac}")
    dev = n_nodes if device_rows is None else min(int(device_rows),
                                                  n_nodes)
    hub = int(round(float(hub_cache_frac) * n_nodes))
    dev = max(dev, hub)          # the builder clamps the same way
    rows = dev + 1               # + trailing pad sentinel
    padded = _ceil_div(rows, k_shards) * k_shards
    fb = 1 if quantize == "int8" else feat_dtype_bytes
    entries: Dict[str, int] = {
        "feature_shard": _ceil_div(rows, k_shards) * feat_dim * fb,
        "hub_cache": hub * feat_dim * fb,
    }
    if quantize == "int8":
        entries["feature_scale"] = feat_dim * 4
    if label_dim:
        entries["label_shard"] = _ceil_div(rows, k_shards) * label_dim * 4
    total = sum(entries.values())
    budget = hbm_budget_bytes if hbm_budget_bytes is not None \
        else HBM_BYTES[chip]
    fits = total <= budget
    where = f"{chip}-{4 * k_shards}"
    verdict = (
        f"fits on {where} HBM at {n_nodes} nodes, {k_shards} shards, "
        f"{hub_cache_frac:g} hub ({total / 2**30:.2f} of "
        f"{budget / 2**30:.0f} GiB/chip)" if fits else
        f"EXCEEDS {where} HBM at {n_nodes} nodes, {k_shards} shards, "
        f"{hub_cache_frac:g} hub by {total / budget:.2f}x — raise K, "
        f"lower device_rows (host overflow), or quantize")
    return {
        "per_chip_table_bytes": entries,
        "per_chip_total_bytes": total,
        "rows": rows,
        "padded_rows": padded,
        "k_shards": k_shards,
        "hub_rows": hub,
        "host_rows": n_nodes - dev,
        "hbm_budget_bytes": budget,
        "fits": fits,
        "verdict": verdict,
    }
