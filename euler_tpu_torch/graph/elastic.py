"""Elastic graph fleet: epoch-versioned ownership maps, live shard
splits, and hot-partition rebalancing (copy of euler_tpu/graph/elastic.py).

The pre-elastic fleet fixes its shard count at start time and routes by
the implicit hash convention ``(id % P) % shard_num``; with the measured
hub_frac ≈ 0.996 degree skew that load is *predictably* unbalanced. This
module makes the topology a published, versioned datum instead:

  * **OwnershipMap** — partition → owner shard(s), ``map_epoch``-
    versioned. The Python class mirrors the native ``OwnershipMap``
    (graph.h) byte-for-byte through the shared spec string
    (``e<E>-P<pn>-0.1.2.2+3``), published in the discovery registry as
    an ``omap_<service>__<spec>`` entry — the same names-carry-the-data
    convention the serving entries use, invisible to the C shard
    scanner.
  * **Live split** — a new shard bootstraps from a peer's compacted
    snapshot + WAL (``clone_wal_dir``) and closes the tail gap through
    the anti-entropy path (``kGetDeltaLog`` catch-up) before
    registering; the map then flips by epoch bump while reads keep
    serving. Flip ORDER is load-bearing (``flip_fleet``): registry
    first, surviving shards second — a stale client refused by a
    flipped shard finds the fresh map already published, so its retry
    lands correctly routed; a fresh client reaching a not-yet-flipped
    shard is safe because flips only shrink a surviving shard's owned
    set (the one-sided staleness check in rpc.cc documents this).
  * **Hot-partition rebalancing** — ``hottest_shard`` reads the
    per-shard request counters off the client (mirrored on the obs
    registry), ``add_replica`` lists an additional owner for the hot
    partition (the new owner must hold the rows: a split sibling that
    retained them, or a shard bootstrapped over them), and clients
    spread reads over the owner list (p2c in ID_SPLIT) with the
    hedging raceable across the replicas (``configure_rpc(
    hedge_replicas=True)``).

Nothing here starts processes: the test/bench owns its process
topology and composes these building blocks (see
``tools/bench_host.py --mode elastic`` and ``tests/test_elastic.py``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional, Sequence

__all__ = [
    "OwnershipMap", "publish_map", "fetch_map", "remove_map_entries",
    "flip_fleet", "clone_wal_dir", "hottest_shard", "map_entry_name",
]

_OMAP_PREFIX = "omap_"


@dataclasses.dataclass
class OwnershipMap:
    """Python mirror of the native OwnershipMap (euler_tpu/core/cc/
    graph.h): partition p is owned by ``owners[p]`` (primary first;
    extra owners are replicas holding the same rows). ``map_epoch`` 0
    is invalid here — the native side treats 0 as "no map"."""

    map_epoch: int
    partition_num: int
    owners: List[List[int]]

    @property
    def shard_num(self) -> int:
        """Fleet width: 1 + the highest shard index listed."""
        return 1 + max(max(os_) for os_ in self.owners)

    @classmethod
    def default(cls, partition_num: int, shard_num: int,
                epoch: int = 1) -> "OwnershipMap":
        """The hash convention as an explicit map: p → {p % shard_num}
        (partition_num raised to shard_num when smaller, matching
        ShardOf's placement modulus)."""
        p = max(int(partition_num), int(shard_num), 1)
        return cls(map_epoch=int(epoch), partition_num=p,
                   owners=[[q % int(shard_num)] for q in range(p)])

    def encode(self) -> str:
        body = ".".join("+".join(str(s) for s in os_)
                        for os_ in self.owners)
        return f"e{self.map_epoch}-P{self.partition_num}-{body}"

    @classmethod
    def decode(cls, spec: str) -> "OwnershipMap":
        try:
            head, pn, body = spec.split("-", 2)
            if not head.startswith("e") or not pn.startswith("P"):
                raise ValueError(spec)
            owners = [[int(s) for s in part.split("+")]
                      for part in body.split(".")]
            m = cls(map_epoch=int(head[1:]), partition_num=int(pn[1:]),
                    owners=owners)
        except (ValueError, IndexError) as e:
            raise ValueError(f"bad ownership spec {spec!r}") from e
        if m.map_epoch <= 0 or len(owners) != m.partition_num or not all(
                os_ for os_ in owners):
            raise ValueError(f"bad ownership spec {spec!r}")
        return m

    # -- topology algebra (every derived map bumps the epoch) --------------
    def split(self, new_shard_num: int) -> "OwnershipMap":
        """Re-spread single-owner partitions over a GROWN fleet by the
        hash convention at the new width: p → {p % new_shard_num}.
        Replicated partitions keep their extra owners only if those
        owners still hash-own them (a split is a clean re-spread; add
        replicas back afterwards via add_replica)."""
        n = int(new_shard_num)
        if n < self.shard_num:
            raise ValueError(
                f"split cannot shrink the fleet ({self.shard_num} -> {n})")
        return OwnershipMap(
            map_epoch=self.map_epoch + 1,
            partition_num=self.partition_num,
            owners=[[p % n] for p in range(self.partition_num)])

    def add_replica(self, partition: int, owner: int) -> "OwnershipMap":
        """List `owner` as an ADDITIONAL owner of `partition` (the
        rebalancing move). The caller is responsible for `owner`
        actually holding the partition's rows (split sibling that
        retained them, or a shard bootstrapped over them) — flip only
        after its catch-up reached the fleet epoch."""
        owners = [list(os_) for os_ in self.owners]
        if owner not in owners[partition]:
            owners[partition].append(owner)
        return OwnershipMap(map_epoch=self.map_epoch + 1,
                            partition_num=self.partition_num,
                            owners=owners)

    def owner_of(self, node_id: int) -> List[int]:
        return self.owners[int(node_id) % self.partition_num]


def map_entry_name(m: OwnershipMap, service: str = "graph") -> str:
    if "__" in service:
        raise ValueError(f"service name must not contain '__': {service!r}")
    return f"{_OMAP_PREFIX}{service}__{m.encode()}"


def publish_map(registry: str, m: OwnershipMap,
                service: str = "graph") -> str:
    """Publish `m` in the discovery registry (entry-name-carries-data,
    the serving convention) and drop superseded omap entries.
    Returns the entry name. Publish BEFORE flipping any server: a
    stale client's refusal must find the fresh map here."""
    from euler_tpu_torch.serving import wire

    name = map_entry_name(m, service)
    wire.registry_put(registry, name)
    prefix = f"{_OMAP_PREFIX}{service}__"
    for other in list(wire.registry_list(registry)):
        if other.startswith(prefix) and other != name:
            try:
                old = OwnershipMap.decode(other[len(prefix):])
            except ValueError:
                continue
            if old.map_epoch < m.map_epoch:
                wire.registry_remove(registry, other)
    return name


def fetch_map(registry: str,
              service: str = "graph") -> Optional[OwnershipMap]:
    """Highest-epoch published map, or None when the fleet has none
    (pre-elastic deployments: clients keep the hash convention)."""
    from euler_tpu_torch.serving import wire

    prefix = f"{_OMAP_PREFIX}{service}__"
    best: Optional[OwnershipMap] = None
    for name in wire.registry_list(registry):
        if not name.startswith(prefix):
            continue
        try:
            m = OwnershipMap.decode(name[len(prefix):])
        except ValueError:
            continue
        if best is None or m.map_epoch > best.map_epoch:
            best = m
    return best


def remove_map_entries(registry: str, service: str = "graph") -> None:
    """Drop every published map entry (test teardown)."""
    from euler_tpu_torch.serving import wire

    prefix = f"{_OMAP_PREFIX}{service}__"
    for name in list(wire.registry_list(registry)):
        if name.startswith(prefix):
            wire.registry_remove(registry, name)


def flip_fleet(registry: str, m: OwnershipMap, push_fns: Sequence,
               grow_push_fns: Sequence = (),
               service: str = "graph") -> List[int]:
    """The atomic-by-epoch topology flip, in the load-bearing order:

      1. flip every shard whose owned set GROWS under `m`
         (`grow_push_fns`: a replica-gaining sibling, a bootstrapped
         split shard not already flipped) — the one-sided stale-map
         check only makes newer-client-vs-older-shard safe when flips
         SHRINK the shard's owned set; a grown owner still filtering
         deltas under the old map while new-map clients read from it
         would silently miss that partition's mutations;
      2. publish `m` to the registry (stale clients refreshing after a
         refusal must find it);
      3. flip the remaining (shrinking/unchanged) shards via
         `push_fns` — in-process handles pass ``svc.set_ownership``,
         subprocess shards ``lambda spec: gql.push_ownership(host,
         port, spec)``.

    New shards should be started/bootstrapped BEFORE calling this.
    Returns the per-shard installed epochs, grow pushes first."""
    spec = m.encode()
    out = []
    for push in grow_push_fns:
        out.append(push(spec))
    publish_map(registry, m, service)
    for push in push_fns:
        out.append(push(spec))
    return out


def clone_wal_dir(src_wal_dir: str, dst_wal_dir: str) -> None:
    """Bootstrap a split shard's durable state from a peer: copy the
    peer's compacted snapshot + log generations + CURRENT/EPOCH into a
    fresh wal_dir. The new shard's RecoverShard then loads the
    snapshot and replays the log FILTERED BY ITS OWN identity (LoadShard
    and ApplyGraphDelta re-filter by shard_idx/shard_num), so a clone
    started as shard 2-of-4 keeps exactly the partitions it will own —
    the anti-entropy path pointed at a split instead of a
    restart (kGetDeltaLog catch-up closes the tail the copy missed).

    The peer's OWNERSHIP spec is deliberately NOT copied: it describes
    the OLD topology, under which the new shard owns nothing — replay
    must fall back to the hash convention at the new fleet width until
    the driver pushes the post-split map."""
    if os.path.exists(dst_wal_dir) and os.listdir(dst_wal_dir):
        raise ValueError(f"clone target {dst_wal_dir!r} is not empty")
    os.makedirs(dst_wal_dir, exist_ok=True)
    for name in sorted(os.listdir(src_wal_dir)):
        if name == "OWNERSHIP" or name.endswith(".tmp"):
            continue
        src = os.path.join(src_wal_dir, name)
        dst = os.path.join(dst_wal_dir, name)
        if os.path.isdir(src):
            shutil.copytree(src, dst)
        else:
            shutil.copy2(src, dst)


def hottest_shard(counts: Dict[int, int]) -> tuple:
    """(shard, share) with the largest share — the rebalance trigger.
    Feed it ROUTED-ROW counts (``RemoteGraphEngine.shard_traffic()[1]``
    / the obs ``graph_shard_rows_total`` gauges): rows carry the skew;
    request counts are near-uniform because the distribute rewrite
    fires one REMOTE per shard per query."""
    total = sum(counts.values())
    if total <= 0:
        return -1, 0.0
    shard = max(counts, key=lambda s: counts[s])
    return shard, counts[shard] / total
