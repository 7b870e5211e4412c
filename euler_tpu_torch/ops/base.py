"""Global-graph initialization (copy of euler_tpu/ops/base.py) — parity
with the reference's
tf_euler.initialize_graph / initialize_embedded_graph / initialize_shared_graph
(tf_euler/python/euler_ops/base.py:37,63,70).

A process-global GraphEngine backs the functional ops in this package
(sample_ops, neighbor_ops, feature_ops, walk_ops). Models/dataflows may
also carry an explicit engine; the global is a convenience for scripts and
API parity.
"""

from __future__ import annotations

from typing import Optional

from euler_tpu_torch.graph import GraphEngine

_GRAPH: Optional[GraphEngine] = None


def initialize_graph(config) -> GraphEngine:
    """Initialize the process-global graph.

    config: either a GraphEngine (adopted as-is), a directory path
    (embedded load), or a dict with keys {directory, shard_idx, shard_num,
    data_type} mirroring the reference's "k=v;..." config string.
    """
    global _GRAPH
    if isinstance(config, GraphEngine) or hasattr(config, "sample_fanout"):
        # embedded engine OR a RemoteGraphEngine / compatible client —
        # the reference's initialize_graph covers both modes too
        # (tf_euler/python/euler_ops/base.py:37 local vs remote config)
        _GRAPH = config
    elif isinstance(config, str):
        _GRAPH = GraphEngine.load(config)
    elif isinstance(config, dict):
        _GRAPH = GraphEngine.load(
            config["directory"],
            shard_idx=int(config.get("shard_idx", 0)),
            shard_num=int(config.get("shard_num", 1)),
            data_type=int(config.get("data_type", 0)),
        )
    else:
        raise TypeError(f"unsupported graph config: {type(config)}")
    return _GRAPH


def initialize_embedded_graph(directory: str, **kw) -> GraphEngine:
    return initialize_graph({"directory": directory, **kw})


def initialize_shared_graph(graph: GraphEngine) -> GraphEngine:
    return initialize_graph(graph)


def get_graph() -> GraphEngine:
    if _GRAPH is None:
        raise RuntimeError(
            "graph not initialized; call "
            "euler_tpu_torch.ops.initialize_graph first"
        )
    return _GRAPH


_QUERY_CACHE: dict = {}
_INDEX_SPEC: str = ""


def set_index_spec(spec: str) -> None:
    """Declare the attribute indexes conditioned ops may use, e.g.
    "price:range_index;category:hash_index" (the reference builds these
    at data-prep time; conditions require a matching index there too).
    Rebuilds the cached query on next use."""
    global _INDEX_SPEC
    _INDEX_SPEC = spec
    _QUERY_CACHE.clear()


def get_query():
    """A Query bound to the global graph — backs the ops' `condition`
    parameters (the reference kernels append `.has(condition)` to their
    gremlin the same way, e.g. sample_neighbor_op.cc:40). Embedded
    engines get a cached Query.local built with set_index_spec's
    indexes (compile cache persists across calls); cluster engines
    reuse their own proxy (their shards' index spec is fixed at
    start_service time)."""
    g = get_graph()
    q = getattr(g, "query", None)
    if q is not None:  # RemoteGraphEngine carries its proxy
        return q
    key = (id(g), _INDEX_SPEC)
    cached = _QUERY_CACHE.get(key)
    if cached is None or cached[0]() is None:
        import weakref

        from euler_tpu_torch.gql import Query

        cached = (weakref.ref(g), Query.local(g, index_spec=_INDEX_SPEC))
        _QUERY_CACHE.clear()  # one live entry: the current global graph
        _QUERY_CACHE[key] = cached
    return cached[1]
