"""Device resolution and import hygiene of the PyTorch port."""

import ast
from pathlib import Path

import pytest
import torch

from euler_tpu_torch.platform import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "euler_tpu")


def test_default_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(monkeypatch):
    import numpy as np

    from euler_tpu_torch.graph import GraphBuilder
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.serving import InferenceServer, ModelBundle
    from euler_tpu_torch.serving.engine import EmbeddingEngine

    b = GraphBuilder()
    b.set_feature(0, 0, 2, "feature")
    b.add_nodes(np.arange(3, dtype=np.uint64))
    b.add_edges(np.array([0, 1], np.uint64), np.array([1, 2], np.uint64))
    b.set_node_dense(np.arange(3, dtype=np.uint64), 0,
                     np.ones((3, 2), np.float32))
    graph = b.finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the engine-built tables, as a runner builds them
    for kw in ({}, {"fused": True}, {"alias": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceNeighborTable(graph, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeatureStore(graph, ["feature"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceNodeSampler(graph)
    with pytest.raises(RuntimeError):
        DeviceFeatureStore.from_arrays(np.zeros((3, 2), np.float32))
    for kw in ({}, {"fused": True}, {"alias": True}):
        with pytest.raises(RuntimeError):
            DeviceNeighborTable.from_csr(np.array([0, 1]), np.array([0]),
                                         **kw)
    bundle = ModelBundle({}, np.zeros((2, 2), np.float32),
                         np.arange(2, dtype=np.uint64))
    with pytest.raises(RuntimeError):
        EmbeddingEngine(bundle, None, (8,))
    # a server without a card raises before it binds a socket, instead
    # of serving from the host
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(bundle)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_euler_tpu():
    files = sorted((ROOT / "euler_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    scanned = {str(f.relative_to(ROOT)) for f in files}
    for copy in ("obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                 "obs/server.py", "estimator/prefetch.py",
                 "estimator/retry.py", "estimator/graphed_loop.py",
                 "tools/knn.py", "serving/wire.py", "serving/batcher.py",
                 "serving/export.py", "serving/engine.py",
                 "serving/server.py", "serving/client.py",
                 "serving/autoscale.py", "serving/__init__.py",
                 "examples/run_geniepath.py",
                 "examples/run_scalable_sage.py", "core/lib.py",
                 "graph/api.py", "dataflow/base_dataflow.py",
                 "dataset/base_dataset.py", "ops/walk_ops.py"):
        assert f"euler_tpu_torch/{copy}" in scanned
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}
