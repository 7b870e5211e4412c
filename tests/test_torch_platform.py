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

    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.serving.engine import EmbeddingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DeviceFeatureStore.from_arrays(np.zeros((3, 2), np.float32))
    with pytest.raises(RuntimeError):
        DeviceNeighborTable.from_csr(np.array([0, 1]), np.array([0]))
    with pytest.raises(RuntimeError):
        EmbeddingEngine(np.arange(2, dtype=np.uint64), np.zeros((2, 2)))


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
                 "estimator/retry.py", "estimator/graphed_loop.py"):
        assert f"euler_tpu_torch/{copy}" in scanned
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}
