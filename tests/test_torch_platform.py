"""Device resolution and import hygiene of the PyTorch port."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
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


@pytest.mark.parametrize("runner", [
    "run_fastgcn", "run_gcn", "run_gat", "run_appnp", "run_agnn",
    "run_arma", "run_sgcn", "run_tagcn", "run_adaptivegcn", "run_dna"])
def test_slice9_entry_points_raise_without_cuda(runner, monkeypatch):
    """Without a card the layerwise model's and a conv stack's
    estimators raise (device=None is CUDA), and so does each new runner
    without --device (also run_fastgcn --device_sampler) before it
    builds anything."""
    import importlib

    import numpy as np

    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.examples.common import ConvModel
    from euler_tpu_torch.graph import GraphBuilder
    from euler_tpu_torch.models.graphsage import DeviceSampledLayerwiseGCN

    b = GraphBuilder()
    b.add_nodes(np.arange(3, dtype=np.uint64))
    graph = b.finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in (DeviceSampledLayerwiseGCN(2, 4),
                  ConvModel(2, 4, "gcn")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NodeEstimator(model, {}, graph, None)
    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    extra = [["--device_sampler"]] if runner == "run_fastgcn" else []
    for argv in [[], *extra]:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


def test_slice10_entry_points_raise_without_cuda(monkeypatch):
    """Without a card the graph-classification and GAE estimators, and
    a BaseEstimator over DGI, raise (device=None is CUDA) before they
    build anything."""
    import numpy as np

    from euler_tpu_torch.dataset.graph_sets import mutag_like
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator
    from euler_tpu_torch.estimator.estimators import (
        GaeEstimator, GraphEstimator,
    )
    from euler_tpu_torch.models.dgi import DGI
    from euler_tpu_torch.mp_utils.base_gae import BaseGraphGAE
    from euler_tpu_torch.mp_utils.graph_gnn import GraphModel

    data = mutag_like(num_graphs=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphEstimator(GraphModel(7, "gated", "set2set", num_graphs=2),
                       {}, data.graphs, data.labels)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GaeEstimator(BaseGraphGAE(3, variational=True), {}, None,
                     lambda roots: {"n_real_nodes": np.int64(1)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BaseEstimator(DGI(3, dim=4), {})


@pytest.mark.parametrize("argv", [
    ["run_geniepath"], ["run_scalable_sage"], ["run_solution"],
    ["run_solution", "--mode", "unsupervise"], ["run_sample_solution"],
    ["run_transx"], ["run_transx", "--model", "TransR"], ["run_distmult"],
    ["run_rgcn"]])
def test_slice11_entry_points_raise_without_cuda(argv, monkeypatch,
                                                 tmp_path):
    """Without a card each slice-11 runner raises without --device
    (device=None is CUDA) before it builds anything (run_sample_solution
    writes no sample file), and so do SampleEstimator and a
    BaseEstimator over each new model."""
    import importlib

    from euler_tpu_torch.estimator.base_estimator import BaseEstimator
    from euler_tpu_torch.estimator.estimators import SampleEstimator
    from euler_tpu_torch.examples.run_rgcn import RGCNLinkModel
    from euler_tpu_torch.models.graphsage import ScalableGraphSage
    from euler_tpu_torch.models.kg_models import TransE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"euler_tpu_torch.examples.{argv[0]}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv[1:])
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SampleEstimator(TransE(4, 2, dim=3), {}, "samples.txt",
                        lambda lines: {})
    for model in (TransE(4, 2, dim=3), RGCNLinkModel(4, 2, 3, 2),
                  ScalableGraphSage(2, 3, max_id=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BaseEstimator(model, {})


def test_package_puts_idle_omp_workers_to_sleep(monkeypatch):
    """Imported before torch, the package sets OMP_WAIT_POLICY=PASSIVE
    for libgomp (torch's CPU thread pool), so idle workers sleep instead
    of spinning beside the caller (a fresh interpreter); a policy the
    caller set stays (the package's code run again with ACTIVE set)."""
    import importlib
    import os
    import subprocess
    import sys

    code = ("import os, euler_tpu_torch, torch; "
            "print(os.environ.get('OMP_WAIT_POLICY'))")
    env = {k: v for k, v in os.environ.items() if k != "OMP_WAIT_POLICY"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "PASSIVE"
    monkeypatch.setenv("OMP_WAIT_POLICY", "ACTIVE")
    importlib.reload(euler_tpu_torch)
    assert os.environ["OMP_WAIT_POLICY"] == "ACTIVE"


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
    # the gloo test jobs' ranks run the port alone too
    files.append(ROOT / "tests" / "torch_dist_worker.py")
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
                 "dataset/base_dataset.py", "ops/walk_ops.py",
                 "ops/mp_ops.py", "parallel/device_layerwise.py",
                 "mp_utils/base_gnn.py", "convolution/__init__.py",
                 "convolution/conv.py", "convolution/gcn_conv.py",
                 "convolution/sage_conv.py", "convolution/gat_conv.py",
                 "convolution/agnn_conv.py", "convolution/gin_conv.py",
                 "convolution/graph_conv.py", "convolution/sgcn_conv.py",
                 "convolution/tag_conv.py", "convolution/arma_conv.py",
                 "convolution/appnp_conv.py", "convolution/dna_conv.py",
                 "examples/run_fastgcn.py", "examples/run_gcn.py",
                 "examples/run_gat.py", "examples/run_appnp.py",
                 "examples/run_agnn.py", "examples/run_arma.py",
                 "examples/run_sgcn.py", "examples/run_tagcn.py",
                 "examples/run_adaptivegcn.py", "examples/run_dna.py",
                 "utils/metrics.py", "utils/to_dense.py",
                 "dataset/graph_sets.py", "convolution/gated_graph_conv.py",
                 "graph_pool/__init__.py", "graph_pool/base_pool.py",
                 "mp_utils/graph_gnn.py", "mp_utils/base_gae.py",
                 "models/dgi.py", "utils/encoders.py",
                 "estimator/estimators.py", "examples/graph_common.py",
                 "examples/run_gin.py", "examples/run_graphgcn.py",
                 "examples/run_gated_graph.py", "examples/run_set2set.py",
                 "examples/run_gae.py", "examples/run_dgi.py",
                 "examples/run_lgcn.py", "utils/layers.py",
                 "contrib/__init__.py", "contrib/spmm.py",
                 "models/graphsage.py", "solution/__init__.py",
                 "solution/base_solution.py",
                 "examples/run_solution.py",
                 "examples/run_sample_solution.py",
                 "dataset/__init__.py", "dataset/kg_sets.py",
                 "models/kg_models.py", "examples/run_transx.py",
                 "examples/run_distmult.py", "examples/run_rgcn.py",
                 "convolution/relation_conv.py", "dataflow/__init__.py",
                 "mp_utils/group_gnn.py", "convert.py", "__init__.py",
                 "dataset/ml_1m.py", "dataset/real_sets.py",
                 "tools/__init__.py", "tools/generate_data.py",
                 "utils/__init__.py", "estimator/__init__.py",
                 "estimator/streaming.py", "parallel/device_sampler.py",
                 "examples/run_deepwalk.py", "examples/run_line.py",
                 "gql.py", "ops/__init__.py", "ops/base.py",
                 "ops/sample_ops.py", "ops/neighbor_ops.py",
                 "ops/feature_ops.py", "ops/type_ops.py",
                 "graph/__init__.py", "graph/remote.py",
                 "graph/pipeline.py", "graph/chaos.py",
                 "graph/elastic.py", "tools/console.py",
                 "parallel/collectives.py", "parallel/mesh.py",
                 "parallel/multihost.py", "parallel/placement.py",
                 "parallel/ring_exchange.py",
                 "parallel/sharded_embedding.py",
                 "parallel/partitioned_store.py",
                 "parallel/memory_plan.py", "parallel/train.py",
                 "parallel/dryrun.py", "utils/hooks.py"):
        assert f"euler_tpu_torch/{copy}" in scanned
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}
