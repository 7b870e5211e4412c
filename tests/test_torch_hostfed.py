"""The host-fed paths of the port against the JAX package, on the CPU:
SupervisedGraphSage and UnsupervisedGraphSage (forward, loss and
gradients on one host batch, the reference's params converted in),
NodeEstimator in its three input paths (the engine's roots and batches
byte for byte under the same seed, then Adam steps with the reference's
losses), EdgeEstimator, DeepWalk and LINE with max_id bucketization, the
uint64 → int32 conversion, and the runners' host branches.

Both packages read byte-identical engines (tests/test_torch_engine.py),
so under one engine seed the batches are the same arrays. Tolerances
(float32 throughout): forward outputs, losses and gradients rtol 1e-5
(atol 1e-6); parameters after Adam steps atol 1e-3 of the learning
rate: Adam moves a parameter by about lr whatever its gradient's size,
so a gradient near Adam's eps (an embedding row whose scatter-summed
terms cancel, summed in another order by torch's backward than by
XLA's) carries its last-bit difference into the step at lr's scale.
The reference's programs are jitted at XLA's lowest backend
optimization level (the same HLO, compiled faster)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FanoutDataFlow as JFanoutDataFlow
from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth
from euler_tpu.estimator import EdgeEstimator as JEdgeEstimator
from euler_tpu.estimator import NodeEstimator as JNodeEstimator
from euler_tpu.estimator.base_estimator import TrainState as JTrainState
from euler_tpu.estimator.base_estimator import _merged, _to_device_tree
from euler_tpu.graph import seed as j_seed
from euler_tpu.models import LINE as JLINE
from euler_tpu.models import DeepWalk as JDeepWalk
from euler_tpu.models import DeviceSampledGraphSage as JDeviceSampledGraphSage
from euler_tpu.models import SupervisedGraphSage as JSupervisedGraphSage
from euler_tpu.models import UnsupervisedGraphSage as JUnsupervisedGraphSage
from euler_tpu.ops.walk_ops import gen_pair as j_gen_pair
from euler_tpu.parallel import DeviceFeatureStore as JDeviceFeatureStore
from euler_tpu.parallel import DeviceNeighborTable as JDeviceNeighborTable
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import _to_device
from euler_tpu_torch.estimator.estimators import EdgeEstimator, NodeEstimator
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.models.embedding_models import LINE, DeepWalk, Node2Vec
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, SupervisedGraphSage, UnsupervisedGraphSage,
)
from euler_tpu_torch.ops.base import initialize_graph
from euler_tpu_torch.ops.walk_ops import gen_pair, random_walk
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

_O0 = {"xla_backend_optimization_level": 0}
N, D, C, DIM, FANOUTS, B, LR = 300, 16, 4, 8, (3, 2), 16, 0.01
CPU = torch.device("cpu")
KW = dict(n=N, d=D, num_classes=C, seed=3)


@pytest.fixture(scope="module")
def engines():
    """The citation stand-in in both engines (byte-identical graphs)."""
    return engine_from_arrays(synthetic_citation(**KW)).engine, \
        jsynth("t", **KW).engine


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_tree(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        _same(a, b)


def _jinit(jm, batch):
    return jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0), batch)


def _grads(model, batch):
    """(embedding, loss, metric, flax-keyed gradients) of one train-mode
    forward and backward."""
    model.zero_grad()
    out = model(batch)
    out.loss.backward()
    grads = state_dict_to_flax({k: p.grad for k, p in
                                model.named_parameters()})
    return out, grads


def _close_trees(got, want, rtol=1e-5, atol=1e-6):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g_, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w),
                                   rtol=rtol, atol=atol)


# -- the models on one host batch ---------------------------------------------

@pytest.mark.parametrize("geometry", ["layers", "rows"])
def test_supervised_graphsage_matches_the_reference(engines, geometry):
    """One FanoutDataFlow batch: "layers" (the engine's features) or
    "rows" into an int8 table with a float32 scale; forward, loss,
    metric and every gradient within rtol 1e-5."""
    pg, jg = engines
    p_seed(1)
    batch = FanoutDataFlow(pg, list(FANOUTS), feature_ids=["feature"])(
        pg.sample_node(B, 0))
    batch["labels"] = pg.get_dense_feature(batch["ids"][0], "label", C)
    if geometry == "rows":
        store = JDeviceFeatureStore(jg, ["feature"], quantize="int8")
        batch = {"rows": [np.asarray(store.lookup(i))
                          for i in batch["ids"]],
                 "labels": batch["labels"],
                 "feature_table": np.asarray(store.features),
                 "feature_scale": np.asarray(store.feature_scale)}
    else:
        batch = {"layers": batch["layers"], "labels": batch["labels"]}
    jm = JSupervisedGraphSage(num_classes=C, multilabel=False, dim=DIM,
                              fanouts=FANOUTS)
    jb = _to_device_tree(batch)
    params = _jinit(jm, jb)["params"]

    def loss_fn(p):
        out = jm.apply({"params": p}, jb)
        return out.loss, (out.embedding, out.metric)

    (jloss, (jemb, jmetric)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True), compiler_options=_O0)(params)
    m = SupervisedGraphSage(C, D, multilabel=False, dim=DIM, fanouts=FANOUTS)
    m.load_state_dict(flax_to_state_dict(params))
    out, grads = _grads(m, _to_device(batch, CPU))
    np.testing.assert_allclose(out.embedding.detach().numpy(),
                               np.asarray(jemb), rtol=1e-5, atol=1e-6)
    assert float(out.loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(out.metric) == pytest.approx(float(jmetric), rel=1e-5)
    _close_trees(grads, jgrads)


def _batches(est, seed_engine, seed, steps=3):
    """The estimator's first train batches, its engine seeded first."""
    seed_engine(seed)
    it = est.train_input_fn()
    return [next(it) for _ in range(steps)]


def test_unsupervised_graphsage_and_edge_estimator_match_the_reference(
        engines):
    """EdgeEstimator's batches byte-identical under one engine seed; the
    UnsupervisedGraphSage forward, loss, MRR and gradients on the first
    within rtol 1e-5; then 3 Adam steps of both estimators with the same
    losses (rtol 1e-5) and parameters (atol 1e-3 of lr)."""
    pg, jg = engines
    cfg = {"batch_size": B, "num_negs": 3, "max_id": N - 1,
           "learning_rate": LR, "checkpoint_steps": 0,
           "log_steps": 1 << 30}
    est = EdgeEstimator(
        UnsupervisedGraphSage(D, DIM, N - 1, fanouts=FANOUTS, num_negs=3),
        cfg, pg, dataflow=FanoutDataFlow(pg, list(FANOUTS),
                                         feature_ids=["feature"]),
        device="cpu")
    jm = JUnsupervisedGraphSage(dim=DIM, max_id=N - 1, fanouts=FANOUTS,
                                num_negs=3)
    jest = JEdgeEstimator(jm, cfg, jg, dataflow=JFanoutDataFlow(
        jg, list(FANOUTS), feature_ids=["feature"]))
    pb, jb = _batches(est, p_seed, 4), _batches(jest, j_seed, 4)
    for a, b in zip(pb, jb):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    first = _to_device_tree(jb[0], N - 1)
    params = _jinit(jm, first)["params"]

    def loss_fn(p):
        out = jm.apply({"params": p}, first)
        return out.loss, out.metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True), compiler_options=_O0)(params)
    est.model.load_state_dict(flax_to_state_dict(params))
    out, grads = _grads(est.model, _to_device(pb[0], CPU, N - 1))
    assert float(out.loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(out.metric) == pytest.approx(float(jmetric), rel=1e-5)
    _close_trees(grads, jgrads)
    _steps_match(est, pb, jest, jb, params)


def _steps_match(est, pb, jest, jb, params):
    """The port's estimator trained on its batches and the reference's
    one-step program (jitted at _O0) on its own, from the same params:
    the same losses and parameters after each step."""
    jest.state = JTrainState.create(
        apply_fn=jest.model.apply, params=params, tx=jest.tx, extra_vars={},
        skipped_steps=jnp.zeros((), jnp.int32))
    step_fn = jax.jit(jest._make_one_step(), compiler_options=_O0)
    est.model.load_state_dict(flax_to_state_dict(params))
    est.params_cfg["learning_rate"] = LR
    for i, (a, b) in enumerate(zip(pb, jb)):
        jest.state, jloss, _ = step_fn(jest.state, _merged(
            _to_device_tree(b, jest.max_id), jest.static_batch))
        res = est.train(iter([a]), max_steps=i + 1)
        assert res["loss"] == pytest.approx(float(jloss), rel=1e-5)
        _close_trees(state_dict_to_flax(est.model.state_dict()),
                     jest.state.params, rtol=0,
                     atol=1e-3 * float(jest.params_cfg["learning_rate"]))


# -- NodeEstimator's three input paths ----------------------------------------

def _node_pair(engines, path):
    """(port NodeEstimator, reference NodeEstimator) over the same graph
    through one input path: "arrays" (host features), "rows" (host
    draws into an int8 feature table) or "device" (the device
    sampler)."""
    pg, jg = engines
    params = {"batch_size": B, "learning_rate": LR, "checkpoint_steps": 0,
              "log_steps": 1 << 30}
    feats = path == "arrays"
    flow = FanoutDataFlow(pg, list(FANOUTS), feature_ids=["feature"],
                          with_features=feats)
    jflow = JFanoutDataFlow(jg, list(FANOUTS), feature_ids=["feature"],
                            with_features=feats)
    store = jstore = tab = jtab = None
    if path != "arrays":
        store = DeviceFeatureStore(pg, ["feature"], label_fid="label",
                                   label_dim=C, quantize="int8",
                                   device="cpu")
        jstore = JDeviceFeatureStore(jg, ["feature"], label_fid="label",
                                     label_dim=C, quantize="int8")
    if path == "device":
        tab = DeviceNeighborTable(pg, cap=8, device="cpu")
        jtab = JDeviceNeighborTable(jg, cap=8)
        model = DeviceSampledGraphSage(C, D, multilabel=False, dim=DIM,
                                       fanouts=FANOUTS)
        jm = JDeviceSampledGraphSage(num_classes=C, multilabel=False,
                                     dim=DIM, fanouts=FANOUTS)
    else:
        model = SupervisedGraphSage(C, D, multilabel=False, dim=DIM,
                                    fanouts=FANOUTS)
        jm = JSupervisedGraphSage(num_classes=C, multilabel=False, dim=DIM,
                                  fanouts=FANOUTS)
    est = NodeEstimator(model, params, pg, flow, label_dim=C,
                        feature_store=store, device_sampler=tab,
                        device="cpu")
    jest = JNodeEstimator(jm, params, jg, jflow, label_fid="label",
                          label_dim=C, feature_store=jstore,
                          device_sampler=jtab)
    return est, jest


def _replayed(seed):
    """The reference's fanout uniforms for sample_seed: fold_in(key(17),
    seed), split per hop."""
    key, n, out = jax.random.fold_in(jax.random.key(17), np.uint32(seed)), \
        B, []
    for k in FANOUTS:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n, k)))))
        n *= k
    return out


@pytest.mark.parametrize("path", ["arrays", "rows", "device"])
def test_node_estimator_input_paths_match_the_reference(engines, path):
    """Under one engine seed both estimators draw the same roots from
    sample_node and build byte-identical batches (eval sweeps too); then
    3 Adam steps give the reference's losses (rtol 1e-5) and parameters
    (atol 1e-3 of lr). On the device path the port replays the
    reference's fanout uniforms for each batch's sample seed."""
    est, jest = _node_pair(engines, path)
    pb, jb = _batches(est, p_seed, 8), _batches(jest, j_seed, 8)
    for a, b in zip(pb, jb):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "sample_seed":
                assert a[k] == b[k]
            else:
                _same_tree(a[k], b[k])
    sweep, jsweep = list(est.eval_sweep_input_fn()), \
        list(jest.eval_sweep_input_fn())
    assert len(sweep) == len(jsweep) == est.eval_sweep_steps()
    for a, b in zip(sweep, jsweep):
        _same(a["infer_ids"], b["infer_ids"])
        _same(a["metric_mask"], b["metric_mask"])
    if path == "device":
        for a in pb:
            a["sample_uniforms"] = _replayed(a["sample_seed"])
    first = _merged(_to_device_tree(jb[0]), jest.static_batch)
    params = _jinit(jest.model, first)["params"]
    _steps_match(est, pb, jest, jb, params)


# -- DeepWalk and LINE ---------------------------------------------------------

def _walk_batches(g, seed_engine, steps=3, num_negs=2):
    """run_deepwalk's host input under engine seed 6: roots, node2vec
    walks, skip-gram pairs, negatives per pair."""
    seed_engine(6)
    out = []
    for _ in range(steps):
        roots = g.sample_node(B, -1)
        walks = g.random_walk(roots, 3, p=0.5, q=2.0)
        flat = j_gen_pair(walks, 1, 1).reshape(-1, 2)
        negs = g.sample_node(flat.shape[0] * num_negs, -1).reshape(
            flat.shape[0], num_negs)
        out.append({"src": flat[:, 0], "pos": flat[:, 1], "negs": negs,
                    "infer_ids": flat[:, 0]})
    return out


@pytest.mark.parametrize("model", ["deepwalk", "line1", "line2"])
def test_deepwalk_and_line_with_max_id_match_the_reference(engines, model):
    """The engine's walk pairs (DeepWalk) or the same pairs as edges
    (LINE, orders 1 and 2) with max_id 99 < the 300 node ids: ids
    bucketize by % 100 in both; 3 Adam steps with the reference's losses
    and parameters. The walks and pairs are byte-identical under one
    engine seed, and the port's random_walk/gen_pair equal the
    engine's."""
    pg, jg = engines
    pb, jb = _walk_batches(pg, p_seed), _walk_batches(jg, j_seed)
    for a, b in zip(pb, jb):
        for k in a:
            _same(a[k], b[k])
    p_seed(2)
    initialize_graph(pg)
    w = random_walk(pg.sample_node(B, -1), 3, p=0.5, q=2.0)
    _same(gen_pair(w, 1, 1), j_gen_pair(w, 1, 1))
    max_id = 99
    if model == "deepwalk":
        m, jm = DeepWalk(max_id, dim=DIM), JDeepWalk(max_id=max_id, dim=DIM)
        assert Node2Vec is DeepWalk
    else:
        order = int(model[-1])
        m, jm = LINE(max_id, dim=DIM, order=order), \
            JLINE(max_id=max_id, dim=DIM, order=order)
    from euler_tpu.estimator.base_estimator import BaseEstimator as JBase
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator

    cfg = {"learning_rate": 0.025, "max_id": max_id, "checkpoint_steps": 0,
           "log_steps": 1 << 30}
    est = BaseEstimator(m, cfg, device="cpu")
    jest = JBase(jm, cfg)
    params = _jinit(jm, _to_device_tree(jb[0], max_id))["params"]
    _steps_match(est, pb, jest, jb, params)


def test_uint64_ids_become_int32_rows_as_in_the_reference():
    """_to_device against _to_device_tree: ids % (max_id + 1) when
    max_id > 0; without it an id >= 2^31 wraps as numpy's cast wraps it
    in the reference (ROADMAP Queue C); infer_ids stay uint64 on the
    host."""
    ids = np.array([0, 5, (1 << 31) + 5, (1 << 40) + 7], np.uint64)
    for max_id in (0, 99):
        got = _to_device({"ids": [ids], "src": ids, "infer_ids": ids}, CPU,
                         max_id)
        want = _to_device_tree({"ids": [ids], "src": ids}, max_id)
        _same(got["src"].numpy(), want["src"])
        _same(got["ids"][0].numpy(), want["ids"][0])
        assert got["infer_ids"] is ids
    assert int(_to_device({"x": ids}, CPU)["x"][2]) == -(1 << 31) + 5


# -- the runners' host branches ----------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--mode", "unsupervised"]])
def test_graphsage_runner_host_branches_run_on_the_cpu(extra):
    """run_graphsage without --device_sampler on the cora stand-in
    (fanouts [3, 2], 10 steps): supervised through NodeEstimator's host
    arrays, unsupervised through EdgeEstimator; finite, nothing
    skipped."""
    from euler_tpu_torch.examples import run_graphsage

    res = run_graphsage.main(["--device", "cpu", "--fanouts", "3,2",
                              "--max_steps", "10", "--eval_steps", "2",
                              *extra])
    assert res["train_global_step"] == 10
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"])
    key = "eval_metric" if extra else "test_metric"
    assert 0.0 < res[key] <= 1.0
