"""The port's serving modules (euler_tpu_torch/serving, tools/knn.py,
estimator/retry.py's engine rule) against the JAX package's originals
(euler_tpu/serving, euler_tpu/tools/knn.py), on the CPU: the engine's
applies, the copies pinned byte for byte, bundle files interchangeable
in both directions, and export_bundle/infer against the reference
estimator's on the cora stand-in."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import json
import os
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.models.graphsage import \
    DeviceSampledGraphSage as JaxDeviceSampledGraphSage
from euler_tpu.parallel.feature_store import \
    DeviceFeatureStore as JaxDeviceFeatureStore
from euler_tpu.serving import batcher as ref_batcher
from euler_tpu.serving import export as ref_export
from euler_tpu.serving import wire as ref_wire
from euler_tpu.serving.server import _BundleEngine
from euler_tpu.tools import knn as ref_knn
from euler_tpu_torch.convert import flax_to_state_dict
from euler_tpu_torch.dataset import dataset_arrays, engine_from_arrays
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.serving import batcher, export, wire
from euler_tpu_torch.serving.engine import EmbeddingEngine
from euler_tpu_torch.tools import knn

pytestmark = pytest.mark.serving


def _engines(n=50, d=12):
    rng = np.random.default_rng(0)
    ids = np.sort(rng.choice(10_000, n, replace=False)).astype(np.uint64)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    bundle = types.SimpleNamespace(ids=ids, embeddings=emb, shard=0,
                                   num_shards=1, version="v1",
                                   index_state=None)
    return ids, emb, _BundleEngine(bundle), _engine(ids, emb)


def _engine(ids, emb, ladder=(1024,)):
    """The port's engine over (ids, emb) on the CPU; one bucket wider
    than every request here, so each apply runs in one padded chunk."""
    return EmbeddingEngine(export.ModelBundle({}, emb, ids), "cpu", ladder)


def _queries(ids):
    rng = np.random.default_rng(1)
    q = rng.choice(ids, 20).astype(np.uint64)
    q[[3, 7]] = [np.uint64(10_001), np.uint64(2 ** 63 + 5)]  # unknown
    return q


def test_embed_matches_bundle_engine():
    """The engine's embed against the reference's gather apply and
    InferenceServer._run_embed's masking: exact."""
    ids, emb, ref, eng = _engines()
    q = _queries(ids)
    rows, valid, n_unknown = ref.lookup_rows(q)
    got_rows, got_valid, got_unknown = eng.lookup_rows(q)
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_valid, valid)
    assert got_unknown == n_unknown == 2
    want = np.array(ref.jit_gather(jnp.asarray(rows)), dtype=np.float32)
    want[~valid] = 0.0  # InferenceServer._run_embed
    got, unknown = eng.embed(q)
    assert unknown == 2
    np.testing.assert_array_equal(got, want)
    assert not got[[3, 7]].any()
    np.testing.assert_array_equal(got[valid], emb[rows[valid]])


def test_score_matches_bundle_engine():
    """score against the reference's jitted row dots: within 1e-6 (torch
    and XLA sum the 12 products in other orders)."""
    ids, emb, ref, eng = _engines()
    src = _queries(ids)
    dst = np.roll(src, 5)
    a, a_ok, _ = ref.lookup_rows(src)
    b, b_ok, _ = ref.lookup_rows(dst)
    want = np.array(ref.jit_score(jnp.asarray(a), jnp.asarray(b)),
                    dtype=np.float32)
    want[~(a_ok & b_ok)] = 0.0  # InferenceServer._run_score
    got, unknown = eng.score(src, dst)
    assert unknown == 4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ok = a_ok & b_ok
    np.testing.assert_allclose(got[ok], (emb[a[ok]] * emb[b[ok]]).sum(-1),
                               rtol=1e-6, atol=1e-6)
    assert not got[~ok].any()


def test_empty_and_bad_engines():
    """An empty bundle answers zeros of the reference's shape (dim 0, as
    ModelBundle.dim reads it); unsorted or misaligned ids and unequal
    score sides raise."""
    empty = _engine(np.zeros(0, np.uint64), np.zeros((0, 4)))
    ref = _BundleEngine(ref_export.ModelBundle({}, np.zeros((0, 4)),
                                               np.zeros(0, np.uint64)))
    got, unknown = empty.embed(np.array([1, 2], np.uint64))
    want = np.asarray(ref.jit_gather(jnp.zeros(2, jnp.int32)))
    assert got.shape == want.shape == (2, 0) and unknown == 2
    assert not empty.score(np.array([1], np.uint64),
                           np.array([2], np.uint64))[0].any()
    with pytest.raises(ValueError):
        _engine(np.array([3, 1], np.uint64), np.zeros((2, 4)))
    with pytest.raises(ValueError):
        _engine(np.array([1, 3], np.uint64), np.zeros((3, 4)))
    ids, emb, _, eng = _engines()
    with pytest.raises(ValueError):
        eng.score(ids[:3], ids[:2])


def test_engine_pads_to_the_ladder_and_records_shapes():
    """With the server's ladder every apply runs at a ladder size;
    answers equal those of an engine whose one bucket holds every
    request whole, exactly."""
    ids, emb, _, plain = _engines()
    eng = EmbeddingEngine(plain.bundle, "cpu", ladder=(8, 16))
    eng.warm()
    for n in (1, 5, 8, 9, 16, 17, 40):
        q = ids[:n]
        np.testing.assert_array_equal(eng.embed(q)[0], plain.embed(q)[0])
        np.testing.assert_array_equal(eng.score(q, q[::-1])[0],
                                      plain.score(q, q[::-1])[0])
    assert eng.padded_shapes == {"gather": {8, 16}, "score": {8, 16}}


# -- copies pinned to the originals ----------------------------------------

def _knn_data(case):
    rng = np.random.default_rng(4)
    if case == "ties":  # few distinct values: sims tie everywhere
        data = rng.integers(-1, 2, (120, 6)).astype(np.float32)
    else:
        data = rng.normal(size=(120, 6)).astype(np.float32)
    ids = (np.arange(120, dtype=np.uint64) * 7 + 3)
    q = np.concatenate([data[[0, 5, 77]], np.zeros((2, 6), np.float32),
                        -data[[9]]])
    return data, ids, q


@pytest.mark.parametrize("k", [1, 10, 120, 500])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_knn_copy_is_byte_identical(case, k):
    """brute_force (zero queries and k >= n included), the IVF index's
    training and search, and state_dict/from_state: the same bytes as
    euler_tpu/tools/knn.py."""
    data, ids, q = _knn_data(case)
    for a, b in zip(knn.brute_force(data, ids, q, k),
                    ref_knn.brute_force(data, ids, q, k)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got, want = knn.IVFFlatIndex(8, 3), ref_knn.IVFFlatIndex(8, 3)
    got.train_add(data, ids)
    want.train_add(data, ids)
    sg, sw = got.state_dict(), want.state_dict()
    assert sorted(sg) == sorted(sw)
    for key in sw:
        assert np.array_equal(sg[key], sw[key]) and \
            sg[key].dtype == sw[key].dtype
    for a, b in zip(got.search(q, k), want.search(q, k)):
        assert np.array_equal(a, b)
    back = knn.IVFFlatIndex.from_state(sw, data, ids)
    for a, b in zip(back.search(q, k), want.search(q, k)):
        assert np.array_equal(a, b)
    assert np.array_equal(knn._desc_keys(q @ data.T),
                          ref_knn._desc_keys(q @ data.T))


@pytest.mark.parametrize("max_batch", [1, 7, 8, 64, 100, 256])
def test_bucket_ladder_and_run_bucketed_match(max_batch):
    """The same ladder, and run_bucketed calls fn at the same padded
    chunks (edge-padded with the last row) and returns the same rows."""
    assert batcher.bucket_ladder(max_batch) == \
        ref_batcher.bucket_ladder(max_batch)
    assert batcher.bucket_ladder(max_batch, 2) == \
        ref_batcher.bucket_ladder(max_batch, 2)
    ladder = batcher.bucket_ladder(max_batch)
    rng = np.random.default_rng(max_batch)
    for n in (1, 3, max_batch, max_batch + 1, 3 * max_batch + 2):
        a = rng.integers(0, 100, n).astype(np.int32)
        b = rng.normal(size=(n, 2)).astype(np.float32)
        seen = [[], []]

        def fn(x, y, log):
            log.append((x.copy(), y.copy()))
            return y * x[:, None]

        got = batcher.run_bucketed(lambda x, y: fn(x, y, seen[0]), [a, b],
                                   ladder)
        want = ref_batcher.run_bucketed(lambda x, y: fn(x, y, seen[1]),
                                        [a, b], ladder)
        np.testing.assert_array_equal(got, want)
        assert len(seen[0]) == len(seen[1])
        for (x0, y0), (x1, y1) in zip(*seen):
            np.testing.assert_array_equal(x0, x1)
            np.testing.assert_array_equal(y0, y1)
            assert x0.shape[0] in ladder


class _Capture:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


@pytest.mark.parametrize("verb", ["MSG_EMBED", "MSG_KNN", "MSG_SCORE",
                                  "MSG_HEALTH", "MSG_INFO", "MSG_SWAP",
                                  "MSG_KNN_VEC"])
def test_wire_frames_are_byte_identical(verb):
    """Constants, frames, strings and the Reader: the same bytes and the
    same decoded values as euler_tpu/serving/wire.py, per verb."""
    assert wire.__all__ == ref_wire.__all__
    for name in ("MAGIC", "STATUS_OK", "STATUS_SHED", "STATUS_ERROR",
                 "_MAX_BODY", "_REG_PUT", "_REG_LIST", "_REG_REMOVE",
                 "_REG_LIST_VERSION", verb):
        assert getattr(wire, name) == getattr(ref_wire, name)
    assert wire.HEADER.format == ref_wire.HEADER.format
    body = (wire.pack_str("bündle/v2") + np.arange(5, dtype=np.uint64)
            .tobytes() + np.float32([1.5, -2]).tobytes() + b"\x07")
    frames = []
    for mod in (wire, ref_wire):
        cap = _Capture()
        mod.write_frame(cap, getattr(mod, verb), body)
        frames.append(cap.data)
        a, b = socket.socketpair()
        try:
            mod.write_frame(a, getattr(mod, verb), body)
            assert mod.read_frame(b) == (getattr(mod, verb), body)
        finally:
            a.close()
            b.close()
        r = mod.Reader(body)
        assert r.str_() == "bündle/v2"
        assert r.array(np.uint64, 5).tolist() == list(range(5))
        assert r.f32() == 1.5 and r.f32() == -2.0 and r.u8() == 7
        assert r.remaining() == 0
        with pytest.raises(mod.WireError):
            r.u32()
    assert frames[0] == frames[1]


def test_entry_names_and_dir_registries_interoperate(tmp_path):
    """serve entry names (and their pre-fleet form) parse alike, and a
    dir: registry one package writes the other discovers."""
    for args in (("svc", 0, 0, "127.0.0.1", 9000),
                 ("rec_s", 3, 1, "10.0.0.2", 1)):
        name = wire.serve_entry_name(*args)
        assert name == ref_wire.serve_entry_name(*args)
        assert wire.parse_serve_entry(name) == \
            ref_wire.parse_serve_entry(name) == args
    for name in ("serve_svc_2__h_5", "shard_0__h_1", "serve_x__h_y",
                 "serve__h_1", "serve_a_b_1__h_-3"):
        assert wire.parse_serve_entry(name) == \
            ref_wire.parse_serve_entry(name)
    with pytest.raises(ValueError):
        wire.serve_entry_name("a__b", 0, 0, "h", 1)
    spec = f"dir:{tmp_path / 'reg'}"
    wire.registry_put(spec, wire.serve_entry_name("svc", 1, 0, "h", 2))
    ref_wire.registry_put(spec, ref_wire.serve_entry_name("svc", 0, 0,
                                                          "h", 1))
    wire.registry_put(spec, "shard_0__h_9")
    assert set(wire.registry_list(spec)) == set(ref_wire.registry_list(spec))
    want = {0: [("h", 1)], 1: [("h", 2)]}
    for mod in (wire, ref_wire):
        fleet = mod.discover_fleet(spec, "svc")
        assert {s: [(h, p) for h, p, _ in v] for s, v in fleet.items()} \
            == want
    ref_wire.registry_remove(spec, wire.serve_entry_name("svc", 1, 0,
                                                         "h", 2))
    assert list(wire.discover_fleet(spec, "svc")) == [0]


def test_retry_policy_copy_matches_the_reference():
    """RetryPolicy's backoff draws and RetryDeadlineExceeded's place
    under EngineError, as in euler_tpu/graph/remote.py."""
    import random

    from euler_tpu.graph import remote
    from euler_tpu_torch.estimator import retry

    for kw in ({}, {"base_backoff_s": 0.5, "max_backoff_s": 1.0}):
        a, b = retry.RetryPolicy(**kw), remote.RetryPolicy(**kw)
        assert a.__dict__ == b.__dict__
        ra, rb = random.Random(3), random.Random(3)
        assert [a.backoff_s(i, ra) for i in range(1, 8)] == \
            [b.backoff_s(i, rb) for i in range(1, 8)]
    assert issubclass(retry.RetryDeadlineExceeded, retry.EngineError)
    assert retry.retryable_error(retry.RetryDeadlineExceeded("timed out"))


# -- bundle files, both directions -----------------------------------------

def _bundle_fields(n=120, d=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64) * 5 + 2
    params = {"['out']['kernel']": rng.normal(size=(d, 3)).astype(
        np.float32), "['out']['bias']": np.zeros(3, np.float32)}
    idx = ref_knn.IVFFlatIndex(nlist=4, nprobe=2)
    idx.train_add(emb, ids)
    spec = {"model_class": "DeviceSampledGraphSage", "dim": 4,
            "table_mesh": None}
    meta = {"global_step": 7, "bundle_version": "v7"}
    return params, emb, ids, idx.state_dict(), spec, meta


def _same_bundle(a, b):
    assert a.version == b.version and a.count == b.count and \
        a.dim == b.dim and (a.shard, a.num_shards) == (b.shard, b.num_shards)
    assert a.model_spec == b.model_spec and a.meta == b.meta
    np.testing.assert_array_equal(a.embeddings, b.embeddings)
    np.testing.assert_array_equal(a.ids, b.ids)
    assert sorted(a.params) == sorted(b.params)
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    assert (a.index_state is None) == (b.index_state is None)
    for k in a.index_state or {}:
        np.testing.assert_array_equal(a.index_state[k], b.index_state[k])


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bundles_load_in_the_other_package(tmp_path, writer, layout):
    """A bundle one package writes loads, verified, in the other, whole
    and shard by shard; the manifests agree key for key (the npz files'
    zip timestamps aside, every file is the same bytes)."""
    pkgs = {"port": export, "reference": ref_export}
    w, r = pkgs[writer], pkgs["reference" if writer == "port" else "port"]
    fields = _bundle_fields()
    dirs = {}
    for name, mod in pkgs.items():
        b = mod.ModelBundle(*fields)
        out = str(tmp_path / name)
        dirs[name] = b.save(out) if layout == "single" else \
            b.save_sharded(out, 2, nlist=4, nprobe=2)
    src = dirs[writer]
    got = r.ModelBundle.load(src, verify=True)
    want = w.ModelBundle.load(src, verify=True)
    _same_bundle(got, want)
    assert r.bundle_shard_count(src) == w.bundle_shard_count(src) == \
        (1 if layout == "single" else 2)
    if layout == "sharded":
        for s in range(2):
            _same_bundle(r.ModelBundle.load_shard(src, s),
                         w.ModelBundle.load_shard(src, s))
        assert r.shard_bounds(120, 2) == w.shard_bounds(120, 2)
    manifests = [json.load(open(os.path.join(d, "manifest.json")))
                 for d in dirs.values()]
    for m in manifests:
        for name in list(m["files"]):
            if name.endswith(".npz"):
                m["files"].pop(name)
    assert manifests[0] == manifests[1]
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["reference"]))
    for name in names:
        if not name.endswith(".npz"):
            assert open(os.path.join(dirs["port"], name), "rb").read() == \
                open(os.path.join(dirs["reference"], name), "rb").read()


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_corrupt_bundles_raise_in_both_packages(tmp_path, layout):
    """A flipped byte in an embedding file: BundleCorruptionError from
    either package's load; a sharded bundle's other shard still
    loads."""
    b = export.ModelBundle(*_bundle_fields())
    d = str(tmp_path / "b")
    if layout == "single":
        b.save(d)
        victim = "embeddings.npy"
    else:
        b.save_sharded(d, 2, nlist=4)
        victim = "embeddings.1.npy"
    path = os.path.join(d, victim)
    raw = bytearray(open(path, "rb").read())
    raw[-5] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for mod in (export, ref_export):
        with pytest.raises(mod.BundleCorruptionError):
            mod.ModelBundle.load(d, verify=True)
        if layout == "sharded":
            mod.ModelBundle.load_shard(d, 0)
            with pytest.raises(mod.BundleCorruptionError):
                mod.ModelBundle.load_shard(d, 1)


# -- export_bundle and infer against the reference estimator ---------------

CORA_DIM, CORA_FANOUTS, CORA_B = 16, (3, 2), 512


def _cora():
    g = dataset_arrays("cora")
    feats = np.concatenate([g.features,
                            np.zeros((1, g.features.shape[1]), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, g.num_classes), np.float32)])
    return g, feats, labels


def _uniforms(seed, n):
    """The reference's draw for sample_seed: fold_in(key(17), seed),
    split per hop."""
    key, out = jax.random.fold_in(jax.random.key(17), np.uint32(seed)), []
    for k in CORA_FANOUTS:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n, k)))))
        n *= k
    return out


@pytest.fixture(scope="module")
def cora_pair(tmp_path_factory):
    """The port's NodeEstimator on the cora stand-in with the reference
    BaseEstimator's initial params converted in, and the reference's
    over the same tables; the port's sweep with the reference's draws
    replayed, and the same sweep for the reference. Built once."""
    tmp_path = tmp_path_factory.mktemp("cora")
    g, feats, labels = _cora()
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=32,
                                       device="cpu", keep_host=True)
    store = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                           device="cpu")
    jstore = JaxDeviceFeatureStore.from_arrays(feats, labels,
                                               quantize="int8")
    nbr_h, cum_h = tab.host_tables
    jstatic = {"nbr_table": jnp.asarray(nbr_h),
               "cum_table": jnp.asarray(cum_h),
               "feature_table": jstore.features,
               "feature_scale": jstore.feature_scale,
               "label_table": jstore.labels}
    jm = JaxDeviceSampledGraphSage(num_classes=g.num_classes,
                                   multilabel=False, dim=CORA_DIM,
                                   fanouts=CORA_FANOUTS)
    jest = JaxBaseEstimator(jm, {"checkpoint_steps": 0},
                            model_dir=str(tmp_path / "ref"))
    model = DeviceSampledGraphSage(g.num_classes, feats.shape[1],
                                   multilabel=False, dim=CORA_DIM,
                                   fanouts=CORA_FANOUTS)
    est = NodeEstimator(model, {"batch_size": CORA_B,
                                "checkpoint_steps": 0},
                        engine_from_arrays(g).engine, None,
                        feature_store=store, device_sampler=tab,
                        device="cpu", model_dir=str(tmp_path / "port"))
    sweep, jsweep = [], []
    for b in est.infer_input_fn():
        b["sample_uniforms"] = _uniforms(b["sample_seed"], CORA_B)
        sweep.append(b)
        jsweep.append({"rows": [jnp.asarray(b["rows"][0])],
                       "sample_seed": np.uint32(b["sample_seed"]),
                       "infer_ids": b["infer_ids"]})
    jest.static_batch = jstatic
    # the state jest._init_state makes, with the init jitted (run op by
    # op it takes seconds on cora's 1433 features) at XLA's lowest
    # backend optimization level (the same HLO, compiled faster)
    variables = dict(jax.jit(jm.init, compiler_options={
        "xla_backend_optimization_level": 0})(jax.random.key(0),
                                              {**jsweep[0], **jstatic}))
    jest.state = JaxTrainState.create(
        apply_fn=jm.apply, params=variables.pop("params"), tx=jest.tx,
        extra_vars=variables, skipped_steps=jnp.zeros((), jnp.int32))
    model.load_state_dict(flax_to_state_dict(jest.state.params))
    return est, jest, sweep, jsweep


def test_export_bundle_matches_the_reference_estimator(tmp_path,
                                                       cora_pair):
    """export_bundle from the port's NodeEstimator (cora stand-in, the
    reference's params converted in, its draws replayed) against the
    reference BaseEstimator's on the same sweep: params key for key and
    bit for bit (flax paths, kernels [in, out]), spec, meta and ids
    equal, the IVF state equal, embeddings within the forward's 1e-4
    (int8 features, float32 scale: test_torch_graphsage); each
    package's loader verifies the other's files; infer's two files
    agree the same way."""
    est, jest, sweep, jsweep = cora_pair
    assert len(sweep) == 6  # 2708 nodes, the last batch padded
    got = est.export_bundle(str(tmp_path / "pb"), input_fn=sweep,
                            nlist=8, nprobe=2, version="v1",
                            extra_meta={"run": "x"})
    want = jest.export_bundle(str(tmp_path / "jb"), input_fn=iter(jsweep),
                              nlist=8, nprobe=2, version="v1",
                              extra_meta={"run": "x"})
    assert sorted(got.params) == sorted(want.params)
    for k, v in want.params.items():
        assert got.params[k].dtype == v.dtype
        np.testing.assert_array_equal(got.params[k], v)
    assert got.model_spec == want.model_spec
    assert got.meta == want.meta == {"global_step": 0, "run": "x",
                                     "bundle_version": "v1"}
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.ids, np.arange(2708, dtype=np.uint64))
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=1e-4)
    assert sorted(got.index_state) == sorted(want.index_state)
    loaded = ref_export.ModelBundle.load(str(tmp_path / "pb"), verify=True)
    assert loaded.model_spec == want.model_spec
    np.testing.assert_array_equal(loaded.embeddings, got.embeddings)
    back = export.ModelBundle.load(str(tmp_path / "jb"), verify=True)
    np.testing.assert_array_equal(back.embeddings, want.embeddings)
    paths = est.infer(sweep, steps=4)
    jpaths = jest.infer(iter(jsweep), steps=4)
    e, je = np.load(paths["embedding"]), np.load(jpaths["embedding"])
    assert e.shape == je.shape == (4 * CORA_B, 2 * CORA_DIM)
    np.testing.assert_allclose(e, je, atol=1e-4)
    i, ji = np.load(paths["ids"]), np.load(jpaths["ids"])
    assert i.dtype == ji.dtype and np.array_equal(i, ji)


def test_export_bundle_sharded_and_without_index(tmp_path, cora_pair):
    """shards=2 writes the fleet layout (per-shard IVF), index=False no
    index, meta global_step follows the estimator's step; the sharded
    rows are exactly the unsharded export's."""
    est, _, sweep, _ = cora_pair
    est.step = 5
    try:
        one = est.export_bundle(str(tmp_path / "one"), input_fn=sweep,
                                index=False)
    finally:
        est.step = 0
    assert one.index_state is None and one.meta == {"global_step": 5}
    assert one.version == "step5"
    two = est.export_bundle(str(tmp_path / "two"), input_fn=sweep,
                            shards=2, nlist=4)
    assert ref_export.bundle_shard_count(str(tmp_path / "two")) == 2
    whole = ref_export.ModelBundle.load(str(tmp_path / "two"))
    np.testing.assert_array_equal(whole.embeddings, one.embeddings)
    np.testing.assert_array_equal(two.embeddings, one.embeddings)
    for s in range(2):
        assert ref_export.ModelBundle.load_shard(
            str(tmp_path / "two"), s).index_state is not None


def test_model_specs_name_the_reference_fields():
    """export_spec of each port model: the reference model's class name
    and the scalar dataclass fields its export_bundle records, with the
    same values."""
    import dataclasses

    from euler_tpu.models import embedding_models as jem
    from euler_tpu.models import graphsage as jgs
    from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
    from euler_tpu_torch.models.graphsage import \
        DeviceSampledUnsupervisedSage

    def ref_spec(m):
        spec = {"model_class": type(m).__name__}
        for f in dataclasses.fields(m):
            v = getattr(m, f.name, None)
            if f.name not in ("parent", "name") and (
                    isinstance(v, (str, int, float, bool)) or v is None):
                spec[f.name] = v
        return spec

    cases = [
        (DeviceSampledGraphSage(5, 8, multilabel=False, dim=12,
                                fanouts=(4, 3), remat=True,
                                uniform_sampling=True, dropout=0.25),
         jgs.DeviceSampledGraphSage(num_classes=5, multilabel=False,
                                    dim=12, fanouts=(4, 3), remat=True,
                                    uniform_sampling=True, dropout=0.25)),
        (DeviceSampledUnsupervisedSage(40, 8, dim=12, fanouts=(4, 3),
                                       num_negs=3),
         jgs.DeviceSampledUnsupervisedSage(num_rows=40, dim=12,
                                           fanouts=(4, 3), num_negs=3)),
        (DeviceSampledSkipGram(40, dim=12, walk_len=3, left_win=2,
                               num_negs=4, p=0.5, q=2.0, share_context=True,
                               uniform_sampling=True),
         jem.DeviceSampledSkipGram(num_rows=40, dim=12, walk_len=3,
                                   left_win=2, num_negs=4, p=0.5, q=2.0,
                                   share_context=True,
                                   uniform_sampling=True)),
    ]
    for port, ref in cases:
        assert port.export_spec() == ref_spec(ref)
