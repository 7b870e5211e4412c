"""GraphSAGE path of the PyTorch port against the JAX package, on the CPU:
aggregators and SageEncoder against flax with converted params, the full
DeviceSampledGraphSage with replayed uniforms against its flax apply,
and the inference sweep against embed_all's contract."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.models.graphsage import \
    DeviceSampledGraphSage as JaxDeviceSampledGraphSage
from euler_tpu.parallel.feature_store import \
    DeviceFeatureStore as JaxDeviceFeatureStore
from euler_tpu.serving.export import embed_all as jax_embed_all
from euler_tpu.utils import aggregators as JA
from euler_tpu.utils.encoders import SageEncoder as JaxSageEncoder
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.infer import NodeInferencer
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.utils import aggregators as PA
from euler_tpu_torch.utils.encoders import SageEncoder

B, D, DIM, FANOUTS, CLASSES = 16, 16, 8, (3, 2), 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(params))
    return module


def test_dense_fresh_init_matches_flax_lecun_normal():
    """Same distribution as flax.linen.Dense's init (draws differ):
    truncated at ±2 of its pre-truncation std, variance 1/fan_in, zero
    bias, and reproducible from the generator."""
    import flax.linen as fnn

    from euler_tpu_torch.utils.layers import Dense

    fan_in, out = 256, 512
    ref = np.asarray(fnn.Dense(out).init(
        jax.random.key(0), np.zeros((1, fan_in), np.float32))
        ["params"]["kernel"])
    d = Dense(fan_in, out, generator=torch.Generator().manual_seed(0))
    w = d.weight.detach().numpy()
    assert w.shape == (out, fan_in) and not d.bias.detach().numpy().any()
    bound = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound
    np.testing.assert_allclose(w.std(), ref.std(), rtol=0.02)
    np.testing.assert_allclose(w.std(), np.sqrt(1.0 / fan_in), rtol=0.02)
    again = Dense(fan_in, out, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, d.weight)


@pytest.mark.parametrize("name", ["mean", "meanpool", "maxpool", "gcn"])
def test_aggregators_match_flax(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, D)).astype(np.float32)
    nbr = rng.normal(size=(B, 3, D)).astype(np.float32)
    j = JA.get_aggregator(name)(dim=DIM)
    params = j.init(jax.random.key(0), x, nbr)
    want = np.asarray(j.apply(params, x, nbr))
    p = _load(PA.get_aggregator(name)(D, DIM), params)
    got = p(_t(x), _t(nbr)).detach().numpy()
    assert got.shape == want.shape == (B, p.out_dim)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if name == "mean":
        via_mean = p(_t(x), nbr_mean=_t(nbr).mean(1)).detach().numpy()
        np.testing.assert_allclose(via_mean, want, atol=1e-5)


@pytest.mark.parametrize("aggregator", ["mean", "meanpool", "maxpool"])
def test_sage_encoder_matches_flax(aggregator):
    rng = np.random.default_rng(1)
    layers = [rng.normal(size=(B * int(np.prod(FANOUTS[:h])), D))
              .astype(np.float32) for h in range(len(FANOUTS) + 1)]
    j = JaxSageEncoder(DIM, FANOUTS, aggregator)
    params = j.init(jax.random.key(1), layers)
    want = np.asarray(j.apply(params, layers))
    p = _load(SageEncoder(D, DIM, FANOUTS, aggregator), params)
    got = p([_t(x) for x in layers]).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if aggregator == "mean":
        last = _t(layers[-1]).view(-1, FANOUTS[-1], D).mean(1)
        got2 = p([_t(x) for x in layers[:-1]], nbr_mean=last)
        np.testing.assert_allclose(got2.detach().numpy(), want, atol=1e-5)
    else:
        with pytest.raises(ValueError):
            p([_t(x) for x in layers[:-1]], nbr_mean=_t(layers[-2]))


def _graph():
    g = synthetic_citation(n=300, d=D, num_classes=CLASSES, seed=2,
                           intra_degree=6.0, inter_degree=2.0)
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, CLASSES), np.float32)])
    return g, feats, labels


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("uniform_sampling", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_device_sampled_graphsage_matches_flax(uniform_sampling, masked,
                                               scale_dtype):
    """int8 features, replayed uniforms: embedding, loss and metric
    against the reference's apply. float32 scale: within atol 1e-4.
    bfloat16 scale (the main path's): the port rounds the deepest
    neighbor mean to bf16 once where the reference rounds each
    dequantized row, so the embedding is held within one bf16 ulp of its
    largest value (2^-7 of max |embedding|), and loss and metric
    likewise."""
    g, feats, labels = _graph()
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                       device="cpu", keep_host=True)
    store = DeviceFeatureStore.from_arrays(
        feats, labels, quantize="int8",
        scale_dtype=getattr(torch, scale_dtype), device="cpu")
    jstore = JaxDeviceFeatureStore.from_arrays(
        feats, labels, quantize="int8", scale_dtype=getattr(jnp, scale_dtype))
    np.testing.assert_array_equal(np.asarray(jstore.features),
                                  store.features.numpy())
    roots = np.random.default_rng(3).integers(0, 300, B).astype(np.int32)
    seed = np.uint32(5)
    nbr_h, cum_h = tab.host_tables
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              "nbr_table": jnp.asarray(nbr_h), "cum_table": jnp.asarray(cum_h),
              "feature_table": jstore.features,
              "feature_scale": jstore.feature_scale,
              "label_table": jstore.labels}
    mask = (np.arange(B) < B - 5).astype(np.float32)
    if masked:
        jbatch["metric_mask"] = jnp.asarray(mask)
    jm = JaxDeviceSampledGraphSage(num_classes=CLASSES, multilabel=False,
                                   dim=DIM, fanouts=FANOUTS,
                                   uniform_sampling=uniform_sampling)
    params = jm.init(jax.random.key(4), jbatch)
    want = jm.apply(params, jbatch)
    # replay the reference's draw: fold_in(key(17), seed), split per hop
    key, n, uniforms = jax.random.fold_in(jax.random.key(17), seed), B, []
    for k in FANOUTS:
        key, sub = jax.random.split(key)
        uniforms.append(_t(jax.random.uniform(sub, (n, k))))
        n *= k
    pm = _load(DeviceSampledGraphSage(CLASSES, D, multilabel=False, dim=DIM,
                                      fanouts=FANOUTS,
                                      uniform_sampling=uniform_sampling),
               params)
    batch = {"rows": [torch.from_numpy(roots)], "sample_seed": int(seed),
             "sample_uniforms": uniforms, **tab.tables,
             "feature_table": store.features,
             "feature_scale": store.feature_scale,
             "label_table": store.labels}
    if masked:
        batch["metric_mask"] = torch.from_numpy(mask)
    with torch.inference_mode():
        got = pm(batch)
    assert got.embedding.shape == (B, 2 * DIM)
    want_emb = np.asarray(want.embedding)
    atol = 1e-4 if scale_dtype == "float32" else \
        2 ** -7 * float(np.abs(want_emb).max())
    np.testing.assert_allclose(got.embedding.numpy(), want_emb, atol=atol)
    assert abs(float(got.loss) - float(want.loss)) <= atol
    assert abs(float(got.metric) - float(want.metric)) <= 1e-4
    assert got.metric_name == want.metric_name
    # converter roundtrip is exact
    back = state_dict_to_flax(pm.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(a).tobytes() == b.tobytes()


def test_deepest_hop_goes_through_neighbor_mean():
    g, feats, labels = _graph()
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                       device="cpu")
    store = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                           device="cpu")
    m = DeviceSampledGraphSage(CLASSES, D, dim=DIM, fanouts=FANOUTS,
                               uniform_sampling=True,
                               generator=torch.Generator().manual_seed(0))
    batch = {"rows": [torch.arange(B, dtype=torch.int32)], "sample_seed": 1,
             **tab.tables}
    rows = m.sample_rows(batch)
    assert [r.shape[0] for r in rows] == [B, B * 3, B * 6]
    assert torch.equal(m.sample_rows(batch)[2], rows[2])  # seeded stream
    calls = []

    def spy(table, r, scale):
        calls.append(tuple(r.shape))
        from euler_tpu_torch.ops.gather_mean import gather_mean_reference
        return gather_mean_reference(table, r, scale)

    with torch.inference_mode():
        a = m.encoder(store.features, store.feature_scale, rows,
                      neighbor_mean=spy)
        b = m.encoder(store.features, store.feature_scale, rows)
    assert calls == [(B * 3, 2)]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{"encoder": "genie"}, {"encoder": "gcn"},
                                {"aggregator": "maxpool"}])
def test_unported_options_raise(kw):
    """The gcn and genie encoders and the pool aggregators are ported
    now: the model builds and runs a forward. shard_rows without a mesh
    places replicated tables, as the reference's does (row-sharded
    tables on a mesh: tests/test_torch_parallel.py)."""
    g, feats, labels = _graph()
    m = DeviceSampledGraphSage(CLASSES, D, dim=DIM, fanouts=FANOUTS,
                               generator=torch.Generator().manual_seed(0),
                               **kw)
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                       device="cpu")
    store = DeviceFeatureStore.from_arrays(feats, labels, device="cpu")
    with torch.no_grad():
        out = m({"rows": [torch.arange(B, dtype=torch.int32)],
                 "sample_seed": 1, **tab.tables,
                 "feature_table": store.features,
                 "label_table": store.labels})
    assert out.embedding.shape == (B, m.encoder.out_dim)
    assert torch.isfinite(out.loss)
    # without a mesh, shard_rows places the tables replicated (the
    # reference's put_row_sharded(x, None))
    t = DeviceNeighborTable.from_arrays(np.zeros((3, 2), np.int32),
                                        np.zeros((3, 2), np.float32),
                                        device="cpu", shard_rows=True)
    assert t.neighbors.shape == (3, 2) and not hasattr(t.neighbors,
                                                        "row_shard")


def test_infer_sweep_padding_and_dedup_match_embed_all():
    g, feats, labels = _graph()
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                       device="cpu")
    store = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                           device="cpu")
    m = DeviceSampledGraphSage(CLASSES, D, multilabel=False, dim=DIM,
                               fanouts=FANOUTS, uniform_sampling=True,
                               generator=torch.Generator().manual_seed(0))
    inf = NodeInferencer(m, store, tab, batch_size=32)
    # reversed: 4 batches, the last with 4 real ids
    ids = np.arange(100, dtype=np.uint64)[::-1].copy()
    batches = list(inf.infer_input_fn(ids))
    assert len(batches) == 4
    assert [b["sample_seed"] for b in batches] == \
        [(1 << 31) | i for i in range(1, 5)]
    last = batches[-1]
    np.testing.assert_array_equal(last["infer_ids"][4:], ids[-1])
    assert last["metric_mask"].tolist() == [1.0] * 4 + [0.0] * 28
    assert all(float(b["metric_mask"].sum()) == 32 for b in batches[:3])
    got_ids, got_emb = inf.embed_all(batches)

    class _Est:  # the reference's embed_all over the same batches
        state, max_id, static_batch = object(), 0, {}

        @staticmethod
        def _eval_step(state, batch):
            return 0.0, 0.0, batch["emb"]

    raw = [{"infer_ids": b["infer_ids"],
            "emb": inf.run(b).embedding.numpy()} for b in batches]
    want_ids, want_emb = jax_embed_all(_Est, iter(raw))
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_ids, np.arange(100, dtype=np.uint64))
    assert got_emb.dtype == np.float32 and got_emb.shape == (100, 2 * DIM)
    np.testing.assert_array_equal(got_emb, want_emb)
    out = inf.run(last)
    assert np.isfinite(float(out.loss)) and 0.0 <= float(out.metric) <= 1.0
