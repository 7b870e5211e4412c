"""serving/engine.py of the PyTorch port against the JAX package's
_BundleEngine applies (euler_tpu/serving/server.py), on the CPU."""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from euler_tpu.serving.server import _BundleEngine
from euler_tpu_torch.serving.engine import EmbeddingEngine


def _engines(n=50, d=12):
    rng = np.random.default_rng(0)
    ids = np.sort(rng.choice(10_000, n, replace=False)).astype(np.uint64)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    bundle = types.SimpleNamespace(ids=ids, embeddings=emb, shard=0,
                                   num_shards=1, version="v1",
                                   index_state=None)
    return ids, emb, _BundleEngine(bundle), EmbeddingEngine(ids, emb,
                                                            device="cpu")


def _queries(ids):
    rng = np.random.default_rng(1)
    q = rng.choice(ids, 20).astype(np.uint64)
    q[[3, 7]] = [np.uint64(10_001), np.uint64(2 ** 63 + 5)]  # unknown
    return q


def test_embed_matches_bundle_engine():
    ids, emb, ref, eng = _engines()
    q = _queries(ids)
    rows, valid, n_unknown = ref.lookup_rows(q)
    got_rows, got_valid, got_unknown = eng.lookup_rows(q)
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_valid, valid)
    assert got_unknown == n_unknown == 2
    want = np.array(ref.jit_gather(jnp.asarray(rows)), dtype=np.float32)
    want[~valid] = 0.0  # InferenceServer._run_embed
    got = eng.embed(q)
    np.testing.assert_array_equal(got, want)
    assert not got[[3, 7]].any()
    np.testing.assert_array_equal(got[valid], emb[rows[valid]])


def test_score_matches_bundle_engine():
    ids, emb, ref, eng = _engines()
    src = _queries(ids)
    dst = np.roll(src, 5)
    a, a_ok, _ = ref.lookup_rows(src)
    b, b_ok, _ = ref.lookup_rows(dst)
    want = np.array(ref.jit_score(jnp.asarray(a), jnp.asarray(b)),
                    dtype=np.float32)
    want[~(a_ok & b_ok)] = 0.0  # InferenceServer._run_score
    got = eng.score(src, dst)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ok = a_ok & b_ok
    np.testing.assert_allclose(got[ok], (emb[a[ok]] * emb[b[ok]]).sum(-1),
                               rtol=1e-6, atol=1e-6)
    assert not got[~ok].any()


def test_empty_and_bad_engines():
    empty = EmbeddingEngine(np.zeros(0, np.uint64), np.zeros((0, 4)),
                            device="cpu")
    assert empty.embed(np.array([1, 2], np.uint64)).shape == (2, 4)
    assert not empty.score(np.array([1], np.uint64),
                           np.array([2], np.uint64)).any()
    with pytest.raises(ValueError):
        EmbeddingEngine(np.array([3, 1], np.uint64), np.zeros((2, 4)),
                        device="cpu")
    with pytest.raises(ValueError):
        EmbeddingEngine(np.array([1, 3], np.uint64), np.zeros((3, 4)),
                        device="cpu")
    ids, emb, _, eng = _engines()
    with pytest.raises(ValueError):
        eng.score(ids[:3], ids[:2])
