"""Data from files and the rest of the dataset registry, in the port
against the JAX package, on the CPU: load_named over each
$EULER_TPU_DATA_DIR layout (a dumped engine directory, a native .npz, a
gnn-benchmark CSR .npz, an OGB-style directory) through get_dataset,
the registry's names, ml_1m (the synthetic ratings and a ratings.dat),
reddit at a reduced size, karate and digits_knn (where networkx and
sklearn are installed), generate_data's bytes and the engine that loads
them, hash64, and the DeepWalk and LINE runners on ml_1m.

Every comparison is exact: the same numpy draws and files go into the
same engine code in both packages, so node ids, types, features,
labels, neighbor lists and weights agree bit for bit."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)

import importlib
import json
import os

import numpy as np
import pytest

from euler_tpu import dataset as JD
from euler_tpu.dataset import base_dataset as JB
from euler_tpu.graph import GraphEngine as JEngine
from euler_tpu.tools import generate_data as JG
from euler_tpu.utils import hash64 as j_hash64
from euler_tpu_torch import dataset as PD
from euler_tpu_torch.dataset import base_dataset as PB
from euler_tpu_torch.graph import GraphEngine
from euler_tpu_torch.tools import generate_data as PG
from euler_tpu_torch.utils import hash64

# the modules (each package's dataset/__init__ binds the name ml_1m to
# the function)
JML = importlib.import_module("euler_tpu.dataset.ml_1m")
PML = importlib.import_module("euler_tpu_torch.dataset.ml_1m")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_engines(pg, jg, dense=("feature", "label"), edge_types=None):
    """Node ids, types, the named dense features and every node's full
    neighbor list (ids, weights, types) bit for bit."""
    assert (pg.node_count, pg.edge_count) == (jg.node_count, jg.edge_count)
    ids = jg.all_node_ids()
    _same(pg.all_node_ids(), ids)
    _same(pg.get_node_type(ids), jg.get_node_type(ids))
    for name in dense:
        _same(pg.get_dense_feature(ids, name), jg.get_dense_feature(ids, name))
    for a, b in zip(pg.get_full_neighbor(ids, edge_types),
                    jg.get_full_neighbor(ids, edge_types)):
        _same(a, b)


def _same_data(p, j, **kw):
    for k in ("num_classes", "feature_dim", "max_id", "name", "multilabel",
              "source"):
        assert getattr(p, k) == getattr(j, k), k
    _same_engines(p.engine, j.engine, **kw)


# -- $EULER_TPU_DATA_DIR layouts ------------------------------------------------

def _arrays(n=90, d=6, c=3, e=240, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, c, n), rng.integers(0, n, (2, e)))


def _write_engine_dir(root):
    """GraphEngine.dump of build_engine's graph of the arrays, 2
    partitions, as <root>/ppi."""
    x, y, edges = _arrays()
    masks = PB._planetoid_split(y, train_per_class=5, val=20, test=40)
    PB.build_engine(x, y, edges, *masks).dump(str(root / "ppi"), 2)


def _write_native_npz(root):
    x, y, edges = _arrays(seed=4)
    masks = JB._planetoid_split(y, train_per_class=4, val=10, test=30)
    np.savez(root / "cora.npz", features=x, labels=y, edges=edges,
             train_mask=masks[0], val_mask=masks[1], test_mask=masks[2])


def _write_csr_npz(root):
    """The gnn-benchmark keys, no masks (the planetoid split)."""
    x, y, edges = _arrays(seed=5)
    x[x < 0.5] = 0.0
    n = x.shape[0]

    def csr(dense, prefix):
        r, c = np.nonzero(dense)
        return {f"{prefix}_data": dense[r, c],
                f"{prefix}_indices": c.astype(np.int32),
                f"{prefix}_indptr": np.concatenate(
                    [[0], np.cumsum(np.bincount(r, minlength=len(dense)))]),
                f"{prefix}_shape": np.array(dense.shape)}

    adj = np.zeros((n, n), np.float32)
    adj[edges[0], edges[1]] = 1.0
    np.savez(root / "citeseer.npz", labels=y, **csr(adj, "adj"),
             **csr(x, "attr"))


def _write_ogb_dir(root):
    x, y, edges = _arrays(seed=6)
    d = root / "pubmed"
    d.mkdir()
    rng = np.random.default_rng(7)
    order = rng.permutation(len(y))
    for k, v in (("edge_index", edges), ("node_feat", x),
                 ("node_label", y.reshape(-1, 1)),
                 ("train_idx", order[:30]), ("valid_idx", order[30:50]),
                 ("test_idx", order[50:])):
        np.save(d / f"{k}.npy", v)


@pytest.mark.parametrize("name, write", [
    ("ppi", _write_engine_dir), ("cora", _write_native_npz),
    ("citeseer", _write_csr_npz), ("pubmed", _write_ogb_dir)])
def test_get_dataset_reads_each_data_dir_layout(tmp_path, monkeypatch,
                                                name, write):
    """get_dataset(name) under $EULER_TPU_DATA_DIR reads the file in the
    reference's order (engine directory, .npz, OGB directory): the same
    GraphData fields (source = the file) and engine as the reference's;
    the stand-in's shape is not used."""
    write(tmp_path)
    monkeypatch.setenv(PB.DATA_DIR_ENV, str(tmp_path))
    p, j = PD.get_dataset(name), JD.get_dataset(name)
    assert p.source.startswith(str(tmp_path)) and p.engine.node_count == 90
    _same_data(p, j)


def test_load_named_falls_back_to_the_stand_in(tmp_path, monkeypatch):
    """A data directory without the set's files, and an .npz with a
    partial mask set: the stand-in with the overrides, and the
    reference's ValueError."""
    monkeypatch.setenv(PB.DATA_DIR_ENV, str(tmp_path))
    kw = dict(n=300, d=12, num_classes=3, train_per_class=5, val=30,
              test=60)
    _same_data(PD.get_dataset("cora", **kw), JD.get_dataset("cora", **kw))
    x, y, edges = _arrays()
    np.savez(tmp_path / "cora.npz", features=x, labels=y, edges=edges,
             train_mask=np.ones(len(y), bool))
    for get in (PD.get_dataset, JD.get_dataset):
        with pytest.raises(ValueError, match="not all of"):
            get("cora")


def test_the_registry_matches_the_reference():
    assert sorted(PD._REGISTRY) == sorted(JD._REGISTRY)
    assert PD._CITATION_SHAPES == JD._CITATION_SHAPES
    for get in (PD.get_dataset, JD.get_dataset):
        with pytest.raises(ValueError, match="unknown dataset"):
            get("nope")


def test_reddit_reduced_matches_the_reference():
    """reddit's shape (602 features, 41 classes) at n = 2000 through the
    registry's overrides."""
    kw = dict(n=2000, train_per_class=5, val=200, test=400)
    p, j = PD.get_dataset("reddit", **kw), JD.get_dataset("reddit", **kw)
    assert (p.feature_dim, p.num_classes) == (602, 41)
    _same_data(p, j)


# -- ml_1m ---------------------------------------------------------------------

ML_KW = dict(num_users=200, num_items=80, num_ratings=4000)


def _same_rec(p, j):
    for k in ("num_users", "num_items", "max_id", "name", "source"):
        assert getattr(p, k) == getattr(j, k), k
    _same_engines(p.engine, j.engine, dense=())


def test_ml_1m_matches_the_reference():
    """The synthetic ratings array for array (seeds 0 and 1), and the
    engines: users 1..U, items U+1..U+I, rated edges weighted by the
    rating with their reverses, through the registry's overrides."""
    for seed in (0, 1):
        _same(PML._synthetic_ratings(200, 80, 4000, seed=seed),
              JML._synthetic_ratings(200, 80, 4000, seed=seed))
    p, j = PD.get_dataset("ml_1m", **ML_KW), JD.get_dataset("ml_1m", **ML_KW)
    assert p.max_id == 280 and p.engine.node_count == 280
    _same_rec(p, j)


def test_ml_1m_reads_ratings_dat(tmp_path, monkeypatch):
    """ml_1m/ratings.dat ("user::item::rating::ts", sparse movie ids, a
    malformed line skipped): the id space from the file, source
    "local"."""
    d = tmp_path / "ml_1m"
    d.mkdir()
    (d / "ratings.dat").write_text(
        "1::7::5::978300760\n2::3::3::978302109\nbad\n"
        "3::7::4::978301968\n2::9::1::978300275\n", encoding="latin-1")
    monkeypatch.setenv(PB.DATA_DIR_ENV, str(tmp_path))
    p, j = PD.get_dataset("ml_1m"), JD.get_dataset("ml_1m")
    assert (p.num_users, p.num_items, p.source) == (3, 9, "local")
    _same_rec(p, j)


# -- the real sets ---------------------------------------------------------------

def test_karate_matches_the_reference():
    pytest.importorskip("networkx")
    from euler_tpu.dataset import real_sets as JR
    from euler_tpu_torch.dataset import real_sets as PR

    pa, ja = PR.karate_arrays(), JR.karate_arrays()
    assert sorted(pa) == sorted(ja)
    for k in pa:
        _same(pa[k], ja[k])
    _same_data(PD.get_dataset("karate"), JD.get_dataset("karate"))


def test_digits_knn_matches_the_reference():
    pytest.importorskip("sklearn")
    _same_data(PD.get_dataset("digits_knn", k=4),
               JD.get_dataset("digits_knn", k=4))


# -- generate_data -----------------------------------------------------------------

GRAPH = {
    "name": "toy",
    "nodes": [
        {"id": 1, "type": "user", "weight": 2.0,
         "features": [{"name": "f", "type": "dense", "value": [1, 2]},
                      {"name": "s", "type": "sparse", "value": [7, 9]},
                      {"name": "b", "type": "binary", "value": "ab"}]},
        {"id": 2, "type": "item", "weight": 1.0,
         "features": [{"name": "f", "type": "dense", "value": [3, 4]}]},
        {"id": "u_x", "type": "user", "weight": 0.5, "features": []},
        {"id": 3, "type": "user", "features": []},
    ],
    "edges": [
        {"src": 1, "dst": 2, "type": "buy", "weight": 1.5,
         "features": [{"name": "ef", "type": "dense", "value": [9]}]},
        {"src": 2, "dst": 3, "type": "buy", "weight": 1.0, "features": []},
        {"src": 3, "dst": 1, "type": "click", "weight": 2.0,
         "features": []},
        {"src": "u_x", "dst": 1, "type": "click"},
    ],
}


@pytest.mark.parametrize("parts", [1, 3])
def test_generate_data_writes_the_reference_bytes(tmp_path, parts):
    """The same graph.json (string types, a string id hashed by hash64,
    dense, sparse and binary features) → the same meta.bin and
    part_*.dat bytes and stats; the port's GraphEngine.load reads the
    directory as the reference's engine does."""
    src = tmp_path / "graph.json"
    src.write_text(json.dumps(GRAPH))
    stats = PG.convert(str(src), str(tmp_path / "p"), parts)
    assert stats == JG.convert(str(src), str(tmp_path / "j"), parts)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == \
        ["meta.bin"] + [f"part_{i}.dat" for i in range(parts)]
    for f in names:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    pg, jg = GraphEngine.load(str(tmp_path / "p")), \
        JEngine.load(str(tmp_path / "j"))
    _same_engines(pg, jg, dense=("f",))
    ids = jg.all_node_ids()
    for a, b in zip(pg.get_sparse_feature(ids, "s"),
                    jg.get_sparse_feature(ids, "s")):
        _same(a, b)
    assert hash64("u_x") in set(ids.tolist())


def test_hash64_matches_the_reference():
    for s in ("u_x", "", "ünïcode", b"\x00raw"):
        assert hash64(s) == j_hash64(s)


def test_generate_data_command_line(tmp_path, capsys):
    """`python -m euler_tpu_torch.tools.generate_data graph.json out P`
    prints the stats; without arguments it prints its usage, exit 1."""
    src = tmp_path / "graph.json"
    src.write_text(json.dumps(GRAPH))
    assert PG.main([str(src), str(tmp_path / "out"), "2"]) == 0
    assert json.loads(capsys.readouterr().out)["partitions"] == 2
    assert PG.main([]) == 1


# -- the runners on ml_1m ------------------------------------------------------------

@pytest.fixture(scope="module")
def one_ml_1m_engine():
    """The four runs below share one ml_1m engine (2M edges, ~1.7 s a
    build): load_graph builds each dataset once inside
    common.shared_graphs and seeds the engine per run, as it would a
    fresh one. The runner tests close this module, so the sharing ends
    with them."""
    from euler_tpu_torch.examples import common

    with common.shared_graphs():
        yield


@pytest.mark.parametrize("runner", ["run_deepwalk", "run_line"])
def test_walk_runners_train_on_ml_1m(runner, one_ml_1m_engine):
    """run_deepwalk and run_line --dataset ml_1m, host-fed on the CPU, a
    few steps at K = 1 and K = 4 (eager windows here): a finite eval
    MRR, the same at both K."""
    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    res = [mod.main(["--dataset", "ml_1m", "--max_steps", "8",
                     "--eval_steps", "2", "--steps_per_loop", k,
                     "--device", "cpu"]) for k in ("1", "4")]
    assert np.isfinite(res[0]["eval_metric"])
    assert res[0]["train_global_step"] == 8
    assert res[0]["eval_metric"] == res[1]["eval_metric"]
    assert res[0]["train_loss"] == res[1]["train_loss"]
