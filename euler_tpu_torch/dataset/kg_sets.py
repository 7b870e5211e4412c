"""Knowledge-graph datasets fb15k, fb15k237 and wn18 in the port's graph
engine (copy of euler_tpu/dataset/kg_sets.py: KGData, _SHAPES,
_synthetic_triples, load_kg; tests/test_torch_kg.py pins it to the
original).

A local triples file under $EULER_TPU_DATA_DIR (<name>/train.txt of
"head relation tail" lines) is read when it exists; otherwise the
synthetic multi-relational stand-in of the dataset's shape is built.
The graph has one node type and one edge type per relation; the
link-prediction runners draw positive triples with sample_edge and
corrupt the tails for negatives.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from euler_tpu_torch.graph import GraphBuilder, GraphEngine

DATA_DIR_ENV = "EULER_TPU_DATA_DIR"


@dataclass
class KGData:
    engine: GraphEngine
    num_entities: int
    num_relations: int
    name: str = ""
    source: str = "synthetic"


_SHAPES = {
    "fb15k": dict(num_entities=14951, num_relations=1345),
    "fb15k237": dict(num_entities=14541, num_relations=237),
    "wn18": dict(num_entities=40943, num_relations=18),
}


def _build(triples: np.ndarray, num_entities: int, num_relations: int,
           name: str, source: str) -> KGData:
    b = GraphBuilder()
    b.set_num_types(1, num_relations)
    ids = np.arange(num_entities, dtype=np.uint64)
    b.add_nodes(ids)
    b.add_edges(triples[:, 0].astype(np.uint64),
                triples[:, 2].astype(np.uint64),
                types=triples[:, 1].astype(np.int32))
    return KGData(b.finalize(), num_entities, num_relations, name, source)


def _synthetic_triples(num_entities: int, num_relations: int,
                       num_triples: int, seed: int = 0) -> np.ndarray:
    """Clustered relational structure: each relation r maps entity block
    A_r → block B_r (plus 10% noise), so translation embeddings rank real
    tails above corruptions. The numpy draws are the original's, in its
    order."""
    rng = np.random.default_rng(seed)
    n_blocks = max(8, num_relations // 8)
    block = rng.integers(0, n_blocks, num_entities)
    rel_src_block = rng.integers(0, n_blocks, num_relations)
    rel_dst_block = rng.integers(0, n_blocks, num_relations)
    by_block = [np.where(block == bl)[0] for bl in range(n_blocks)]
    out = np.zeros((num_triples, 3), np.int64)
    r = rng.integers(0, num_relations, num_triples)
    for i in range(num_triples):
        ri = r[i]
        sb = by_block[rel_src_block[ri]]
        db = by_block[rel_dst_block[ri]]
        if rng.random() < 0.1 or len(sb) == 0 or len(db) == 0:  # noise
            out[i] = (rng.integers(num_entities), ri,
                      rng.integers(num_entities))
        else:
            out[i] = (sb[rng.integers(len(sb))], ri, db[rng.integers(len(db))])
    return out


def load_kg(name: str, num_triples: int = 50000, seed: int = 0) -> KGData:
    """The named KG: $EULER_TPU_DATA_DIR/<name>/train.txt when it exists
    (entities and relations numbered in order of first appearance), else
    the synthetic stand-in of num_triples triples from `seed`."""
    shape = _SHAPES[name]
    data_dir = os.environ.get(DATA_DIR_ENV, "")
    path = os.path.join(data_dir, name, "train.txt") if data_dir else ""
    if path and os.path.exists(path):
        ent, rel = {}, {}
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 3:
                    continue
                h, r, t = parts
                rows.append((ent.setdefault(h, len(ent)),
                             rel.setdefault(r, len(rel)),
                             ent.setdefault(t, len(ent))))
        triples = np.asarray(rows, np.int64)
        return _build(triples, len(ent), len(rel), name, path)
    triples = _synthetic_triples(shape["num_entities"],
                                 shape["num_relations"], num_triples, seed)
    return _build(triples, shape["num_entities"], shape["num_relations"],
                  name, "synthetic")
