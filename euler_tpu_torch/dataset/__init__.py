"""Datasets of the port (synthetic stand-ins in the graph engine).

`get_dataset(name)` returns the named citation stand-in as an
engine-backed GraphData (base_dataset.py), "mutag" as a GraphSetData,
and the knowledge graphs fb15k, fb15k237 and wn18 as a KGData
(kg_sets.load_kg), as the reference's does
(euler_tpu/dataset/__init__.py:72-81); `dataset_arrays(name)` gives the
same stand-in as arrays (synthetic.GraphArrays). The shapes and
calibrated difficulty knobs are a copy of euler_tpu/dataset/__init__.py
`_CITATION_SHAPES` (cora, citeseer, pubmed, ppi), fed to the same numpy
draws (synthetic.synthetic_citation), so the port's "cora" has the
reference's features, labels, split and edges. The reference first
looks for prepared files under $EULER_TPU_DATA_DIR; the port always
builds the stand-in.
"""

from __future__ import annotations

from euler_tpu_torch.dataset.base_dataset import (  # noqa: F401
    FEATURE_FID, LABEL_FID, GraphData, build_engine, engine_from_arrays,
)
from euler_tpu_torch.dataset.graph_sets import (  # noqa: F401
    GraphSetData, mutag_like,
)
from euler_tpu_torch.dataset.kg_sets import KGData, load_kg  # noqa: F401
from euler_tpu_torch.dataset.synthetic import (  # noqa: F401
    TEST_TYPE, TRAIN_TYPE, VAL_TYPE, GraphArrays, synthetic_citation,
)

# copy of euler_tpu/dataset/__init__.py:_CITATION_SHAPES (citation sets)
_CITATION_SHAPES = {
    "cora": dict(n=2708, d=1433, num_classes=7, signal=1.2,
                 confuse_frac=0.2, informative_dims=48,
                 intra_degree=3.0, inter_degree=1.5),
    "citeseer": dict(n=3327, d=3703, num_classes=6, signal=1.12,
                     confuse_frac=0.21, informative_dims=48,
                     intra_degree=3.0, inter_degree=1.4),
    "pubmed": dict(n=19717, d=500, num_classes=3, signal=1.1,
                   confuse_frac=0.25, informative_dims=32,
                   intra_degree=3.6, inter_degree=0.9),
    "ppi": dict(n=14755, d=50, num_classes=121, signal=1.0,
                confuse_frac=0.2, informative_dims=24),
}


def dataset_arrays(name: str, **overrides) -> GraphArrays:
    """The named citation stand-in as GraphArrays (node_types gives the
    split); overrides replace its knobs, as in the reference."""
    name = name.lower()
    if name not in _CITATION_SHAPES:
        raise ValueError(f"unknown dataset {name!r}; options "
                         f"{sorted(_CITATION_SHAPES)} (the other named "
                         "sets are not ported yet)")
    return synthetic_citation(**{**_CITATION_SHAPES[name], **overrides})


_KG_SETS = ("fb15k", "fb15k237", "wn18")


def get_dataset(name: str, **overrides):
    """The named citation stand-in loaded into the graph engine (a
    GraphData), "mutag", the graph-classification stand-in (a
    GraphSetData; overrides are mutag_like's arguments), or a knowledge
    graph (a KGData; overrides are load_kg's num_triples and seed)."""
    if name.lower() == "mutag":
        return mutag_like(**overrides)
    if name.lower() in _KG_SETS:
        return load_kg(name.lower(), **overrides)
    return engine_from_arrays(dataset_arrays(name, **overrides),
                              name=name.lower())
