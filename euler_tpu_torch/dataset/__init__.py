"""Datasets of the port, in the graph engine.

`get_dataset(name, **overrides)` is the reference's registry
(euler_tpu/dataset/__init__.py:52-81): the citation sets (cora,
citeseer, pubmed, ppi, reddit) through base_dataset.load_named, which
reads a prepared engine directory, an .npz or an OGB-style directory
under $EULER_TPU_DATA_DIR before it builds the stand-in; "mutag" (a
GraphSetData); the knowledge graphs fb15k, fb15k237 and wn18 (a KGData);
ml_1m (a RecData); and the real sets karate (networkx) and digits_knn
(sklearn). Overrides of a citation set replace its stand-in's knobs and
re-enter load_named, as the reference's do; other sets take them as
their function's arguments. `dataset_arrays(name)` gives a citation
stand-in as arrays (synthetic.GraphArrays). The shapes and calibrated
difficulty knobs are a copy of the reference's `_CITATION_SHAPES`, fed
to the same numpy draws (synthetic.synthetic_citation), so the port's
"cora" has the reference's features, labels, split and edges.
"""

from __future__ import annotations

from functools import partial

from euler_tpu_torch.dataset.base_dataset import (  # noqa: F401
    DATA_DIR_ENV, FEATURE_FID, LABEL_FID, GraphData, build_engine,
    engine_from_arrays, load_named,
)
from euler_tpu_torch.dataset.graph_sets import (  # noqa: F401
    GraphSetData, mutag_like,
)
from euler_tpu_torch.dataset.kg_sets import KGData, load_kg  # noqa: F401
from euler_tpu_torch.dataset.ml_1m import RecData, ml_1m  # noqa: F401
from euler_tpu_torch.dataset.real_sets import (  # noqa: F401
    digits_knn, karate,
)
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
    "reddit": dict(n=232965, d=602, num_classes=41, signal=1.2,
                   confuse_frac=0.15, informative_dims=48),
}

_REGISTRY = {}
for _name, _shape in _CITATION_SHAPES.items():
    _REGISTRY[_name] = partial(load_named, _name, dict(_shape))
_REGISTRY["mutag"] = mutag_like
for _kg in ("fb15k", "fb15k237", "wn18"):
    _REGISTRY[_kg] = partial(load_kg, _kg)
_REGISTRY["ml_1m"] = ml_1m
_REGISTRY["karate"] = karate
_REGISTRY["digits_knn"] = digits_knn


def dataset_arrays(name: str, **overrides) -> GraphArrays:
    """The named citation stand-in as GraphArrays (node_types gives the
    split); overrides replace its knobs, as in the reference."""
    name = name.lower()
    if name not in _CITATION_SHAPES:
        raise ValueError(f"unknown dataset {name!r}; the stand-ins are "
                         f"{sorted(_CITATION_SHAPES)}")
    return synthetic_citation(**{**_CITATION_SHAPES[name], **overrides})


def get_dataset(name: str, **overrides):
    """The named dataset (see the module docstring)."""
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown dataset {name!r}; options {sorted(_REGISTRY)}")
    fn = _REGISTRY[name]
    if overrides and isinstance(fn, partial) and fn.func is load_named:
        cfg = dict(fn.args[1])
        cfg.update(overrides)
        return load_named(fn.args[0], cfg)
    return fn(**overrides) if overrides else fn()
