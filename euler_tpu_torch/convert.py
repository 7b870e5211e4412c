"""Parameters between the JAX package and the port.

A flax param tree of Dense layers, Embedding tables and other vectors
(as numpy), e.g. the reference DeviceSampledGraphSage's

    encoder/enc/agg_{d}/{self,nbr}/{kernel,bias},  out/{kernel,bias}

(the gcn encoder's encoder/enc/w_{d}/kernel, the genie encoder's
proj, depth_fc_{d}, att_{d}/{key,query}, w_{d}_{h} and
depth_lstm/OptimizedLSTMCell_0/{ii,if,ig,io,hi,hf,hg,ho}),
DeviceSampledUnsupervisedSage's encoder/agg_{d}/... and ctx_emb/table,
DeviceSampledSkipGram's emb/table and ctx/table,
DeviceSampledScalableSage's encoder/w_{l}, the host-fed
SupervisedGraphSage's encoder/agg_{d}/... and out/..., the host-fed
UnsupervisedGraphSage's encoder/agg_{d}/... and ctx_emb/table, or the
host-fed DeepWalk's and LINE's emb/table and ctx/table (LINE order 1:
emb/table alone), the layerwise models' encoder/w_{i}/kernel (or the
FastGCN runner's enc/w_{i}/kernel), or the conv stacks'
gnn/<Conv>_{i}/... (lin/kernel, bias, att_src, att_dst, beta, eps,
lin_{k}, v_{s}_{t}, w_{s}_{t}, mlp_{i}, q/k/v, lin_root, lin_nbr) and
the DNA runner's proj and dna_{i}, the graph models'
gnn/<Conv>_{i}/... and gnn/<Pool>_0/... (AttentionPool's gate and proj,
Set2SetPool's proj and OptimizedLSTMCell_0/{ii,...,ho}), GatedGraphConv's
gru/{ir,iz,in,hr,hz,hn} (flax's GRUCell) and w_{t}, the GAE's enc/...,
mu and logvar, DGI's encoder/..., PReLU_0/negative_slope and disc, and
the LGCN runner's enc/conv/{kernel,bias}, RelationConv's and the R-GCN
runner's w_rel [R, in, out] with RelationConv's lin_root, the KG models'
ent, rel, norm, proj, rel_p and ent_p tables, the solutions' enc/...,
head/logits and ctx/table, ShallowEncoder's id_emb and feat,
SparseSageEncoder's sp_emb/table and sage/agg_{d}, and GroupGNNNet's
gnn_{g} (or gnn) and combine, maps to the port's
state_dict keys by joining the path with "." and renaming kernel →
weight. Flax Dense kernels are [in, out]; the port's weights are [out,
in], so kernels are transposed both ways. A flax Conv kernel [width,
in, out] is torch Conv1d's weight [out, in, width], its axes reversed
both ways. The recurrent cells' gates are Dense layers by name in both
packages, so their trees map as Dense trees do. Tables [rows, dim] and
other vectors (AttLayer's query, GAT's att_src / att_dst [1, H, D],
AGNN's beta, GIN's eps, a conv's bias, PReLU's scalar negative_slope,
DGI's disc [dim, dim], a stacked relation weight w_rel) keep their
layout.

Row-sharded states (a model after parallel.train.spmd_init or
sharded_embedding.apply_param_shardings, or shard_act_cache's caches):
`shard_state_dict` cuts a whole state_dict (from flax_to_state_dict of
the reference's global params, or a one-process checkpoint) into this
rank's rows by put_row_sharded's rule, and `gather_state_dict`
all-gathers a rank's state back into whole tensors (every rank of the
model group calls it), so a checkpoint moves between worlds of any
size.

The scalable models' `cache` collection (encoder/cache_{l}/h, float32
or bfloat16 rows) is the port's buffers encoder.cache_{l}.h: it comes
in with the params when the flax variables {"params", "cache"} are
given, and goes out through `state_dict_to_flax_variables`. The params
alone (`state_dict_to_flax`, `flax_param_paths`) leave it out, as the
reference's export_bundle does.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CACHE_LEAF = "h"
# leaves other than Dense kernels, which keep their layout
_PLAIN = ("bias", "table", "query", "att_src", "att_dst", "beta", "eps",
          "negative_slope", "disc", "w_rel")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy → torch, a bfloat16 array (ml_dtypes) by its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy, a bfloat16 tensor as ml_dtypes.bfloat16 (jax's
    numpy bfloat16), by its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (optionally wrapped as {"params": ...}, or the
    variables {"params": ..., "cache": ...}) → state_dict."""
    cache = {}
    if "params" in params and set(params) <= {"params", "cache"}:
        cache = params.get("cache") or {}
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        *scope, name = path
        arr = np.asarray(leaf)
        if name == "kernel":
            if arr.ndim not in (2, 3):
                raise ValueError(f"{'/'.join(path)}: only Dense and 1-D "
                                 f"Conv kernels convert, got shape "
                                 f"{arr.shape}")
            # Dense [in, out] → [out, in]; Conv [w, in, out] → [out, in, w]
            # (a copy: a [in, 1] kernel's transpose is a read-only view)
            out[".".join(scope + ["weight"])] = torch.from_numpy(
                np.array(arr.T, order="C"))
        elif name in _PLAIN:
            out[".".join(scope + [name])] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"{'/'.join(path)}: unknown param {name!r}")
    for path, leaf in _flatten(cache):
        if path[-1] != _CACHE_LEAF:
            raise ValueError(f"cache/{'/'.join(path)}: unknown entry")
        out[".".join(path)] = _to_torch(np.asarray(leaf))
    return out


def state_dict_to_flax_variables(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict[str, Any]:
    """The port's state_dict → flax variables {"params": ..., and
    "cache": ... when the model has activation caches}, nested dicts of
    numpy."""
    tree: Dict[str, Any] = {"params": {}}
    for key, t in state_dict.items():
        *scope, name = key.split(".")
        if name == _CACHE_LEAF:
            node, arr = tree.setdefault("cache", {}), _to_numpy(t)
        else:
            node, arr = tree["params"], t.detach().cpu().numpy()
            if name == "weight":
                # a Dense or Conv1d weight, its axes reversed
                name, arr = "kernel", np.ascontiguousarray(arr.T)
            elif name not in _PLAIN:
                raise ValueError(f"{key}: unknown param {name!r}")
        for s in scope:
            node = node.setdefault(s, {})
        node[name] = arr
    return tree


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The port's state_dict → a nested flax param dict of numpy (the
    activation caches left out)."""
    return state_dict_to_flax_variables(
        {k: v for k, v in state_dict.items()
         if k.rsplit(".", 1)[-1] != _CACHE_LEAF})["params"]


def flax_param_paths(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """The port's state_dict keyed as the reference's export_bundle keys
    its params: `jax.tree_util.keystr` of each leaf's path in the flax
    tree, e.g. "['encoder']['enc']['agg_0']['self']['kernel']" (Dense
    kernels [in, out])."""
    return {"".join(f"[{k!r}]" for k in path): leaf
            for path, leaf in _flatten(state_dict_to_flax(state_dict))}


def _sharded_entries(model: torch.nn.Module) -> Dict[str, Any]:
    """{state_dict key: RowShard} of the model's row-sharded tensors."""
    from euler_tpu_torch.parallel.placement import row_shard

    out = {}
    for key, t in itertools.chain(model.named_parameters(),
                                  model.named_buffers()):
        info = row_shard(t)
        if info is not None:
            out[key] = info
    return out


def shard_state_dict(state_dict: Mapping[str, torch.Tensor],
                     model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's state_dict for `model` (row-sharded already) from a
    whole one: each row-sharded entry zero-padded to a multiple of its
    axis and cut to this rank's rows; the rest as given."""
    from euler_tpu_torch.parallel.placement import pad_rows

    shards = _sharded_entries(model)
    out = dict(state_dict)
    for key, info in shards.items():
        full = pad_rows(torch.as_tensor(state_dict[key]),
                        info.global_rows // info.rows)
        out[key] = full[info.lo:info.lo + info.rows].clone()
    return out


def gather_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The whole state_dict of a row-sharded model, on the CPU: each
    row-sharded entry all-gathered over its axis, the padding cut off.
    A collective: every rank of each model group calls it."""
    from euler_tpu_torch.parallel import collectives

    shards = _sharded_entries(model)
    out = {}
    for key, t in model.state_dict().items():
        info = shards.get(key)
        if info is not None:
            t = collectives.all_gather(
                t.detach(), info.mesh.group(info.axis))[:info.data_rows]
        out[key] = t.detach().cpu()
    return out
