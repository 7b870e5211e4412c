"""Parameters between the JAX package and the port.

A flax param tree of Dense layers and Embedding tables (as numpy), e.g.
the reference DeviceSampledGraphSage's

    encoder/enc/agg_{d}/{self,nbr}/{kernel,bias},  out/{kernel,bias}

DeviceSampledUnsupervisedSage's encoder/agg_{d}/... and ctx_emb/table,
or DeviceSampledSkipGram's emb/table and ctx/table, maps to the port's
state_dict keys by joining the path with "." and renaming kernel →
weight. Flax kernels are [in, out]; the port's weights are [out, in],
so kernels are transposed both ways. Tables [rows, dim] keep their
layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax params (optionally wrapped as {"params": ...}) → state_dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _flatten(params):
        *scope, name = path
        arr = np.asarray(leaf)
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: only Dense kernels "
                                 f"convert, got shape {arr.shape}")
            out[".".join(scope + ["weight"])] = torch.from_numpy(
                np.ascontiguousarray(arr.T))
        elif name in ("bias", "table"):
            out[".".join(scope + [name])] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"{'/'.join(path)}: unknown param {name!r}")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The port's state_dict → a nested flax param dict of numpy."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *scope, name = key.split(".")
        arr = t.detach().cpu().numpy()
        if name == "weight":
            name, arr = "kernel", np.ascontiguousarray(arr.T)
        elif name not in ("bias", "table"):
            raise ValueError(f"{key}: unknown param {name!r}")
        node = tree
        for s in scope:
            node = node.setdefault(s, {})
        node[name] = arr
    return tree


def flax_param_paths(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """The port's state_dict keyed as the reference's export_bundle keys
    its params: `jax.tree_util.keystr` of each leaf's path in the flax
    tree, e.g. "['encoder']['enc']['agg_0']['self']['kernel']" (Dense
    kernels [in, out])."""
    return {"".join(f"[{k!r}]" for k in path): leaf
            for path, leaf in _flatten(state_dict_to_flax(state_dict))}
