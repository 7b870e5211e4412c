"""Optimizer factory (counterpart of euler_tpu/utils/optimizers.py:11-31).

`get(name, params, learning_rate, **kw)` builds a torch.optim.Optimizer
that takes the same steps as the optax transformation the reference
builds under that name, with optax's defaults:

    sgd       p -= lr·g                                  (torch SGD)
    momentum  t = g + m·t;  p -= lr·t,  m = 0.9          (torch SGD)
    adam      optax.adam, b1 0.9, b2 0.999, eps 1e-8      (torch Adam)
    adamw     adam + decoupled decay lr·wd·p, wd 1e-4     (torch AdamW)
    adagrad   s = g² + s (s₀ = 0.1);
              p -= lr·g·(s > 0 ? rsqrt(s + 1e-7) : 0)     (Adagrad here)
    rmsprop   ν = 0.9·ν + 0.1·g² (ν₀ = 0);
              p -= lr·g·rsqrt(ν + 1e-8)                  (RMSprop here)

weight_decay > 0 turns adam into adamw, as the reference does, and is
refused for the other names. torch's Adagrad (accumulator 0, eps
outside the square root) and RMSprop (alpha 0.99, g/(√ν + eps)) take
other steps, so those two are written here.

Every optimizer built here keeps its state on the parameters' device
and honours the GradScaler protocol's `found_inf` attribute: a [] float
tensor that, when 1, leaves the parameters and the whole optimizer
state (step counts and moments included) as they were — optax's state
under a skipped update. Nothing reads the flag on the host. torch's
fused Adam, AdamW and SGD do this themselves (the momentum buffer is
made at construction, as optax's trace starts at zero, so that a
skipped first step has a buffer to keep); Adagrad and RMSprop here do
it with torch.where.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["get", "Adagrad", "RMSprop"]


class _ElementwiseOptimizer(torch.optim.Optimizer):
    """A per-element update with one accumulator per param, made at
    construction (optax inits its state eagerly) from the group entry
    named by `_init_key`. Subclasses give the update."""

    _init_key: str

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["acc"] = torch.full_like(
                    p, group[self._init_key])

    def _update(self, group, grad, acc):
        """(new accumulator, step direction) for one param; the param
        moves by -lr·direction."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        skip = getattr(self, "found_inf", None)
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                acc = self.state[p]["acc"]
                new_acc, direction = self._update(group, p.grad, acc)
                new_p = p - group["lr"] * direction
                if skip is not None:
                    keep = skip.to(p.device) != 0
                    new_acc = torch.where(keep, acc, new_acc)
                    new_p = torch.where(keep, p, new_p)
                acc.copy_(new_acc)
                p.copy_(new_p)
        return loss


class Adagrad(_ElementwiseOptimizer):
    """optax.adagrad: s = g² + s from s₀ = initial_accumulator_value;
    direction g·rsqrt(s + eps) where s > 0, else 0."""

    _init_key = "initial_accumulator_value"

    def __init__(self, params, lr: float = 0.01,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    def _update(self, group, grad, acc):
        s = grad * grad + acc
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                          torch.zeros_like(s))
        return s, inv * grad


class RMSprop(_ElementwiseOptimizer):
    """optax.rmsprop with its defaults (eps_in_sqrt, not centered, no
    momentum, no bias correction): ν = decay·ν + (1-decay)·g² from
    ν₀ = initial_scale; direction g·rsqrt(ν + eps)."""

    _init_key = "initial_scale"

    def __init__(self, params, lr: float = 0.01, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale))

    def _update(self, group, grad, acc):
        d = group["decay"]
        nu = (1 - d) * (grad * grad) + d * acc
        return nu, torch.rsqrt(nu + group["eps"]) * grad


def _momentum_sgd(params, lr: float, momentum: float) -> torch.optim.SGD:
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum, fused=True)
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return opt


def get(name: str, params: Iterable[torch.nn.Parameter],
        learning_rate: float = 0.01, **kw) -> torch.optim.Optimizer:
    """The optimizer the reference's `get(name, learning_rate, **kw)`
    names, over `params`. kw: weight_decay (adam/adamw), b1, b2, eps
    (adam/adamw), momentum (momentum), initial_accumulator_value, eps
    (adagrad), decay, eps (rmsprop)."""
    params = list(params)
    name = name.lower()
    weight_decay = kw.pop("weight_decay", 0.0)
    if weight_decay and name in ("adam", "adamw"):
        name = "adamw"
    elif weight_decay:
        raise ValueError(
            f"weight_decay is only supported with adam/adamw, got {name!r}")
    elif name == "adamw":
        weight_decay = 1e-4  # optax.adamw's default
    if name in ("adam", "adamw"):
        betas = (kw.pop("b1", 0.9), kw.pop("b2", 0.999))
        eps = kw.pop("eps", 1e-8)
        if kw:
            raise TypeError(f"unsupported {name} options {sorted(kw)}")
        if name == "adam":
            return torch.optim.Adam(params, lr=learning_rate, betas=betas,
                                    eps=eps, fused=True)
        return torch.optim.AdamW(params, lr=learning_rate, betas=betas,
                                 eps=eps, weight_decay=weight_decay,
                                 fused=True)
    if name == "sgd":
        if kw:
            raise TypeError(f"unsupported sgd options {sorted(kw)}")
        return torch.optim.SGD(params, lr=learning_rate, fused=True)
    if name == "momentum":
        momentum = kw.pop("momentum", 0.9)
        if kw:
            raise TypeError(f"unsupported momentum options {sorted(kw)}")
        return _momentum_sgd(params, learning_rate, momentum)
    if name == "adagrad":
        return Adagrad(params, lr=learning_rate, **kw)
    if name == "rmsprop":
        return RMSprop(params, lr=learning_rate, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
