"""The port's optimizers against optax, on the CPU: the same params and
grads through each of the reference's optimizer names for 5 updates,
and the skipped update (found_inf) that leaves params and state as they
were."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.utils import optimizers as jax_opt
from euler_tpu_torch.utils import optimizers as opt

SHAPES = [(7, 5), (5,), (3, 4, 2)]
CASES = [("sgd", {}), ("momentum", {}), ("adam", {}), ("adamw", {}),
         ("adam", {"weight_decay": 0.01}), ("adagrad", {}), ("rmsprop", {})]


def _steps(seed=0, n=5):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(n)]
    # a zero and a tiny gradient entry: adagrad's where(s > 0) and the
    # eps placement show there
    grads[0][1][0] = 0.0
    grads[1][1][1] = 1e-6
    return params, grads


def _optax_run(name, kw, params, grads):
    tx = jax_opt.get(name, 0.05, **kw)
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    out = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, p)
        p = optax.apply_updates(p, upd)
        out.append([np.asarray(x) for x in p])
    return out


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{'-wd' if k else ''}" for n, k in CASES])
def test_optimizer_matches_optax(name, kw):
    params, grads = _steps()
    want = _optax_run(name, kw, params, grads)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    o = opt.get(name, ps, 0.05, **dict(kw))
    for step, g in enumerate(grads):
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x.copy())
        o.step()
        for p, w in zip(ps, want[step]):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adagrad", "rmsprop"])
@pytest.mark.parametrize("skip_first", [True, False])
def test_found_inf_skips_the_update_and_keeps_the_state(name, skip_first):
    """optax's state under the reference's nonfinite guard: a skipped
    update changes nothing, so a skip followed by steps equals the same
    steps alone (a skipped first step included)."""
    params, grads = _steps(seed=1, n=3)
    bad = [np.full(s, np.nan, np.float32) for s in SHAPES]
    seq = [bad] + grads if skip_first else grads[:1] + [bad] + grads[1:]
    runs = []
    for sequence, flags in ((grads, [0.0] * 3),
                            (seq, [1.0 if g is bad else 0.0 for g in seq])):
        ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
        o = opt.get(name, ps, 0.05)
        for g, f in zip(sequence, flags):
            for p, x in zip(ps, g):
                p.grad = torch.from_numpy(x.copy())
            o.found_inf = torch.tensor(f)
            o.step()
        runs.append(([p.detach().clone() for p in ps], o.state_dict()))
    (pa, sa), (pb, sb) = runs
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for k, st in sa["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][k][key])), key


def test_unknown_and_refused_options():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get("lamb", p)
    with pytest.raises(ValueError, match="weight_decay"):
        opt.get("sgd", p, weight_decay=0.1)
    assert isinstance(opt.get("adam", p, weight_decay=0.1),
                      torch.optim.AdamW)
    assert opt.get("adamw", p).param_groups[0]["weight_decay"] == 1e-4
