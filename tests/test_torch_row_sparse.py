"""Row-sparse table gradients under the port's optimizers, on the CPU.

utils/layers.Embedding hands a CUDA table a sparse COO gradient (the ids
looked up and their rows); here F.embedding(sparse=True) makes the same
gradient on the CPU. Adam and AdamW step it with ops/row_sparse_adam.py
(the plain PyTorch version here, the kernel on the card): dense Adam over
every row. It is held to torch's Adam on the dense gradient. The betas,
lr and eps are exact in float32, so the float32 arithmetic of torch's
fused CUDA kernel, which the plain version follows, and the float64
scalars of torch's CPU Adam differ by rounding alone.
"""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import copy
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from euler_tpu_torch.ops.row_sparse_adam import densify
from euler_tpu_torch.parallel.train import spmd_update
from euler_tpu_torch.utils import optimizers as opt

N, D = 50, 8
LR, BETAS, EPS = 2 ** -7, (0.875, 1 - 2 ** -9), 2 ** -27
WD = 2 ** -6


def _backward(table, gen, nan_row=False):
    """One step's gradient of `table`: two lookups of 30 ids each (id 3
    five times in the first), so autograd adds two row-sparse
    gradients. nan_row: the gradient of one looked-up row is NaN while
    the loss stays finite."""
    table.grad = None
    loss = 0
    for i in range(2):
        ids = torch.randint(0, N, (30,), generator=gen)
        if i == 0:
            ids[:5] = 3
        emb = F.embedding(ids, table, sparse=True)
        if nan_row and i == 0:
            emb.register_hook(lambda g: g.index_fill(0, torch.tensor([7]),
                                                     float("nan")))
        loss = loss + (emb * torch.randn(30, D, generator=gen)).sum()
    loss.backward()
    assert table.grad.is_sparse
    return loss


def _table():
    return torch.rand(N, D, generator=torch.Generator().manual_seed(1)) / 20


def _sparse_opt(case, table):
    if case == "adam_l2":
        return opt.Adam([table], lr=LR, betas=BETAS, eps=EPS,
                        weight_decay=WD, fused=True, capturable=True)
    return opt.get("adamw" if case == "adamw" else "adam", [table], LR,
                   b1=BETAS[0], b2=BETAS[1], eps=EPS,
                   **({"weight_decay": WD} if case == "adamw" else {}))


def _run(o, table, gen, steps):
    for _ in range(steps):
        _backward(table, gen)
        o.step()


def _state(o, p):
    return {k: v.clone() for k, v in o.state[p].items()}


@pytest.mark.parametrize("case", ["adam", "adamw", "adam_l2", "found_inf",
                                  "restart", "state_dict", "hooks"])
def test_row_sparse_adam_takes_the_dense_step(case):
    """adam / adamw / adam_l2: 8 steps from a row-sparse gradient with
    repeated ids against torch's Adam, AdamW or Adam with an L2 term on
    the dense gradient: the table within 3e-5 of lr (a row moves about
    lr a step), the moments within 1e-5 relative or 1e-6 of their
    largest value (fma against separate roundings), the step count
    exact; every row moved, touched or not. found_inf: a step with the
    flag at 1 (a NaN gradient row) leaves the table, both moments and
    the step exactly as they were. restart: the state zeroed in place
    (as the benchmark restarts a captured graph) and the table restored
    train exactly as a fresh optimizer. state_dict: a state saved and
    loaded into a new optimizer steps on exactly as the old one. hooks:
    a step's pre- and post-hooks run once a step, with torch's own Adam
    built first (so its step wears torch's hook wrapper too)."""
    gen = torch.Generator().manual_seed(0)
    table = torch.nn.Parameter(_table())
    if case == "hooks":
        torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))])
        assert getattr(torch.optim.Adam.step, "hooked", False)
    o = _sparse_opt(case, table)
    if case == "hooks":
        calls = []
        o.register_step_pre_hook(lambda *a: calls.append("pre"))
        o.register_step_post_hook(lambda *a: calls.append("post"))
        _run(o, table, gen, 2)
        assert calls == ["pre", "post"] * 2
        return
    if case in ("adam", "adamw", "adam_l2"):
        dense = torch.nn.Parameter(_table())
        cls = torch.optim.AdamW if case == "adamw" else torch.optim.Adam
        ref = cls([dense], lr=LR, betas=BETAS, eps=EPS,
                  weight_decay=0.0 if case == "adam" else WD)
        for _ in range(8):
            _backward(table, gen)
            dense.grad = densify(table.grad)
            o.step()
            ref.step()
        assert (table.detach() != _table()).all()
        torch.testing.assert_close(table.detach(), dense.detach(), rtol=0,
                                   atol=3e-5 * LR)
        got, want = o.state[table], ref.state[dense]
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(
                got[k], want[k], rtol=1e-5,
                atol=1e-6 * float(want[k].abs().max()))
        assert float(got["step"]) == float(want["step"]) == 8.0
        return
    _run(o, table, gen, 3)
    if case == "found_inf":
        before, kept = table.detach().clone(), _state(o, table)
        _backward(table, gen, nan_row=True)
        assert torch.isnan(table.grad._values()).any()
        o.found_inf = torch.tensor(1.0)
        o.step()
        assert torch.equal(table.detach(), before)
        for k, v in kept.items():
            assert torch.equal(o.state[table][k], v), k
        return
    if case == "restart":
        with torch.no_grad():
            table.copy_(_table())
            for v in o.state[table].values():
                v.zero_()
        fresh_table = torch.nn.Parameter(_table())
        fresh = _sparse_opt(case, fresh_table)
        runs = [(o, table), (fresh, fresh_table)]
    else:
        other_table = torch.nn.Parameter(table.detach().clone())
        other = _sparse_opt(case, other_table)
        # a checkpoint's copy: load_state_dict keeps the tensors it gets
        other.load_state_dict(copy.deepcopy(o.state_dict()))
        runs = [(o, table), (other, other_table)]
    seeds = gen.initial_seed() + 1
    for oo, t in runs:
        _run(oo, t, torch.Generator().manual_seed(seeds), 5)
    (oa, ta), (ob, tb) = runs
    assert torch.equal(ta.detach(), tb.detach())
    for k, v in oa.state[ta].items():
        assert torch.equal(v, ob.state[tb][k]), k


class _Lookup(torch.nn.Module):
    """A table looked up with a row-sparse gradient (NaN in one looked-up
    row's gradient on demand), for spmd_update."""

    def __init__(self):
        super().__init__()
        self.table = torch.nn.Parameter(_table())

    def forward(self, batch):
        gen = torch.Generator().manual_seed(5)
        table = self.table
        table.grad = None
        emb = F.embedding(batch["ids"], table, sparse=True)
        if batch["nan"]:
            emb.register_hook(lambda g: g.index_fill(
                0, torch.tensor([2]), float("nan")))
        loss = (emb * torch.randn(emb.shape, generator=gen)).sum()
        return SimpleNamespace(loss=loss, metric=loss.detach())


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "rmsprop",
                                  "guard"])
def test_row_sparse_grad_other_optimizers_and_the_guard(name):
    """sgd / momentum / adagrad / rmsprop: 4 steps on a row-sparse
    gradient are exactly the steps on its dense form (the optimizer
    densifies it first). guard: spmd_update's nonfinite guard reads a
    row-sparse gradient's rows: a NaN in one looked-up row's gradient,
    under a finite loss, sets found_inf and Adam leaves the table and its
    state as they were; the same step without the NaN moves the table."""
    if name == "guard":
        model = _Lookup()
        o = opt.get("adam", model.parameters(), LR)
        ids = torch.tensor([2, 9, 2, 40, 2])
        spmd_update(model, o, {"ids": ids, "nan": False}, None)
        before, kept = model.table.detach().clone(), _state(o, model.table)
        _, _, found_inf = spmd_update(model, o, {"ids": ids, "nan": True},
                                      None)
        assert model.table.grad.is_sparse and float(found_inf) == 1.0
        assert torch.equal(model.table.detach(), before)
        for k, v in kept.items():
            assert torch.equal(o.state[model.table][k], v), k
        _, _, found_inf = spmd_update(model, o, {"ids": ids, "nan": False},
                                      None)
        assert float(found_inf) == 0.0
        assert not torch.equal(model.table.detach(), before)
        return
    runs = []
    for sparse in (True, False):
        gen = torch.Generator().manual_seed(0)
        table = torch.nn.Parameter(_table())
        o = opt.get(name, [table], 0.05)
        for _ in range(4):
            _backward(table, gen)
            if not sparse:
                table.grad = densify(table.grad)
            o.step()
        assert not table.grad.is_sparse  # densified in place by step()
        runs.append((table.detach(), o.state_dict()["state"]))
    (ta, sa), (tb, sb) = runs
    assert torch.equal(ta, tb)
    for k, st in sa.items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb[k][key])), key
