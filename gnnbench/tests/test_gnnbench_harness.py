"""The harness: found by files alone, loads nothing of JAX, and reads
`correct` false under each fault a training cell can have and under the
control."""

import hashlib
import json
import math
from pathlib import Path

import pytest

import tiny_root

SEED = 2 ** 31 + 11


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_a_configuration_and_a_metric_are_added_as_files(tmp_path):
    root = tiny_root.make_root(tmp_path)
    before = _digests(root / "gnnbench")
    g = root / "gnnbench"
    cfg = json.loads((g / "configs" / "tiny_sage.json").read_text())
    cfg["model"]["dim"] = 6
    (g / "configs" / "tiny_sage_narrow.json").write_text(json.dumps(cfg))
    wl = json.loads((g / "workloads" / "tiny_sage.uniform.json").read_text())
    wl["batch_size"] = 32
    (g / "workloads" / "tiny_sage_narrow.small.json").write_text(
        json.dumps(wl))
    (g / "metrics" / "steps_in_window.py").write_text(
        "def read(rec):\n    return float(rec['window_steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_sage_narrow", "source": "tests",
                             "file": "gnnbench/configs/tiny_sage_narrow.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny_sage_narrow.small",
                               "config": "tiny_sage_narrow",
                               "traffic": "small", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "estimator",
                               "moves": "train_roots_per_s",
                               "workloads": ["tiny_sage_narrow.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny_root.run_in(root, tiny_root.run_cell_code(
        "tiny_sage_narrow.small", SEED, trace=1))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"], res["checks"]
    assert res["metrics"]["steps_in_window"]["value"] == res["attempted"]
    assert "capture_s" not in res["metrics"]
    after = _digests(root / "gnnbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert (tiny_root.REPO / "gnnbench" / "run.py").read_bytes() == \
        (root / "gnnbench" / "run.py").read_bytes()


def test_the_harness_loads_nothing_of_jax(tmp_path):
    root = tiny_root.make_root(tmp_path)
    out = tiny_root.run_in(root, tiny_root.run_cell_code(
        "tiny_unsup.uniform", SEED))
    assert json.loads(out.splitlines()[-1]) == []
    # the names are compared whole: the port's euler_tpu_torch is not
    # the JAX package euler_tpu
    code = """
import json, sys
import euler_tpu_torch.models.graphsage
from gnnbench import run
sys.modules['jax.numpy'] = sys.modules['json']
print(json.dumps(run.forbidden_modules()))
"""
    assert json.loads(tiny_root.run_in(root, code).splitlines()[-1]) == \
        ["jax"]


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    root = tiny_root.make_root(tmp_path)
    code = """
import json, sys
import gnnbench.reference.common, gnnbench.reference.graphsage
import gnnbench.reference.unsup_sage
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}
                        & {'euler_tpu_torch', 'euler_tpu', 'jax', 'flax'})))
"""
    assert json.loads(tiny_root.run_in(root, code).splitlines()[-1]) == []


FAULTS = {
    # a step that returns its state unchanged
    "unchanged_state": "import torch\n"
                       "torch.optim.Adam.step = lambda self, closure=None: None",
    # half of the batch left out, the mean taken over the rest
    "half_batch": "from euler_tpu_torch.utils import metrics as M\n"
                  "M.masked_mean = lambda x, mask: x[: x.shape[0] // 2].mean()",
    # an answer altered where it is produced: every pick moved one on
    "altered_picks": "import torch\n"
                     "from euler_tpu_torch.parallel import device_sampler as S\n"
                     "_pick = S._pick_cols\n"
                     "S._pick_cols = lambda r, c: torch.roll(_pick(r, c), 1, 0)",
}


@pytest.mark.parametrize("cell", sorted(tiny_root.CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_reads_incorrect(tmp_path, cell, fault):
    root = tiny_root.make_root(tmp_path)
    out = tiny_root.run_in(root, tiny_root.run_cell_code(
        cell, SEED, plant=FAULTS[fault]))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny_root.CELLS))
def test_the_planted_faults_of_the_limits_read_incorrect(tmp_path, cell):
    """control.py's faults, planted in the reference put in the program's
    place, fail the limits, and the program's own run beside them does
    not; its TF32 control and the faults of the K-step graph's replay
    are test_gnnbench_card's (both are the card's)."""
    root = tiny_root.make_root(tmp_path)
    code = f"""
import json
from pathlib import Path
from gnnbench.control import VARIANTS, readings
faults = [v for v in VARIANTS if v[1]]
print(json.dumps([[v, n, f] for s in (1, 2, 3) for v, n, f in
                  readings(Path('.'), {cell!r}, s, 'cpu', faults, 0.3)]))
"""
    rows = json.loads(tiny_root.run_in(root, code).splitlines()[-1])
    assert [v for v, _, _ in rows] == ["program", "half_batch",
                                       "altered_picks"] * 3
    assert all(fails == (v != "program") for v, _, fails in rows), rows


def test_a_state_left_unchanged_reads_one():
    from gnnbench import training

    ref = {"losses": [2.0, 1.9, 1.8],
           "g1": {"a": 3.0, "b": 1.0, "c": 1e-9},
           "moment": {"a": 0.3, "b": 0.1, "c": 1e-10},
           "dp": {"a": 0.03, "b": 0.02, "c": 1e-7}}
    prog = {"losses": [2.0, 2.0, 2.0], "picks_mismatch": 0,
            "moment": {k: 0.0 for k in ref["moment"]},
            "dp": {k: 0.0 for k in ref["dp"]}}
    n = training.numbers(prog, ref)
    assert n["moment_gap"] == 1.0 and n["change_gap"] == 1.0
    assert n["loss_gap_first"] == 0.0
    assert math.isclose(n["loss_gap"], 0.2 / 1.8)
