"""The GeniePath family in the harness: a tiny CPU run reads correct and
reports the genie encoder's phases, every fault a training cell can have
reads incorrect, the step's FLOP count matches one made by hand, and on
the card the TF32 control fails the cell's limits."""

import json
import shutil

import pytest

import tiny_root
from test_gnnbench_harness import FAULTS

CELL = "tiny_genie.uniform"
SEED = 2 ** 31 + 17
PHASES = ("genie_gather_ms_per_step", "genie_breadth_ms_per_step",
          "genie_depth_ms_per_step")


def genie_root(tmp_path):
    """tiny_root's checkout with a tiny GeniePath cell beside its cells,
    under the tiny limits (no kernel mean: the model reads none)."""
    root = tiny_root.make_root(tmp_path)
    g = root / "gnnbench"
    shutil.copy(tiny_root.DATA / "tiny_genie.json",
                g / "configs" / "tiny_genie.json")
    wl = json.loads((g / "workloads" / "tiny_sage.uniform.json").read_text())
    wl["limits"].pop("mean_ulp_excess")
    (g / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_genie", "source": "tests",
                             "reduced": [], "why": "tiny",
                             "file": "gnnbench/configs/tiny_genie.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny_genie",
                               "traffic": "uniform", "chips": 1,
                               "why": "tiny"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_is_correct(tmp_path, trace):
    out = tiny_root.run_in(genie_root(tmp_path), tiny_root.run_cell_code(
        CELL, SEED, trace=trace))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"], res["checks"]
    assert res["checks"]["picks_mismatch"]["value"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0
    if trace:
        # on the CPU a phase is the host's clock around synchronous work
        assert all(res["metrics"][m]["value"] > 0 for m in PHASES)
        assert "gather_mean_roofline" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_roots_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_reads_incorrect(tmp_path, fault):
    out = tiny_root.run_in(genie_root(tmp_path), tiny_root.run_cell_code(
        CELL, SEED, plant=FAULTS[fault]))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"] is False, res["checks"]


def test_the_planted_faults_of_the_limits_read_incorrect(tmp_path):
    code = f"""
import json
from pathlib import Path
from gnnbench.control import VARIANTS, readings
faults = [v for v in VARIANTS if v[1]]
print(json.dumps([[v, n, f] for s in (1, 2) for v, n, f in
                  readings(Path('.'), {CELL!r}, s, 'cpu', faults, 0.3)]))
"""
    rows = json.loads(tiny_root.run_in(genie_root(tmp_path), code)
                      .splitlines()[-1])
    assert [v for v, _, _ in rows] == ["program", "half_batch",
                                       "altered_picks"] * 2
    assert all(fails == (v != "program") for v, _, fails in rows), rows


def test_the_step_flops_match_a_hand_count():
    """Batch 2, fanouts [3, 2], features 5 wide, dim 4, 3 classes: hops
    of 2, 6 and 12 rows; depth 0's keys over 2·4 + 6·3 = 26 rows, depth
    1's over 8; 10 pooled rows; 3 depth states."""
    from gnnbench.yardstick.genie_counts import genie_step_flops

    got = genie_step_flops(2, [3, 2], 5, 4, 3)
    want = {
        "projection": 2 * 20 * 5 * 4 * 2,
        "depth0_keys": 2 * 26 * 4 * 4 * 3,
        "deeper_keys": 2 * 8 * 4 * 4 * 3,
        "transforms": 2 * (2 + 6 + 2) * 4 * 4 * 3,
        "depth_fc": 3 * 2 * 2 * 4 * 4 * 3,
        "lstm": 3 * 2 * 2 * 2 * 4 * 16 * 3,
        "head": 2 * 2 * 4 * 3 * 3,
        "pooling": 2 * 2 * (26 + 8) * 4 * 3,
    }
    want["total"] = sum(want.values())
    assert got == want


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_reads_incorrect_at_the_cells_size(card):
    """A run of geniepath_products.uniform beside the reference in TF32
    and the planted faults, each put in the program's place on the
    cell's own inputs and sizes: the run passes the cell's limits, each
    of the others fails at least one (control.py; one seed)."""
    from gnnbench.control import readings

    rows = readings(tiny_root.REPO, "geniepath_products.uniform",
                    2 ** 31 + 29)
    assert [v for v, _, _ in rows] == ["program", "tf32", "half_batch",
                                       "altered_picks"]
    assert all(fails == (v != "program") for v, _, fails in rows), rows
