"""run.py as the driver runs it, on a card, at the tiny cells' size: the
K-step CUDA graph, gather_mean's kernel and the profiler's trace. Run on
the card with `python -m pytest gnnbench/tests -m cuda`."""

import json
import subprocess
import sys

import pytest

import tiny_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tiny_root.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_run_py_on_the_card(tmp_path, card, cell, trace):
    root = tiny_root.make_root(tmp_path)
    proc = subprocess.run(
        [sys.executable, "gnnbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "2", "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=900,
        env={**__import__("os").environ, "PYTHONPATH": str(tiny_root.REPO)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert proc.stderr.rstrip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "device_idle_share" in res["metrics"]
        assert "gather_mean_roofline" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"train_roots_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["graphsage_products.uniform",
                                  "unsup_sage_products.uniform"])
def test_the_control_reads_incorrect_at_the_cells_size(card, cell):
    """A run of the cell beside the reference in TF32 and the planted
    faults, each put in the program's place on the cell's own inputs and
    sizes: the run passes the cell's limits, each of the others fails
    them (control.py; one seed, the readings of the limits take more)."""
    from gnnbench.control import readings

    rows = readings(tiny_root.REPO, cell, 2 ** 31 + 21)
    assert [v for v, _, _ in rows] == ["program", "tf32", "half_batch",
                                       "altered_picks"]
    assert all(fails == (v != "program") for v, _, fails in rows), rows


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["stale_inputs", "frozen_seed"])
def test_a_fault_in_the_replay_reads_incorrect(tmp_path, card, fault):
    """The K-step graph's replay broken underneath a run of the tiny
    supervised cell: its static inputs never refreshed, or its sampling
    generators never seeded again; the run reads incorrect."""
    code = tiny_root.run_cell_code(
        "tiny_sage.uniform", 2 ** 31 + 23,
        plant=f"from gnnbench.control import plant\nplant({fault!r})")
    out = tiny_root.run_in(tiny_root.make_root(tmp_path), code.replace(
        "device='cpu'", "device='cuda'"))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"] is False, res["checks"]
