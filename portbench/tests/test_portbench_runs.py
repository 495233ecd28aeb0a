"""Each cell's driver runs end to end on the CPU at a tiny size through
the program's plain versions, and comes out correct; with the timed path
broken underneath (a step that returns its state unchanged, half of each
minibatch left out, the update's products in bf16) the same run comes out
not correct, as does the reference one precision down in the program's
place; and run.py refuses to report anything without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = sorted(tiny.SIZES)


def _execute(root: str, cell: str, seed: int = 3_000_000_019):
    sys.path.insert(0, os.path.join(harness.ROOT, "portbench"))
    import run as bench_run

    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                            "--trace", "0"])
    line, lines, code = bench_run.execute(args, "cpu", root=root)
    return json.loads(line), lines, code


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(root, cell):
    out, lines, code = _execute(root, cell)
    assert code == 0 and out["correct"], lines
    want = {m["name"] for m in harness.find_cell(cell, root).end_to_end}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] >= 1 and out["failed"] == 0
    limits = harness.find_cell(cell, root).traffic["limits"]
    assert list(out)[-1] == "checks" and len(lines) == len(out["checks"]) == len(limits)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_step_is_not_correct(root, cell, fault):
    driver = harness.find_cell(cell, root).driver
    with (harness.unchanged_state() if fault == "unchanged_state" else driver.half_batch()):
        out, lines, code = _execute(root, cell)
    assert code == 0 and not out["correct"], lines


def test_the_update_in_bf16_is_not_correct(root):
    """Kernel B2's products in bf16 (the program's own lower-precision path)
    leave the rollout as it was; ``update_gap`` sees the update."""
    cell = "hover_fused_8192x256"
    with harness.find_cell(cell, root).driver.bf16_update():
        out, lines, code = _execute(root, cell)
    assert code == 0 and not out["correct"], lines
    gap = out["checks"]["update_gap"]
    assert gap["value"] > gap["limit"]
    assert out["checks"]["state_gap"]["value"] <= out["checks"]["state_gap"]["limit"]


CARD = "cuda" if torch.cuda.is_available() else "cpu"
TF32_ON_THE_CARD = [pytest.mark.cuda, pytest.mark.skipif(
    CARD == "cpu", reason="the TF32 control needs the card: the CPU multiplies float32 in full")]


@pytest.mark.parametrize("cell", [pytest.param(c, marks=TF32_ON_THE_CARD)
                                  if c.startswith("hover") else c for c in CELLS])
def test_the_control_is_not_correct(root, cell):
    """The reference one precision down (TF32 for the float32 hover cells,
    float8 operands for the bf16 CNN), judged in the program's place."""
    sys.path.insert(0, os.path.join(harness.ROOT, "portbench"))
    import run as bench_run

    from portbench import compare

    c = harness.find_cell(cell, root)
    run = harness.Run(3_000_000_023, c.config, c.traffic, torch.device(CARD), root)
    found = bench_run.gaps(c, run, c.driver.reference(run, control=True), c.driver.reference(run))
    correct, checks = compare.judge(found, c.traffic["limits"])
    assert not correct, checks


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"), "--workload",
         "hover_fused_8192x256", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_run_refuses_an_unknown_cell():
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"), "--workload",
         "no_such_cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
