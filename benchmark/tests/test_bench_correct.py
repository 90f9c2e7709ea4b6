"""The comparison that decides ``correct`` comes out false under the
control and under each fault the cells can have, at a size the CPU holds:
a run with the timed path broken underneath (``faults.py``), and the
control's readings (``calibrate.py``) against the cell's limits."""

import pytest

from benchmark import calibrate, faults, harness, spec
from conftest import TINY_CELL, TINY_LIMITS

SEED = 2147483673           # compares panoramas 0 and 1


@pytest.mark.parametrize("fault,number", [
    ("lm_unchanged", "truth_px"),       # a step returns its state unchanged
    ("blend_unchanged", "canvas_bad"),  # the same, in the blend
    ("half_batch", "canvas_bad"),       # half the images, mean over the rest
    ("canvas_altered", "canvas_bad"),   # an answer altered where produced
    ("desc_altered", "desc_miss"),      # the answers of a stage altered
    ("desc_rotated", "desc_miss"),      # K2's bins turned an eighth
    ("kp_scaled", "truth_px"),
])
def test_fault_makes_the_run_incorrect(tiny_root, fault, number):
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    with faults.FAULTS[fault]():
        r = harness.run(cell, SEED, 0.1, False, device="cpu",
                        log=lambda m: None)
    assert r["correct"] is False
    got = r["compared"][number]
    assert got["value"] > got["limit"], (fault, got)


def test_control_fails_and_program_passes(tiny_root):
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    rows = calibrate.readings(cell, SEED + 1, 1, [], "cpu")
    program, control = rows[0]["program"], rows[0]["control"]
    assert all(program[k] <= TINY_LIMITS[k] for k in TINY_LIMITS), program
    failed = [k for k in TINY_LIMITS if control[k] > TINY_LIMITS[k]]
    # at this size the bf16 matcher may move no match; the cells' own
    # readings are in PERF.md
    assert {"kp_diff", "kp_offset", "ori_miss", "desc_miss", "refit_px",
            "canvas_bad"} <= set(failed), control
