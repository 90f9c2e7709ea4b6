"""A multiband cell at a size the CPU holds: added only as files (its
configuration naming ``reference_multiband``, traffic and limits) and
entries, it runs correct and reads the multiband metrics; its bfloat16
control and two faults planted in the port's multiband blend fail
``canvas_bad``."""

import contextlib
import dataclasses
import json
import os
import shutil

import pytest

from benchmark import calibrate, harness, spec, workmodel_multiband
from conftest import ROOT, TINY_CONFIG, TINY_LIMITS, TINY_TRAFFIC

SEED = 2147483673           # compares panoramas 0 and 1
MB_CELL = "tiny_multiband.tiny"
MB_CONFIG = {**TINY_CONFIG, "name": "tiny_multiband",
             "program": {**TINY_CONFIG["program"], "MULTIBAND": 5},
             "reference": "reference_multiband"}
# the tiny cell's canvas_bad on the CPU: sound runs 0-2.5e-6 over seeds
# 11, 12, 13 and 2^31 + 25 to 28, the bfloat16 control 0.52-0.53, the
# faults below 0.15-0.18 (seam) and 0.98 (last level): the tiny linear
# cell's limits hold
MB_LIMITS = dict(TINY_LIMITS)


@pytest.fixture(scope="module")
def mb_root(tmp_path_factory):
    """A checkout-like root: the real benchmark's data files, plus a tiny
    multiband cell added only as files and entries."""
    root = tmp_path_factory.mktemp("bench_mb_root")
    bdir = root / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), bdir / sub)
    (bdir / "configs" / "tiny_multiband.json").write_text(
        json.dumps(MB_CONFIG))
    (bdir / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (bdir / "limits" / f"{MB_CELL}.json").write_text(json.dumps(MB_LIMITS))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_multiband", "source": "test",
                             "file": "benchmark/configs/tiny_multiband.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": MB_CELL, "config": "tiny_multiband",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(MB_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def cell(mb_root):
    return spec.load(MB_CELL, root=str(mb_root))


def test_multiband_cell_runs_correct_and_reads_its_metrics(cell):
    assert cell.config["program"]["MULTIBAND"] == 5
    r = harness.run(cell, SEED, 0.1, True, device="cpu", log=lambda m: None)
    assert r["correct"] is True, json.dumps(r["compared"])
    assert r["compared"]["canvas_bad"]["value"] <= MB_LIMITS["canvas_bad"]
    for name in ("multiband.first_level_s_per_pano",
                 "multiband.levels_s_per_pano"):
        assert r["metrics"][name]["value"] > 0, name
    # the card's busy time is read from a device trace only
    assert "multiband.device_s_per_pano" not in r["metrics"]


def test_control_fails_canvas_bad(cell):
    only = dataclasses.replace(cell, limits={"canvas_bad":
                                             MB_LIMITS["canvas_bad"]})
    rows = calibrate.readings(only, SEED + 1, 1, [], "cpu")
    assert rows[0]["program"]["canvas_bad"] <= MB_LIMITS["canvas_bad"]
    assert rows[0]["control"]["canvas_bad"] > MB_LIMITS["canvas_bad"]


@contextlib.contextmanager
def _patched(name, make):
    from openpano_torch.stitch import multiband

    orig = getattr(multiband, name)
    setattr(multiband, name, make(orig))
    try:
        yield
    finally:
        setattr(multiband, name, orig)


def seam_left_as_tent():
    """The seam keeps the first level's tent weights (``_winner_take_all``
    returns its input)."""
    return _patched("_winner_take_all", lambda orig: lambda planes, *a: planes)


def last_level_dropped():
    """The last level (the coarsest band, cur * w) adds nothing."""
    def make(orig):
        def run(cur, nxt, valid, ranges, target, visited, out_h, out_w,
                is_last):
            if is_last:
                return target, visited
            return orig(cur, nxt, valid, ranges, target, visited, out_h,
                        out_w, is_last)
        return run
    return _patched("_accumulate_level", make)


@pytest.mark.parametrize("fault", [seam_left_as_tent, last_level_dropped])
def test_fault_fails_canvas_bad(cell, fault):
    with fault():
        r = harness.run(cell, SEED, 0.1, False, device="cpu",
                        log=lambda m: None)
    assert r["correct"] is False
    got = r["compared"]["canvas_bad"]
    assert got["value"] > got["limit"], (fault.__name__, got)


def test_work_model_counts_by_hand():
    # one 10 x 20 box, a 30 x 40 canvas, one 8 x 16 view; sigma 4 at
    # window factor 6 has 13 taps
    px, canvas, views = 200, 1200, 8 * 16 * 3
    assert workmodel_multiband.taps(4.0, 6) == 13
    nbytes, ops = workmodel_multiband.multiband_work(
        (1, 8, 16), [[5, 5, 25, 15]], 1, (30, 40))
    # the first level written, the last level's cur read, the canvas sums
    # read and written, the u8 canvas and mask written
    assert nbytes == views + px * 16 + px * 16 + 2 * canvas * 16 + canvas * 4
    nbytes2, ops2 = workmodel_multiband.multiband_work(
        (1, 8, 16), [[5, 5, 25, 15]], 2, (30, 40))
    # one more level: a blur (read and write) and an accumulation reading
    # cur and next, and the canvas sums once more
    assert nbytes2 - nbytes == 2 * px * 16 + 2 * px * 16 + 2 * canvas * 16
    assert ops2 - ops == (px * 4 * 2 * 2 * 13 + px * 11 + canvas * 7)
