"""The harness on the CPU at a tiny size: a cell and a metric added only
as files are found and run, the result line's shape, the exit without a
card, and the import boundaries."""

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, spec
from conftest import ROOT, TINY_CELL

SEED = 2147483653   # compares panoramas 2 and 3: 0 is clean, 1 traced

DUMMY_METRIC = '''"""The traced panorama's wall seconds (a test's metric)."""


def read(run):
    return run.profile["wall_s"] if run.profile else None
'''


@pytest.fixture(scope="module")
def traced(tiny_root):
    """A traced tiny run with a dummy per-layer metric added as a file."""
    (tiny_root / "benchmark" / "metrics" / "dummy.traced_wall_s.py"
     ).write_text(DUMMY_METRIC)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "dummy.traced_wall_s", "unit": "s", "better": "lower",
        "source": "program_counter", "layer": "device", "moves": "pano_s",
        "workloads": [TINY_CELL]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    return cell, harness.run(cell, SEED, 0.1, True, device="cpu",
                             log=lambda m: None)


def test_files_added_cell_and_metric_found(traced):
    cell, result = traced
    assert cell.traffic["params"]["n"] == 4
    assert cell.config["name"] == "tiny_camera"
    names = [m["name"] for m in cell.per_layer]
    assert "dummy.traced_wall_s" in names
    assert result["metrics"]["dummy.traced_wall_s"]["value"] > 0


def test_traced_line_shape(traced):
    _, r = traced
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["count"] == 1
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the stage metrics read the port's timers; the device ones need a card
    assert r["metrics"]["features.s_per_pano"]["value"] > 0
    assert "device.idle_share" not in r["metrics"]
    json.dumps(r)


def test_untraced_line_has_end_to_end_metrics(tiny_root):
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    r = harness.run(cell, 2147483666, 0.1, False, device="cpu",
                    log=lambda m: None)
    assert set(r["metrics"]) == {"pano_s", "peak_device_gib", "setup_s"}
    assert r["metrics"]["pano_s"]["value"] > 0
    assert r["correct"] is True, json.dumps(r["compared"])
    assert set(r["compared"]) == set(cell.limits)
    assert not harness.forbidden_modules()


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "camera_linear.ordered13", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_only_its_own_files_runs_nothing(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone (no port)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "camera_linear.ordered13", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    here = os.path.join(ROOT, "benchmark")
    for d, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), here), \
                    os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for rel, path in _sources():
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, (rel, bad)


# the reference, the generators and the yardsticks see nothing of the port
PLAIN = ("reference.py", "reference_multiband.py", "reference_cylinder.py",
         "sift_ref.py", "judge.py", "scenes.py", "workmodel.py", "trace.py",
         "spec.py")


def test_reference_imports_nothing_of_the_port():
    for rel, path in _sources():
        if rel in PLAIN or rel.startswith("generators") \
                or rel.startswith("metrics"):
            assert "openpano_torch" not in _imports(path), rel


def test_top_level_names_compared_whole():
    import types

    sys.modules["openpano_tpu_like"] = types.ModuleType("openpano_tpu_like")
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["openpano_tpu_like"]
