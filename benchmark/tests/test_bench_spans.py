"""The span reduction (``spans.py``) and the traced run that reads it
(``span_run.py``): on a made-up trace with host and device events, where
every launch, synchronisation, operator and idle second lands; on the tiny
cell's traced CPU run, which rows and metrics it holds; and that
``spans.py`` sees nothing of the port."""

import ast
import os

import pytest

from benchmark import span_run, spans, spec, trace
from conftest import ROOT, TINY_CELL
from test_bench_spec import NAME, UNIT

SEED = 2147483659
MAIN, BG = 11, 12


class _Event:
    def __init__(self, name, a, b, tid=MAIN, cuda=False, annotation=False):
        self._n, self._a, self._b = name, a, b
        self._tid, self._cuda, self._ann = tid, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann

    def device_resource_id(self):
        return self._tid


class _Prof:
    """What ``reduce`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _made_up():
    """A panorama [0, 1000) ns: stitch [10, 990) holds calc_feature
    [20, 500) (holding features.extrema [100, 300)) and blend [600, 980);
    the card runs [150, 250) and [700, 900)."""
    S = spans.PREFIX
    return _Prof([
        _Event(trace.PANORAMA, 0, 1000),
        _Event(S + "stitch", 10, 990),
        _Event(S + "calc_feature", 20, 500),
        _Event(S + "features.extrema", 100, 300),
        _Event(S + "blend", 600, 980),
        # a device-side copy of a range is no device work
        _Event(S + "blend", 600, 980, cuda=True, annotation=True),
        _Event("aten::add", 30, 60),
        _Event("aten::empty", 35, 40),            # nested: not top level
        _Event("cudaLaunchKernel", 45, 50),
        _Event("aten::sum", 110, 140),
        _Event("cudaLaunchKernel", 120, 125),
        _Event("cudaLaunchKernelExC", 130, 135),
        _Event("cudaStreamSynchronize", 200, 260),
        _Event("cudaDeviceSynchronize", 480, 495),   # calc_feature closes
        _Event("cudaLaunchKernel", 650, 655),
        _Event("cudaMemcpyAsync", 660, 670),         # no sync
        _Event("cudaLaunchKernel", 5, 8),            # before the stitch
        _Event("cudaLaunchKernel", 400, 405, tid=BG),
        _Event("kernel_a", 150, 250, cuda=True),
        _Event("kernel_b", 700, 900, cuda=True),
    ])


def test_reduce_attributes_each_event():
    rows = spans.reduce(_made_up())
    st, cf, ex, bl = (rows[n] for n in ("stitch", "calc_feature",
                                        "features.extrema", "blend"))
    assert (st["count"], cf["count"], ex["count"]) == (1, 1, 1)
    assert cf["incl_s"] == pytest.approx(480e-9)
    assert cf["self_s"] == pytest.approx(280e-9)
    assert st["self_s"] == pytest.approx((980 - 480 - 380) * 1e-9)
    # launches where the host issued them; own and with the nested spans
    assert (cf["launches"], ex["launches"], bl["launches"]) == (1, 2, 1)
    assert cf["launches_incl"] == 3 and st["launches_incl"] == 4
    assert rows[spans.UNSPANNED]["launches"] == 1
    assert rows[spans.OTHER]["launches"] == 1
    assert (cf["syncs"], ex["syncs"], bl["syncs"]) == (1, 1, 0)
    assert cf["syncs_incl"] == 2
    assert ex["sync_s"] == pytest.approx(60e-9)
    assert cf["close_syncs"] == 1 and ex["close_syncs"] == 0
    assert cf["close_sync_s"] == pytest.approx(15e-9)
    assert (cf["ops"], ex["ops"]) == (1, 1) and cf["ops_incl"] == 2
    # the card's busy and idle time by the innermost span open
    assert ex["busy_s"] == pytest.approx(100e-9)
    assert bl["busy_s"] == pytest.approx(200e-9)
    assert ex["idle_s"] == pytest.approx(100e-9)      # [100, 150), [250, 300)
    assert cf["idle_s"] == pytest.approx(280e-9)      # [20, 100), [300, 500)
    assert st["idle_s"] == pytest.approx(120e-9)
    assert bl["idle_s"] == pytest.approx(180e-9)
    assert rows[spans.UNSPANNED]["idle_s"] == pytest.approx(20e-9)
    assert sum(r["idle_s"] for r in rows.values()) == pytest.approx(700e-9)
    assert sum(r["busy_s"] for r in rows.values()) == pytest.approx(300e-9)
    assert spans.metric(rows, "features.launches_per_pano") == 3
    assert spans.metric(rows, "features.syncs_per_pano") == 2
    assert spans.metric(rows, "match.launches_per_pano") is None
    assert "features.extrema" in spans.table(rows)


def test_reduce_without_spans_is_empty():
    prof = _Prof([_Event(trace.PANORAMA, 0, 10),
                  _Event("kernel_a", 1, 2, cuda=True)])
    assert spans.reduce(prof) == {}
    assert all(spans.metric({}, m) is None for m in spans.METRICS)


def test_entries_keep_the_format():
    for m in spans.entries(["a.b"]):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] == "program_span" and m["moves"] == "pano_s"
        assert m["workloads"] == ["a.b"]


@pytest.fixture(scope="module")
def traced(tiny_root):
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    return span_run.traced(cell, SEED, 0.1, device="cpu",
                           log=lambda m: None)


def test_traced_cpu_run_holds_the_spans(traced):
    result, rows = traced
    assert result["correct"] is True, result["compared"]
    for name in ("stitch", "calc_feature", "features.pyramid",
                 "features.extrema", "features.descriptor", "kernel.k2",
                 "ransac.draws", "ransac.fit", "ransac.score",
                 "ransac.gates", "cameras.lm_iter", "blend.render"):
        assert rows[name]["count"] > 0, name
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU launches nothing on a card and waits for none
    got = result["metrics"]
    assert got["cameras.lm_ops_per_iter"]["value"] > 0
    for name in ("features.launches_per_pano", "features.syncs_per_pano",
                 "match.launches_per_pano", "match.syncs_per_pano"):
        assert name not in got
        assert spans.metric(rows, name) is None


def test_spans_imports_nothing_of_the_port():
    tree = ast.parse(open(os.path.join(ROOT, "benchmark",
                                       "spans.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "openpano_torch" not in names and "jax" not in names
