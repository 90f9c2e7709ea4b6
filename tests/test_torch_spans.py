"""The port's trace spans (``utils.timer.span``), on the CPU.

A small default-Config stitch of four u8 views runs twice: once under
``torch.profiler`` (CPU activity) and once with no profiler and
``torch.profiler.record_function`` replaced by a counter.  Traced, it
emits ``openpano:stitch`` with every stage and the named substages nested
inside it on the stitch's thread, and one ``openpano:cameras.lm_iter`` per
LM iteration that ``info_out["lm_iters"]`` counts.  Untraced, no span
enters ``record_function``.  The stage timers (``timer.totals``) count the
same labels and calls either way.  The same views stitched traced with
``MULTIBAND=2`` show the multiband blend's two stage timers and its
per-level blur and accumulation inside ``blend.render``; the linear stitch
shows none of them.
"""

import contextlib

import numpy as np
import pytest
import torch

import openpano_torch
from openpano_torch.config import Config
from openpano_torch.synth import procedural_scene_large, render_views
from openpano_torch.utils import timer

CFG = Config(RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
             MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
             MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
             SIFT_WORKING_SIZE=400)
STAGES = ("calc_feature", "pairwise_match", "match_2nn", "ransac",
          "estimate_camera", "blend")
SUBSTAGES = ("features.encode", "features.upload", "features.resize",
             "features.pyramid", "features.extrema", "features.compact",
             "features.orientation", "features.descriptor", "features.check",
             "kernel.k1", "kernel.k2", "kernel.extrema", "ransac.draws",
             "ransac.fit",
             "ransac.score", "ransac.refit", "ransac.gates", "match.graph",
             "cameras.schedule", "cameras.problem", "cameras.lm_iter",
             "blend.join", "blend.plan", "blend.render", "blend.download")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stitch(views):
    info = {}
    before = timer.totals()
    openpano_torch.stitch_images(views, CFG, output="u8", device="cpu",
                                 info_out=info)
    after = timer.totals()
    calls = {k: after[k][0] - before.get(k, (0, 0.0))[0] for k in after}
    return info, {k: c for k, c in calls.items() if c}


def _views():
    views = render_views(procedural_scene_large(600, 2400, seed=0), 4,
                         out_w=320, out_h=240, hfov_deg=32, overlap=0.5)[0]
    return np.round(np.asarray(views) * 255).astype(np.uint8)


def _events(prof):
    return [(e.name()[len(timer.PREFIX):], e.start_ns(),
             e.start_ns() + e.duration_ns(), e.device_resource_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(timer.PREFIX)]


@pytest.fixture(scope="module")
def runs(_one_thread):
    views = _views()
    entered = []

    def counting(*args, **kwargs):
        entered.append(args)
        return contextlib.nullcontext()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counting)
        plain_info, plain_calls = _stitch(views)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        info, calls = _stitch(views)
    events = _events(prof)
    return dict(entered=entered, plain_info=plain_info,
                plain_calls=plain_calls, info=info, calls=calls,
                events=events)


def test_stitch_span_holds_every_stage_and_substage(runs):
    ev = runs["events"]
    stitch = [e for e in ev if e[0] == "stitch"]
    assert len(stitch) == 1
    _, a, b, tid = stitch[0]
    names = {e[0] for e in ev}
    missing = [n for n in STAGES + SUBSTAGES if n not in names]
    assert not missing
    assert any(n.startswith("ba_lm[") for n in names)
    for name, s, e, t in ev:
        assert t == tid, name
        assert a <= s and e <= b, name


def test_substages_nest_in_their_stage(runs):
    ev = runs["events"]

    def inside(child, parent):
        outer = [(s, e) for n, s, e, _ in ev if n == parent]
        return all(any(a <= s and e <= b for a, b in outer)
                   for n, s, e, _ in ev if n == child)

    for child, parent in (("features.extrema", "calc_feature"),
                          ("kernel.extrema", "features.extrema"),
                          ("kernel.k2", "features.descriptor"),
                          ("kernel.k1", "features.orientation"),
                          ("match_2nn", "pairwise_match"),
                          ("ransac.score", "ransac"),
                          ("match.graph", "pairwise_match"),
                          ("cameras.schedule", "estimate_camera"),
                          ("blend.download", "blend")):
        assert inside(child, parent), (child, parent)
    lm_stages = [(s, e) for n, s, e, _ in ev if n.startswith("ba_lm[")]
    assert all(any(a <= s and e <= b for a, b in lm_stages)
               for n, s, e, _ in ev if n == "cameras.lm_iter")


def test_one_lm_iter_span_per_iteration(runs):
    iters = sum(e[0] == "cameras.lm_iter" for e in runs["events"])
    assert iters == runs["info"]["lm_iters"] > 0


def test_no_profiler_no_record_function(runs):
    assert runs["entered"] == []
    assert runs["plain_info"]["lm_iters"] == runs["info"]["lm_iters"]


def test_stage_totals_unchanged_by_spans(runs):
    assert runs["calls"] == runs["plain_calls"]
    assert set(STAGES) <= set(runs["calls"])
    assert runs["calls"]["calc_feature"] == 1
    assert sum(e[0] == "blend" for e in runs["events"]) == \
        runs["calls"]["blend"]


MB_LEVELS = 2
MB_SPANS = ("multiband.first_level", "multiband.levels", "multiband.blur",
            "multiband.accumulate")


@pytest.fixture(scope="module")
def mb_run(_one_thread):
    """The views stitched traced with MULTIBAND=2: (events, timer calls)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        before = timer.totals()
        openpano_torch.stitch_images(_views(), CFG.replace(MULTIBAND=MB_LEVELS),
                                     output="u8", device="cpu")
        after = timer.totals()
    calls = {k: after[k][0] - before.get(k, (0, 0.0))[0] for k in after}
    return _events(prof), calls


def test_multiband_spans_nest_in_blend_render(mb_run):
    ev, calls = mb_run
    count = lambda n: sum(e[0] == n for e in ev)
    assert count("multiband.first_level") == 1
    assert count("multiband.levels") == 1
    assert count("multiband.blur") == MB_LEVELS - 1
    assert count("multiband.accumulate") == MB_LEVELS
    render = [(s, e) for n, s, e, _ in ev if n == "blend.render"]
    assert len(render) == 1
    a, b = render[0]
    levels = [(s, e) for n, s, e, _ in ev if n == "multiband.levels"]
    for name, s, e, _ in ev:
        if name in MB_SPANS:
            assert a <= s and e <= b, name
        if name in ("multiband.blur", "multiband.accumulate"):
            assert levels[0][0] <= s and e <= levels[0][1], name
    assert calls["multiband.first_level"] == calls["multiband.levels"] == 1


def test_linear_path_has_no_multiband_spans(runs):
    assert not [e for e in runs["events"] if e[0].startswith("multiband.")]
    assert not [k for k in runs["calls"] if k.startswith("multiband.")]
