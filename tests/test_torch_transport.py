"""Port parity for the transport's stitch paths, on the CPU.

- ``upload_and_compute_features``: the features equal the port's
  ``compute_features`` on the uploaded stack bit for bit, at grey chunks
  that do and do not line up with the feature batches;
  ``DeferredImages.get()`` equals the stack's u8 -> f32 conversion bit for
  bit;
- ``blend_linear_stream_u8`` equals the port's ``blend_linear`` followed by
  ``f32_to_u8`` bit for bit at 1, 2 and 4 groups and across the 360 degree
  wrap, coded download on and off; against the JAX package's stream blend
  at 1 to 4 groups at most one u8 level on under 1e-3 of the pixels
  (torch's and XLA:CPU's f32 sin / cos round apart on a spherical plan,
  ROADMAP Queue 3);
- the host stream with its coded band uploads and coded strips equals the
  same run with ``coded_wire=False`` bit for bit;
- ``stitch`` on a uint8 stack takes the transport (the chroma thread
  released after the features, joined at the blend), and its u8 canvas is
  the same with ``STREAM_BLEND`` on and off, coded download on and off;
  ``stitch(graph=)`` too, and the same again with ``OPENPANO_BLEND_GRID=1``
  or ``OPENPANO_PACKED_GATHER=1`` set: the blend has one inverse map and
  one sampler, and reads neither variable;
- the slice against the JAX package: both packages' ``stitch(graph=)`` on
  the port's match graph, u8 out (JAX's streamed blend and coded strip
  downloads): the same cameras within 1e-6, valid masks agreeing on
  >= 99.95% of pixels, at most one u8 level apart on under 1e-3 of the
  pixels valid in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.io import artifacts as jart
from openpano_tpu.stitch import render as jrender
from openpano_tpu.stitch.stitcher import stitch as jstitch
from openpano_torch import Config
from openpano_torch.io import artifacts as tart
from openpano_torch.io import wirecodec as twc
from openpano_torch.stitch import render as trender
from openpano_torch.stitch import stitcherbase as tsb
from openpano_torch.stitch.stitcher import stitch
from openpano_torch.synth import procedural_scene_large, render_views

CPU = torch.device("cpu")
SMALL = Config(RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
               MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
               MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=256,
               SIFT_WORKING_SIZE=320)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def views_u8():
    """5 rotating u8 views of 320x240, shuffled (chip_smoke.py's reference
    set for the default Config)."""
    rot, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                          out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    return np.round(rot[[2, 0, 4, 1, 3]] * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def small_u8():
    """5 smaller views (200x150) for the feature parity."""
    rot, _ = render_views(procedural_scene_large(600, 2400, seed=1), 5,
                          out_w=200, out_h=150, hfov_deg=32, overlap=0.5)
    return np.round(rot * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def transport_run(views_u8):
    """The default path on the CPU: stitch over the u8 stack, u8 out, with
    the joins of the deferred stack counted."""
    info, joins = {}, []
    real = tsb.DeferredImages.get
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsb.DeferredImages, "get",
                   lambda self: joins.append(1) or real(self))
        out = stitch(views_u8, SMALL, output="u8", device="cpu",
                     info_out=info)
    return out, info, joins


def _sweep_plan(rng, n, H, W, wide=False, span=1.5):
    """tests/test_render_stream.py's spherical sweep (``span`` radians, or
    the full circle when ``wide``)."""
    imgs = rng.uniform(size=(n, H, W, 3)).astype(np.float32)
    whs = np.repeat([[float(W), float(H)]], n, 0)
    Kinv = np.linalg.inv(np.diag([float(W), float(W), 1.0]))
    span = 2 * np.pi if wide else span
    homos = []
    for i in range(n):
        th = (i - n / 2) * span / n
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        homos.append(R.T @ Kinv)
    homos = np.stack(homos)
    return (imgs, trender.plan_render(homos, whs, n // 2, "spherical", 8000),
            jrender.plan_render(homos, whs, n // 2, "spherical", 8000))


def _rgba(canvas: torch.Tensor) -> np.ndarray:
    u8, valid = trender.f32_to_u8(canvas)
    return np.concatenate([u8.numpy(), valid.numpy()[..., None].astype(
        np.uint8)], -1)


# ---- upload ----

@pytest.fixture(scope="module")
def small_features(small_u8):
    return tsb.compute_features(torch.from_numpy(small_u8), SMALL)


@pytest.mark.parametrize("chunk", ["8", "3"])
def test_upload_features_equal_compute_features(small_u8, small_features,
                                                monkeypatch, chunk):
    """Grey chunks of 8 (one chunk) and 3 (across the feature batches of
    4, and a last batch of one view)."""
    monkeypatch.setenv("OPENPANO_GREY_CHUNK", chunk)
    imgs, got = tsb.upload_and_compute_features(small_u8, SMALL,
                                                rgb_stream=False,
                                                device="cpu")
    assert isinstance(imgs, tsb.HostImages) and imgs.host is small_u8
    imgs.start_background()
    assert int(got.valid.sum(1).min()) > 0
    for a, b in zip(got, small_features):
        assert torch.equal(a, b)


def test_deferred_images_equal_the_u8_stack(small_u8, monkeypatch):
    calls = []
    real = twc.BackgroundUpload.release_wire
    monkeypatch.setattr(twc.BackgroundUpload, "release_wire",
                        lambda self: calls.append(1) or real(self))
    views_u8 = small_u8[:2]
    imgs, _ = tsb.upload_and_compute_features(views_u8, SMALL, device="cpu")
    assert isinstance(imgs, tsb.DeferredImages)
    assert imgs.shape == views_u8.shape and imgs.device == CPU
    imgs.start_background()
    assert calls == [1]
    got = imgs.get()
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(views_u8).float() / 255.0)
    assert imgs.get() is got


def test_chroma_and_planar_rows_rebuild_exactly():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    planar = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(u8, 3, 0)).reshape(-1, 7))
    want = torch.from_numpy(u8).float() / 255.0
    assert torch.equal(tsb._planar_rows_to_f32(planar, 2, 5, 7), want)


def test_dropped_deferred_images_abandon_their_thread(small_u8):
    imgs, _ = tsb.upload_and_compute_features(small_u8[:2], SMALL,
                                              device="cpu")
    thread = imgs._bg._thread
    del imgs
    thread.join(timeout=60)
    assert not thread.is_alive()


# ---- the streamed u8 blend ----

@pytest.mark.parametrize("groups,span", [(1, 1.5), (2, 1.5), (4, 1.5),
                                         (3, 2.4), (5, 2.4)])
def test_stream_blend_equals_blend_then_u8(groups, span, monkeypatch):
    """At any strip count: the jobs run in the in-memory blend's order
    (span 2.4: up to four views overlap, where a group-ordered sum would
    round apart)."""
    imgs, plan, _ = _sweep_plan(np.random.default_rng(42), 12, 60, 80,
                                span=span)
    src = torch.from_numpy(imgs)
    want = _rgba(trender.blend_linear(src, plan, ordered=False))
    for coded in ("1", "0"):
        monkeypatch.setenv("OPENPANO_CODED_DOWNLOAD", coded)
        got = trender.blend_linear_stream_u8(src, plan, ordered=False,
                                             groups=groups)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_stream_blend_across_the_wrap():
    imgs, plan, _ = _sweep_plan(np.random.default_rng(43), 10, 48, 64,
                                wide=True)
    assert len(plan.items) > 10  # at least one wrap-split item
    src = torch.from_numpy(imgs)
    want = _rgba(trender.blend_linear(src, plan, ordered=True))
    got = trender.blend_linear_stream_u8(src, plan, ordered=True, groups=3)
    np.testing.assert_array_equal(got, want)


def _close(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
def test_stream_blend_against_jax(groups):
    """The JAX package orders its sums by strip count; the port's do not."""
    imgs, plan, jplan = _sweep_plan(np.random.default_rng(44), 12, 60, 80)
    got = trender.blend_linear_stream_u8(torch.from_numpy(imgs), plan,
                                         ordered=False, groups=groups)
    want = jrender.blend_linear_stream_u8(jnp.asarray(imgs), jplan,
                                          ordered=False, groups=groups)
    assert got.shape == want.shape
    _close(got, want)


def test_strip_planes_round_trip_and_equal_jax():
    rng = np.random.default_rng(47)
    c = rng.uniform(0, 3, (20, 256, 3)).astype(np.float32)
    w = rng.uniform(0, 3, (20, 256)).astype(np.float32)
    w[w < 0.5] = 0
    planes = trender._strip_planes_u8(torch.from_numpy(c), torch.from_numpy(w),
                                      128, 16, 128).numpy()
    np.testing.assert_array_equal(planes, np.asarray(jrender._strip_planes_u8(
        jnp.asarray(c), jnp.asarray(w), jnp.int32(128), 16, 128)))
    raw = trender._strip_u8_i32(torch.from_numpy(c), torch.from_numpy(w),
                                128, 16, 128).numpy()
    np.testing.assert_array_equal(
        trender._planes_to_rgba(planes, 16),
        raw.view(np.uint8).reshape(16, 128, 4))


# ---- the host stream's coded transfers ----

def test_host_stream_coded_equals_uncoded(views_u8):
    rng = np.random.default_rng(48)
    _, plan, _ = _sweep_plan(rng, 5, 240, 320)
    uploads = []
    real = trender.band_slice

    def record(*a):
        uploads.append(len(a) > 3 and a[3])
        return real(*a)

    trender.band_slice = record
    try:
        coded = trender.blend_linear_host_stream(views_u8, plan, False, 2,
                                                 u8_out=True, device="cpu")
        plain = trender.blend_linear_host_stream(
            views_u8, plan, False, 2, u8_out=True, coded_wire=False,
            device="cpu")
    finally:
        trender.band_slice = real
    k = len(uploads) // 2
    assert k >= 1 and uploads == [True] * k + [False] * k
    np.testing.assert_array_equal(coded, plain)
    src = torch.from_numpy(views_u8).float() / 255.0
    want = _rgba(trender.blend_linear(src, plan, ordered=False))
    d = np.abs(coded.astype(int) - want.astype(int))
    assert d.max() <= 1


# ---- through stitch ----

def test_stitch_takes_the_transport(transport_run):
    """A u8 stack with no mesh and no graph joins its deferred stack once,
    at the blend, and gives a full canvas."""
    (canvas, valid), info, joins = transport_run
    assert joins == [1]
    assert canvas.dtype == np.uint8 and valid.mean() > 0.5
    assert info["connected_pairs"] >= 4


@pytest.mark.parametrize("stream,coded", [(True, "1"), (True, "0"),
                                          (False, "1")])
def test_graph_stitch_stream_blend_on_and_off(views_u8, transport_run,
                                              monkeypatch, stream, coded):
    """stitch(graph=) gives the transport run's canvas bit for bit, with the
    stream blend on (coded download on and off) and off."""
    (canvas, valid), info, _ = transport_run
    monkeypatch.setenv("OPENPANO_CODED_DOWNLOAD", coded)
    got = stitch(views_u8, SMALL.replace(STREAM_BLEND=stream), output="u8",
                 device="cpu", graph=info["graph"])
    np.testing.assert_array_equal(got[0], canvas)
    np.testing.assert_array_equal(got[1], valid)


@pytest.mark.parametrize("name", ["OPENPANO_BLEND_GRID",
                                  "OPENPANO_PACKED_GATHER"])
def test_removed_blend_variables_change_nothing(views_u8, transport_run,
                                                monkeypatch, name):
    """The blend has one inverse map and one sampler and reads neither
    variable: set, each leaves the stitch's u8 canvas the same bit for
    bit."""
    (canvas, valid), info, _ = transport_run
    monkeypatch.setenv(name, "1")
    got = stitch(views_u8, SMALL, output="u8", device="cpu",
                 graph=info["graph"])
    np.testing.assert_array_equal(got[0], canvas)
    np.testing.assert_array_equal(got[1], valid)


def test_graph_stitch_u8_against_jax(views_u8, transport_run, tmp_path):
    (canvas, valid), info, _ = transport_run
    path = str(tmp_path / "matchinfo.txt")
    tart.dump_matchinfo_text(path, info["graph"])
    jgraph = jart.load_matchinfo_text(path, 5, SMALL.MAX_MATCHES_PER_PAIR)
    jinfo = {}
    jcfg = JConfig(**{k: getattr(SMALL, k) for k in (
        "RANSAC_ITERATIONS", "MAX_CAND_PER_OCTAVE", "MAX_KP_PER_OCTAVE",
        "MAX_DESC_PER_OCTAVE", "MAX_KP_PER_IMAGE", "MAX_MATCHES_PER_PAIR",
        "SIFT_WORKING_SIZE")})
    want, wvalid = jstitch(views_u8, jcfg, key=jax.random.PRNGKey(0),
                           output="u8", graph=jgraph, info_out=jinfo)
    cams, jc = info["cams"], jinfo["cams"]
    assert np.abs(cams.focal / jc.focal - 1).max() < 1e-6
    assert np.abs(cams.R - jc.R).max() < 1e-6
    assert canvas.shape == want.shape
    assert (valid == wvalid).mean() >= 0.9995
    both = valid & wvalid
    d = np.abs(canvas.astype(int) - want.astype(int)).max(-1)[both]
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
