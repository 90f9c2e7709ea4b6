"""Keypoint windows: the two SIFT histogram kernels and the slab gather.

Orientation assignment and the descriptor both need, per keypoint, a small
window of the gradient magnitude/orientation planes around the keypoint
(reference: feature/orientation.cc:47-66, feature/sift.cc:99-144).  Each
becomes one fused kernel that reads the window and writes only the
histogram:

- ``orientation_histogram`` (K1): 36-bin hard-binned, gaussian-weighted;
  it replaces ``_ori_hist_pallas`` of ``openpano_tpu/ops/windows.py``;
- ``descriptor_histogram`` (K2): the raw 4x4x8 trilinear SIFT histogram
  (RootSIFT stays outside); it replaces ``_desc_hist_pallas``;
- ``gather_window_slabs`` (K3): the [WR, 256] slab of two planes around
  each keypoint, by the slab rule below; it replaces ``_win2_pallas``.  No
  stitch path calls it (the histogram kernels read their windows
  themselves); it is the JAX package's public window extraction.

On the card each wrapper launches its CUDA kernel (``csrc/windows.cu``;
the note there says what bounds it and how the design answers that); on
the CPU it runs the plain PyTorch version beside it, which the tests hold
against the JAX package and ``chip_smoke.py`` holds the kernel against on
the card.  A CUDA tensor never takes the plain path.

The JAX package copies an 8x128-aligned [WR, 256] slab per keypoint (a TPU
layout rule, see its module docstring); here the window is read directly.
The two agree while the window lies inside the slab: for window radii up
to ``MAX_WINDOW_RADIUS`` (``windows.py:24-27`` there), which both wrappers
assert.  ``slab_rows`` and ``window_starts`` keep the slab rule itself for
callers and tests that reason about it.

A batch of images passes as [B, S, H, W] planes with [B, K] keypoints and
folds into the plane axis (``s' = b*S + s``), so it runs as one launch,
like the JAX package's ``custom_vmap`` rule.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .._build import cuda_library
from ..utils.precision import full_f32
from ..utils.timer import span

SLAB_LANES = 256
MAX_WINDOW_RADIUS = 63
ORI_NBINS = 36   # ORI_HIST_BIN_NUM (config.hh:74)
DESC_W4 = 4      # DESC_HIST_WIDTH (config.hh:77)
DESC_NB = 8      # DESC_HIST_BIN_NUM (config.hh:78)
_DESC_CHUNK = 128


def slab_rows(radius: int) -> int:
    """Slab row count covering +-radius around the keypoint after 8-row
    alignment of the slab start (the JAX package's slab rule)."""
    return -(-(2 * radius + 16) // 8) * 8


def padded_dims(H: int, W: int, WR: int) -> tuple[int, int]:
    """(Hp, Wp): the plane zero-padded to 8-row and 128-lane multiples, at
    least one slab in each dimension."""
    return max(-(-H // 8) * 8, WR), max(-(-W // 128) * 128, SLAB_LANES)


def window_starts(y: torch.Tensor, x: torch.Tensor, H: int, W: int, WR: int):
    """Row/col starts of a keypoint's [WR, 256] slab on the zero-padded
    plane (the JAX package's ``window_starts``)."""
    Hp, Wp = padded_dims(H, W, WR)
    r0 = torch.clamp(y.to(torch.int32) - WR // 2, 0, Hp - WR) & ~7
    c0 = torch.clamp(x.to(torch.int32) - 64, 0, Wp - SLAB_LANES) & ~127
    return r0, c0


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------


def _window(S, H, W, s, y, x, lo: int, hi: int):
    """Offsets d in [lo, hi] around each keypoint: (dy, dx) f32 [1, n, 1] /
    [1, 1, n], plane coords (py, px) f32 [K, n, 1] / [K, 1, n] and the
    flat plane index [K, n, n] (clamped; callers mask)."""
    d = torch.arange(lo, hi + 1, device=s.device)
    py = y.long().view(-1, 1, 1) + d.view(1, -1, 1)
    px = x.long().view(-1, 1, 1) + d.view(1, 1, -1)
    sc = s.long().clamp(0, S - 1).view(-1, 1, 1)
    idx = (sc * H + py.clamp(0, H - 1)) * W + px.clamp(0, W - 1)
    df = d.to(torch.float32)
    return (df.view(1, -1, 1), df.view(1, 1, -1),
            py.to(torch.float32), px.to(torch.float32), idx)


def _ori_hist_rows(mag, ort, s, y, x, rad, invden, hb, wb, R: int):
    S, H, W = mag.shape
    K = s.shape[0]
    dy, dx, py, px, idx = _window(S, H, W, s, y, x, -R, R - 1)
    col = lambda v: v.view(-1, 1, 1)
    rad, invden = col(rad), col(invden)
    hb = col(torch.clamp(hb, max=float(H)))
    wb = col(torch.clamp(wb, max=float(W)))
    r2 = dy * dy + dx * dx
    inside = (
        (dy >= -rad) & (dy <= rad - 1) & (dx >= -rad) & (dx <= rad - 1)
        & (r2 <= rad * rad)
        & (px >= 1) & (px <= wb - 2) & (py >= 1) & (py <= hb - 2)
    )
    m = mag.reshape(-1)[idx]
    o = ort.reshape(-1)[idx]
    wgt = torch.where(inside, torch.exp(-r2 * invden) * m, 0.0)
    b = torch.floor(o * (ORI_NBINS / (2.0 * math.pi)) + 0.5).long()
    b = torch.where(b >= ORI_NBINS, b - ORI_NBINS, b)
    b = torch.where(inside, b, 0)
    hist = torch.zeros(K, ORI_NBINS, dtype=torch.float32, device=mag.device)
    hist.scatter_add_(1, b.reshape(K, -1), wgt.reshape(K, -1))
    return hist



def desc_hats(ybin, xbin, hbin):
    """Each pixel's trilinear hats, dense: ``hat(ybin - by)`` [..., 4],
    ``hat(xbin - bx)`` [..., 4] and, circular in orientation,
    ``hat(min(d, 8 - d))`` with ``d = |hbin - bo|`` [..., 8]."""
    hat = lambda d: torch.clamp(1.0 - torch.abs(d), min=0.0)
    grid4 = torch.arange(DESC_W4, dtype=torch.float32, device=ybin.device)
    grid8 = torch.arange(DESC_NB, dtype=torch.float32, device=ybin.device)
    do = torch.abs(hbin[..., None] - grid8)
    return (hat(ybin[..., None] - grid4), hat(xbin[..., None] - grid4),
            hat(torch.minimum(do, DESC_NB - do)))


def _desc_hist_rows(mag, ort, s, y, x, radius, hw, cos_o, sin_o, dirv, hb, wb,
                    R: int):
    S, H, W = mag.shape
    K = s.shape[0]
    dev = mag.device
    hb = torch.clamp(hb, max=float(H))
    wb = torch.clamp(wb, max=float(W))
    out = torch.empty(K, DESC_W4 * DESC_W4 * DESC_NB, dtype=torch.float32,
                      device=dev)
    for lo in range(0, K, _DESC_CHUNK):
        sl = slice(lo, lo + _DESC_CHUNK)
        fy, fx, py, px, idx = _window(S, H, W, s[sl], y[sl], x[sl], -R, R)
        col = lambda v: v[sl].view(-1, 1, 1)
        rr, hwc, co, si, dv = (col(radius), col(hw), col(cos_o), col(sin_o),
                               col(dirv))
        hbc, wbc = col(hb), col(wb)
        r2 = fy * fy + fx * fx
        inside = (
            (torch.abs(fy) <= rr) & (torch.abs(fx) <= rr) & (r2 <= rr * rr)
            & (px >= 1) & (px <= wbc - 2) & (py >= 1) & (py <= hbc - 2)
        )
        x_rot = (fx * co + fy * si) / hwc
        y_rot = (-fx * si + fy * co) / hwc
        ybin = y_rot + DESC_W4 / 2 - 0.5
        xbin = x_rot + DESC_W4 / 2 - 0.5
        inside &= ((ybin >= -1) & (ybin <= DESC_W4 - 1)
                   & (xbin >= -1) & (xbin <= DESC_W4 - 1))
        m = mag.reshape(-1)[idx]
        o = ort.reshape(-1)[idx]
        wgt = torch.exp(-(x_rot * x_rot + y_rot * y_rot)
                        / (2.0 * DESC_W4 * DESC_W4)) * m
        wgt = torch.where(inside, wgt, 0.0)
        now = o - dv
        now = torch.where(now < 0, now + 2 * math.pi, now)
        now = torch.where(now > 2 * math.pi, now - 2 * math.pi, now)
        hbin = now * (DESC_NB / (2.0 * math.pi))

        C = idx.shape[0]
        flat = lambda a: a.reshape(C, -1)
        A, B, Co = desc_hats(flat(ybin), flat(xbin), flat(hbin))
        WAB = (flat(wgt)[:, :, None, None] * A[:, :, :, None]
               * B[:, :, None, :]).reshape(C, -1, DESC_W4 * DESC_W4)
        with full_f32():
            out[sl] = torch.einsum("cpq,cpo->cqo", WAB, Co).reshape(C, -1)
    return out



def _on_active(rows, nbins, active, *per_kp):
    """Rows of a plain histogram for the active keypoints only; inactive
    rows are zero (what the reference's ``* active`` gives them)."""
    ids = torch.nonzero(active).flatten()
    out = torch.zeros(active.shape[0], nbins, dtype=torch.float32,
                      device=active.device)
    out[ids] = rows(*(v[ids] for v in per_kp))
    return out


def ori_hist_plain(mag, ort, s, y, x, rad, invden, hb, wb, active, R: int):
    """Plain PyTorch K1 over folded [S, H, W] planes and [K] keypoints:
    the semantics of ``_ori_hist_math`` / ``_ori_hist_xla``."""
    return _on_active(lambda *v: _ori_hist_rows(mag, ort, *v, R), ORI_NBINS,
                      active, s, y, x, rad, invden, hb, wb)


def desc_hist_plain(mag, ort, s, y, x, radius, hw, cos_o, sin_o, dirv, hb, wb,
                    active, R: int):
    """Plain PyTorch K2 over folded [S, H, W] planes and [K] keypoints:
    the semantics of ``_desc_elem_math`` / ``_desc_hist_xla``, in chunks of
    keypoints to bound the [C, P, 16] soft-binning intermediate."""
    return _on_active(lambda *v: _desc_hist_rows(mag, ort, *v, R),
                      DESC_W4 * DESC_W4 * DESC_NB, active, s, y, x, radius,
                      hw, cos_o, sin_o, dirv, hb, wb)


def slab_index(S: int, H: int, W: int, s, y, x, WR: int):
    """Index tuple (plane [K,1,1], row [K,WR,1], lane [K,1,256]) of each
    keypoint's slab into the planes zero-padded to ``padded_dims``."""
    r0, c0 = window_starts(y, x, H, W, WR)
    dev = s.device
    rows = r0.long()[:, None] + torch.arange(WR, device=dev)
    cols = c0.long()[:, None] + torch.arange(SLAB_LANES, device=dev)
    return (s.long().clamp(0, S - 1)[:, None, None], rows[:, :, None],
            cols[:, None, :])


def pad_planes(p: torch.Tensor, WR: int) -> torch.Tensor:
    """[..., H, W] planes zero-padded to ``padded_dims``, as float32."""
    H, W = p.shape[-2], p.shape[-1]
    Hp, Wp = padded_dims(H, W, WR)
    return F.pad(p.to(torch.float32), (0, Wp - W, 0, Hp - H))


def win2_plain(a, b, s, y, x, WR: int):
    """Plain PyTorch K3 over folded [S, H, W] planes and [K] keypoints: the
    semantics of ``_win2_xla`` — pad the planes, then index the slabs."""
    idx = slab_index(*a.shape, s, y, x, WR)
    return pad_planes(a, WR)[idx], pad_planes(b, WR)[idx]


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    """The kernel library, loaded and its argument types set once."""
    lib = cuda_library("windows")
    # pointers and the stream as c_void_p: a bare int would pass as 32 bits
    lib.ori_hist_launch.argtypes = (
        [_P, _P, _I, _I, _I] + [_P] * 8 + [_I, _I, _P, _P])
    lib.ori_hist_launch.restype = ctypes.c_int
    lib.desc_hist_launch.argtypes = (
        [_P, _P, _I, _I, _I] + [_P] * 11 + [_I, _I, _P, _P])
    lib.desc_hist_launch.restype = ctypes.c_int
    lib.win2_launch.argtypes = [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P,
                                _P, _P]
    lib.win2_launch.restype = ctypes.c_int
    return lib


def _check_planes(mag, ort):
    if mag.shape != ort.shape or mag.dim() != 3:
        raise ValueError(f"planes must be two equal [S, H, W]: "
                         f"{tuple(mag.shape)} vs {tuple(ort.shape)}")
    if mag.device != ort.device:
        raise ValueError("mag and ort must lie on one device")
    return (mag.to(torch.float32).contiguous(),
            ort.to(torch.float32).contiguous())


def _per_kp(device, K, ints, floats, active):
    """Per-keypoint arrays as the kernel takes them: contiguous int32 /
    float32 / bool (one byte, read as uint8) of length K on ``device``.
    Arrays that already are so pass through without a copy."""
    def cast(v, dt):
        v = v.to(device=device, dtype=dt).contiguous()
        if v.shape != (K,):
            raise ValueError(f"per-keypoint array of shape {tuple(v.shape)}, "
                             f"expected ({K},)")
        return v
    return ([cast(v, torch.int32) for v in ints],
            [cast(v, torch.float32) for v in floats],
            cast(active, torch.bool))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def ori_hist_cuda(mag, ort, s, y, x, rad, invden, hb, wb, active, R: int):
    """Launch K1 on the card (folded [S, H, W] planes, [K] keypoints)."""
    mag, ort = _check_planes(mag, ort)
    S, H, W = mag.shape
    K = s.shape[0]
    (s, y, x), flts, act = _per_kp(mag.device, K, (s, y, x),
                                   (rad, invden, hb, wb), active)
    out = torch.empty(K, ORI_NBINS, dtype=torch.float32, device=mag.device)
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        err = _lib().ori_hist_launch(
            mag.data_ptr(), ort.data_ptr(), S, H, W,
            s.data_ptr(), y.data_ptr(), x.data_ptr(),
            *[v.data_ptr() for v in flts], act.data_ptr(), K, R,
            out.data_ptr(), stream)
    _raise_on(err, "orientation histogram")
    orientation_histogram.launches += 1
    return out


def desc_hist_cuda(mag, ort, s, y, x, radius, hw, cos_o, sin_o, dirv, hb, wb,
                   active, R: int):
    """Launch K2 on the card (folded [S, H, W] planes, [K] keypoints)."""
    mag, ort = _check_planes(mag, ort)
    S, H, W = mag.shape
    K = s.shape[0]
    (s, y, x), flts, act = _per_kp(
        mag.device, K, (s, y, x),
        (radius, hw, cos_o, sin_o, dirv, hb, wb), active)
    out = torch.empty(K, DESC_W4 * DESC_W4 * DESC_NB, dtype=torch.float32,
                      device=mag.device)
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        err = _lib().desc_hist_launch(
            mag.data_ptr(), ort.data_ptr(), S, H, W,
            s.data_ptr(), y.data_ptr(), x.data_ptr(),
            *[v.data_ptr() for v in flts], act.data_ptr(), K, R,
            out.data_ptr(), stream)
    _raise_on(err, "descriptor histogram")
    descriptor_histogram.launches += 1
    return out


def win2_cuda(a, b, s, y, x, WR: int):
    """Launch K3 on the card (folded [S, H, W] planes, [K] keypoints):
    both planes' slabs in one launch, read from the unpadded planes."""
    a, b = _check_planes(a, b)
    S, H, W = a.shape
    K = s.shape[0]
    s, y, x = (v.to(device=a.device, dtype=torch.int32).contiguous()
               for v in (s, y, x))
    if not s.shape == y.shape == x.shape == (K,):
        raise ValueError("s, y, x must be three [K] arrays")
    wa = torch.empty(K, WR, SLAB_LANES, dtype=torch.float32, device=a.device)
    wb = torch.empty_like(wa)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().win2_launch(
            a.data_ptr(), b.data_ptr(), S, H, W, s.data_ptr(), y.data_ptr(),
            x.data_ptr(), K, WR, wa.data_ptr(), wb.data_ptr(), stream)
    _raise_on(err, "window slab")
    gather_window_slabs.launches += 1
    return wa, wb


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------


def _fold(mag, ort, s, per_kp):
    """[B, S, H, W] planes + [B, K] keypoints -> one folded problem."""
    if mag.dim() == 3:
        return mag, ort, s, per_kp, None
    B, S, H, W = mag.shape
    K = s.shape[-1]
    offs = (torch.arange(B, device=s.device, dtype=s.dtype) * S)[:, None]
    return (mag.reshape(B * S, H, W), ort.reshape(B * S, H, W),
            (s + offs).reshape(-1), [v.reshape(-1) for v in per_kp], (B, K))


def _bounds(mag, s, wh):
    if wh is None:
        H, W = mag.shape[-2], mag.shape[-1]
        return (torch.full(s.shape, float(H), device=s.device),
                torch.full(s.shape, float(W), device=s.device))
    return wh[..., 1].to(torch.float32), wh[..., 0].to(torch.float32)


def _route(mag, plain, cuda, *args):
    if mag.device.type == "cuda":
        return cuda(*args)
    if mag.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no kernel for device {mag.device}")


def orientation_histogram(mag, ort, s, y, x, rad, invden, R: int, wh=None,
                          valid=None) -> torch.Tensor:
    """Per-keypoint 36-bin orientation histogram.

    mag/ort: [S, H, W] (or [B, S, H, W]) planes; s/y/x: [K] (or [B, K])
    keypoint plane, row and column; rad: integral circular-window radius
    (already rounded), at most ``R``; invden: 1/(2 sigma^2); R: the static
    window radius bound; wh: optional per-keypoint (w, h) octave bounds
    (default: the plane dims); valid: optional mask, rows of invalid slots
    come back zero.  Returns [K, 36] (or [B, K, 36])."""
    if not 0 <= R <= MAX_WINDOW_RADIUS:
        raise ValueError(f"window radius {R} outside [0, {MAX_WINDOW_RADIUS}]")
    with span("kernel.k1"):
        hb, wb = _bounds(mag, s, wh)
        if valid is None:
            valid = torch.ones(s.shape, dtype=torch.bool, device=s.device)
        mag, ort, s, (y, x, rad, invden, hb, wb, valid), bk = _fold(
            mag, ort, s, [y, x, rad, invden, hb, wb, valid])
        hist = _route(mag, ori_hist_plain, ori_hist_cuda, mag, ort, s, y, x,
                      rad.to(torch.float32), invden.to(torch.float32), hb,
                      wb, valid, R)
    return hist if bk is None else hist.reshape(*bk, ORI_NBINS)


def descriptor_histogram(mag, ort, s, y, x, radius, hw, dirv, R: int, wh=None,
                         valid=None) -> torch.Tensor:
    """Per-keypoint raw SIFT histogram [K, 128] (pre-RootSIFT).

    radius: rounded circular window radius, at most ``R``; hw: spatial bin
    width (hist_w); dirv: keypoint direction; other arguments as for
    :func:`orientation_histogram`."""
    if not 0 <= R <= MAX_WINDOW_RADIUS:
        raise ValueError(f"window radius {R} outside [0, {MAX_WINDOW_RADIUS}]")
    with span("kernel.k2"):
        hb, wb = _bounds(mag, s, wh)
        if valid is None:
            valid = torch.ones(s.shape, dtype=torch.bool, device=s.device)
        dirv = dirv.to(torch.float32)
        mag, ort, s, (y, x, radius, hw, dirv, hb, wb, valid), bk = _fold(
            mag, ort, s, [y, x, radius, hw, dirv, hb, wb, valid])
        hist = _route(mag, desc_hist_plain, desc_hist_cuda, mag, ort, s, y,
                      x, radius.to(torch.float32), hw.to(torch.float32),
                      torch.cos(dirv), torch.sin(dirv), dirv, hb, wb, valid,
                      R)
    return hist if bk is None else hist.reshape(*bk, -1)


def gather_window_slabs(a, b, s, y, x, WR: int):
    """Keypoint-centred [WR, 256] slabs of two [S, H, W] planes.

    Returns ``(wa, wb)`` of shape [K, WR, 256]: ``wa[k, i, j]`` is the plane
    ``a`` zero-padded to ``padded_dims`` at plane ``clip(s, 0, S-1)``, row
    ``r0 + i`` and lane ``c0 + j`` with (r0, c0) from ``window_starts``.
    ``WR`` must be a multiple of 8 (``slab_rows`` gives one).  [B, S, H, W]
    planes with [B, K] keypoints fold into the plane axis and return
    [B, K, WR, 256], one launch for the batch."""
    if WR <= 0 or WR % 8:
        raise ValueError(f"slab rows {WR} must be a positive multiple of 8")
    a, b, s, (y, x), bk = _fold(a, b, s, [y, x])
    wa, wb = _route(a, win2_plain, win2_cuda, a, b, s, y, x, WR)
    if bk is None:
        return wa, wb
    return (wa.reshape(*bk, WR, SLAB_LANES), wb.reshape(*bk, WR, SLAB_LANES))


orientation_histogram.launches = 0
descriptor_histogram.launches = 0
gather_window_slabs.launches = 0
