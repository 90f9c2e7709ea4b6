"""DoG extrema detection with sub-pixel/scale Newton refinement.

Reference behavior (feature/extrema.cc), as in ``openpano_tpu/sift/extrema.py``:
- Candidate iff center >= PRE_COLOR_THRES and strictly max/min vs its 26
  neighbors with margin JUDGE_EXTREMA_DIFF_THRES (extrema.cc:170-216),
  scanned over dog levels j in [1, NUM_SCALE-3] and interior pixels.
- Up to CALC_OFFSET_DEPTH Newton iterations on the 3x3x3 quadratic fit
  (extrema.cc:63-106): offset = H^-1 grad, re-centering by round(offset)
  until max|offset| < OFFSET_THRES.
- Contrast gate D + offset.grad/2 >= CONTRAST_THRES (extrema.cc:91-94) and
  2x2 Hessian edge rejection tr^2/det < (EDGE_RATIO+1)^2/EDGE_RATIO
  (extrema.cc:152-168).

A singular 3x3 Hessian fails the keypoint instead of taking the
pseudo-inverse step (extrema.cc:144-146), as the JAX package does.

Batched over images: dog is [B, L, h, w]; keypoint arrays are [B, cap].

On the card :func:`detect_extrema` launches two CUDA kernels
(``csrc/extrema.cu``; the note there says what bounds them and how the
design answers that) that give what :func:`detect_extrema_plain` gives on
the card, bit for bit, in place of its chain of some 1,500 small PyTorch
operators; a CPU tensor takes the plain version, which the tests hold
against the JAX package.  A CUDA tensor never takes the plain path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._build import cuda_library
from ..config import Config
from ..ops.compact import compact_indices, compact_indices_capped
from ..utils.timer import span
from .pyramid import Octave

BLOCK_LANES = 128   # lanes per block of the capped compaction
SCAN_WARPS = 4      # ballot words per block
DET_EPS = 1e-18     # a smaller |det| fails the keypoint as singular


class RawKeypoints(NamedTuple):
    """Refined per-octave keypoints, fixed size K (mask-padded), [B, K]."""
    x: torch.Tensor             # int64, integer coords in octave pixels
    y: torch.Tensor             # int64
    s: torch.Tensor             # int64 scale id in [1, NUM_SCALE-3]
    scale_factor: torch.Tensor  # f32
    real_x: torch.Tensor        # f32, sub-pixel coords in [0,1)
    real_y: torch.Tensor        # f32
    valid: torch.Tensor         # bool


def _neighbor_max(dog: torch.Tensor) -> torch.Tensor:
    """Max over each voxel's 26 neighbors (center EXCLUDED) of [B, L, H, W],
    separably: 3-tap row maxima -> per-plane 9-maxima for the s+-1 planes +
    an 8-neighbor in-plane max for the center plane."""
    pm = F.pad(dog, (1, 1, 1, 1, 1, 1), value=-3.4e38)   # [B, L+2, H+2, W+2]
    row = torch.maximum(torch.maximum(pm[..., :-2], pm[..., 1:-1]),
                        pm[..., 2:])                     # [B, L+2, H+2, W]
    nine = torch.maximum(torch.maximum(row[..., :-2, :], row[..., 1:-1, :]),
                         row[..., 2:, :])                # [B, L+2, H, W]
    mid_lr = torch.maximum(pm[..., 1:-1, :-2], pm[..., 1:-1, 2:])
    eight = torch.maximum(torch.maximum(row[..., :-2, :], row[..., 2:, :]),
                          mid_lr)                        # center plane
    return torch.maximum(torch.maximum(nine[:, :-2], nine[:, 2:]),
                         eight[:, 1:-1])


def _candidate_mask(dog: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[B, L, H, W] bool: 26-neighbor strict extrema with margin."""
    h, w = dog.shape[-2], dog.shape[-1]
    thres = cfg.JUDGE_EXTREMA_DIFF_THRES
    nmax = _neighbor_max(dog)
    nmin = -_neighbor_max(-dog)
    is_max = nmax < dog - thres
    is_min = nmin > dog + thres
    cand = (dog >= cfg.PRE_COLOR_THRES) & (is_max | is_min)
    mask = torch.zeros(dog.shape[1:], dtype=torch.bool, device=dog.device)
    # scanned levels j in [1, NUM_SCALE-3] (extrema.cc:41), interior pixels
    mask[1 : cfg.NUM_SCALE - 2, 1 : h - 1, 1 : w - 1] = True
    return cand & mask


def _gather(flat_dog, h, w, s, y, x):
    """dog[b, s, y, x] for [B, K] coordinates; flat_dog: [B, L*h*w]."""
    return flat_dog.gather(1, (s * h + y) * w + x)


def _stencil(D):
    """Gradient and Hessian of the 3x3x3 quadratic fit at integer (s,y,x)
    (reference: extrema.cc:108-140).  D(ds, dy, dx) reads the DoG at the
    offset; coords must be interior (caller clips; failed lanes are masked
    out)."""
    val = D(0, 0, 0)
    gx = (D(0, 0, 1) - D(0, 0, -1)) / 2.0
    gy = (D(0, 1, 0) - D(0, -1, 0)) / 2.0
    gs = (D(1, 0, 0) - D(-1, 0, 0)) / 2.0
    dxx = D(0, 0, 1) + D(0, 0, -1) - 2 * val
    dyy = D(0, 1, 0) + D(0, -1, 0) - 2 * val
    dss = D(1, 0, 0) + D(-1, 0, 0) - 2 * val
    dxy = (D(0, 1, 1) - D(0, -1, 1) - D(0, 1, -1) + D(0, -1, -1)) / 4.0
    dys = (D(1, 1, 0) - D(1, -1, 0) - D(-1, 1, 0) + D(-1, -1, 0)) / 4.0
    dsx = (D(1, 0, 1) - D(1, 0, -1) - D(-1, 0, 1) + D(-1, 0, -1)) / 4.0
    return val, (gx, gy, gs), (dxx, dyy, dss, dxy, dys, dsx)


def _solve3x3(hess, grad):
    """offset = H^-1 g via the adjugate; returns (ox, oy, os, ok)."""
    dxx, dyy, dss, dxy, dys, dsx = hess
    gx, gy, gs = grad
    # symmetric H = [[dxx, dxy, dsx], [dxy, dyy, dys], [dsx, dys, dss]]
    c00 = dyy * dss - dys * dys
    c01 = dsx * dys - dxy * dss
    c02 = dxy * dys - dsx * dyy
    c11 = dxx * dss - dsx * dsx
    c12 = dsx * dxy - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    det = dxx * c00 + dxy * c01 + dsx * c02
    ok = torch.abs(det) > DET_EPS
    idet = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    ox = (c00 * gx + c01 * gy + c02 * gs) * idet
    oy = (c01 * gx + c11 * gy + c12 * gs) * idet
    os_ = (c02 * gx + c12 * gy + c22 * gs) * idet
    return ox, oy, os_, ok


def detect_extrema_plain(octave: Octave, cfg: Config,
                         cap_cand: int | None = None,
                         cap_kp: int | None = None) -> RawKeypoints:
    """The plain PyTorch version of :func:`detect_extrema`: the CPU path and
    the card's reference."""
    dog = octave.dog
    B, L, h, w = dog.shape
    ns = cfg.NUM_SCALE
    cap_cand = cfg.MAX_CAND_PER_OCTAVE if cap_cand is None else cap_cand
    cap_kp = cfg.MAX_KP_PER_OCTAVE if cap_kp is None else cap_kp
    dev = dog.device
    flat = dog.reshape(B, -1)

    # only levels j in [1, NUM_SCALE-3] are scanned (extrema.cc:41); the
    # capped compaction keeps at most 32 hits per 128 lanes, as the JAX
    # package does — that cap decides which extrema survive
    cand = _candidate_mask(dog, cfg)[:, 1 : ns - 2]
    flat_idx, n_cand = compact_indices_capped(cand.reshape(B, -1), cap_cand)
    alive = torch.arange(cap_cand, device=dev) < n_cand[:, None]

    s = flat_idx // (h * w) + 1
    y = (flat_idx // w) % h
    x = flat_idx % w

    done = torch.zeros_like(alive)
    fail = ~alive
    zf = lambda: torch.zeros(x.shape, dtype=torch.float32, device=dev)
    ox, oy, os_, gfx, gfy, gfs = zf(), zf(), zf(), zf(), zf(), zf()

    for _ in range(cfg.CALC_OFFSET_DEPTH):
        active = (~done) & (~fail)
        inb = ((x >= 1) & (x <= w - 2) & (y >= 1) & (y <= h - 2)
               & (s >= 1) & (s <= ns - 3))
        fail = fail | (active & ~inb)
        active = active & inb
        sc = torch.clamp(s, 1, ns - 3)
        yc = torch.clamp(y, 1, h - 2)
        xc = torch.clamp(x, 1, w - 2)
        _, grad, hess = _stencil(
            lambda ds, dy, dx: _gather(flat, h, w, sc + ds, yc + dy, xc + dx))
        nox, noy, nos, solvable = _solve3x3(hess, grad)
        fail = fail | (active & ~solvable)
        active = active & solvable
        conv = (torch.maximum(torch.abs(nox),
                              torch.maximum(torch.abs(noy), torch.abs(nos)))
                < cfg.OFFSET_THRES)
        newly = active & conv
        ox = torch.where(newly, nox, ox)
        oy = torch.where(newly, noy, oy)
        os_ = torch.where(newly, nos, os_)
        gfx = torch.where(newly, grad[0], gfx)
        gfy = torch.where(newly, grad[1], gfy)
        gfs = torch.where(newly, grad[2], gfs)
        done = done | newly
        step = active & ~conv
        x = torch.where(step, x + torch.round(nox).long(), x)
        y = torch.where(step, y + torch.round(noy).long(), y)
        s = torch.where(step, s + torch.round(nos).long(), s)

    ok = done
    sc = torch.clamp(s, 1, ns - 3)
    yc = torch.clamp(y, 1, h - 2)
    xc = torch.clamp(x, 1, w - 2)
    G = lambda dy, dx: _gather(flat, h, w, sc, yc + dy, xc + dx)

    # contrast gate: D(x_hat) = D + offset.grad/2 (extrema.cc:89-94)
    dextr = G(0, 0) + (ox * gfx + oy * gfy + os_ * gfs) * 0.5
    ok = ok & (dextr >= cfg.CONTRAST_THRES)

    # edge response on the 2x2 spatial Hessian (extrema.cc:152-168)
    val = G(0, 0)
    exx = G(0, 1) + G(0, -1) - 2 * val
    eyy = G(1, 0) + G(-1, 0) - 2 * val
    exy = (G(1, 1) + G(-1, -1) - G(1, -1) - G(-1, 1)) / 4.0
    edet = exx * eyy - exy * exy
    tr2 = (exx + eyy) ** 2
    not_edge = (edet > 0) & (tr2 / torch.where(edet > 0, edet, 1.0)
                             < (cfg.EDGE_RATIO + 1.0) ** 2 / cfg.EDGE_RATIO)
    ok = ok & not_edge

    # compact survivors to the keypoint cap
    keep, n_keep = compact_indices(ok, cap_kp)
    kvalid = torch.arange(cap_kp, device=dev) < n_keep[:, None]

    scale_factor = cfg.GAUSS_SIGMA * torch.pow(
        torch.tensor(cfg.SCALE_FACTOR, dtype=torch.float32, device=dev),
        (sc.to(torch.float32) + os_) / ns)
    real_x = (xc.to(torch.float32) + ox) / w
    real_y = (yc.to(torch.float32) + oy) / h
    take = lambda a: a.gather(1, keep)
    return RawKeypoints(
        x=take(xc), y=take(yc), s=take(sc),
        scale_factor=take(scale_factor),
        real_x=take(real_x), real_y=take(real_y),
        valid=kvalid,
    )


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    """The kernel library, loaded and its argument types set once."""
    lib = cuda_library("extrema")
    # pointers and the stream as c_void_p: a bare int would pass as 32 bits
    lib.extrema_launch.argtypes = ([_P] + [_I] * 8 + [_F] * 8 + [_P] * 9)
    lib.extrema_launch.restype = ctypes.c_int
    return lib


def detect_extrema_cuda(dog: torch.Tensor, cfg: Config, cap_cand: int,
                        cap_kp: int) -> RawKeypoints:
    """Launch the scan and the refinement on the card for a [B, L, h, w]
    DoG stack."""
    B, L, h, w = dog.shape
    ns = cfg.NUM_SCALE
    if L != ns - 1:
        raise ValueError(f"{L} DoG levels for NUM_SCALE={ns}: the kernels "
                         f"take NUM_SCALE - 1")
    if h < 3 or w < 3 or (ns - 3) * h * w >= 2**31:
        raise ValueError(f"octave {h}x{w}: the kernels take 3x3 up to 2**31 "
                         f"scanned lanes")
    if cap_cand < 1 or cap_kp < 0:
        raise ValueError(f"caps {cap_cand}, {cap_kp}: need cap_cand >= 1 "
                         f"and cap_kp >= 0")
    if dog.dtype != torch.float32:
        raise ValueError(f"a {dog.dtype} DoG stack: the kernels take float32")
    dog = dog.contiguous()
    dev = dog.device
    nb = -(-(ns - 3) * h * w // BLOCK_LANES)
    scratch = torch.empty(B * (nb * (SCAN_WARPS + 1) + cap_cand),
                          dtype=torch.int32, device=dev)
    # one allocation a field: a caller that drops one frees its memory
    ints = [torch.empty(B, cap_kp, dtype=torch.int64, device=dev)
            for _ in range(3)]
    flts = [torch.empty(B, cap_kp, dtype=torch.float32, device=dev)
            for _ in range(3)]
    valid = torch.empty(B, cap_kp, dtype=torch.bool, device=dev)
    edge = (cfg.EDGE_RATIO + 1.0) ** 2 / cfg.EDGE_RATIO
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().extrema_launch(
            dog.data_ptr(), B, L, h, w, ns, cfg.CALC_OFFSET_DEPTH, cap_cand,
            cap_kp, cfg.PRE_COLOR_THRES, cfg.JUDGE_EXTREMA_DIFF_THRES,
            cfg.OFFSET_THRES, cfg.CONTRAST_THRES, edge, DET_EPS,
            cfg.SCALE_FACTOR, cfg.GAUSS_SIGMA, scratch.data_ptr(),
            *[a.data_ptr() for a in (*ints, *flts, valid)], stream)
    if err != 0:
        raise RuntimeError(f"extrema kernel launch failed: CUDA error {err}")
    if B:
        detect_extrema.launches += 2
    return RawKeypoints(x=ints[0], y=ints[1], s=ints[2],
                        scale_factor=flts[0], real_x=flts[1], real_y=flts[2],
                        valid=valid)


def detect_extrema(octave: Octave, cfg: Config, cap_cand: int | None = None,
                   cap_kp: int | None = None) -> RawKeypoints:
    """Refined DoG extrema of one octave, at most ``cap_kp`` an image (of the
    first ``cap_cand`` candidates), in scan order and mask-padded: the
    kernels for a CUDA tensor, :func:`detect_extrema_plain` for a CPU one.
    ``detect_extrema.launches`` counts the kernel launches."""
    cap_cand = cfg.MAX_CAND_PER_OCTAVE if cap_cand is None else cap_cand
    cap_kp = cfg.MAX_KP_PER_OCTAVE if cap_kp is None else cap_kp
    dev = octave.dog.device
    with span("kernel.extrema"):
        if dev.type == "cuda":
            return detect_extrema_cuda(octave.dog, cfg, cap_cand, cap_kp)
        if dev.type == "cpu":
            return detect_extrema_plain(octave, cfg, cap_cand, cap_kp)
    raise ValueError(f"no extrema kernel for device {dev}")


detect_extrema.launches = 0
