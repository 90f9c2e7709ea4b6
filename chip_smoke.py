#!/usr/bin/env python3
"""Drive openpano_torch on one NVIDIA card, end to end, and report.

    python3 chip_smoke.py            # one card; exits non-zero without one
    python3 chip_smoke.py --kernels  # phases 1-4 only, no device line

Phases, each fatal on failure:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the package's CUDA sources (``windows.cu``, ``extrema.cu`` and
     ``ransac.cu``, one nvcc run each), with ptxas's registers, shared
     memory and spills per kernel;
  3. inputs: the headline set — 38 uint8 views of 1300x867 of a camera
     yawing through a 336 degree sweep (40 degree field of view, 80%
     overlap) over ``procedural_scene_large``, shuffled: the shape of the
     JAX package's bench.py, on procedural data — and a 38-view
     translated strip for TRANS mode;
  4. kernels: K1 and K2 on the inputs the first feature batch of each path
     gives them (the headline's and the TRANS strip's, whose caps differ),
     on a seeded random case of the same shapes and on a crafted case with
     pixels exactly on bin edges (``edge_case``), held against their plain
     versions (max|a-b| / max|b| < 1e-4), timed at the headline's;
     K3 on the headline batch's planes and descriptor keypoints (WR =
     slab_rows(19) = 56) and on a random case with odd plane sizes,
     keypoints on every border and planes out of range, held bit-equal to
     its plain version; the extrema kernels on every octave each path's
     first feature batch hands them, held to their plain version on the
     same card tensors bit for bit in every field and slot; each run
     twice for identical bits; median times by CUDA events of the launch
     alone (arguments cast beforehand), the plain version's time, the
     library call's where one PyTorch call computes the same function, and
     the least time the card could take (the extrema's at octave 0 of the
     headline's batch); the RANSAC kernel on the pairs each path's
     matching keeps (all 703 of the headline set, the strip's ring),
     twice for identical bits, held to a float64 refit of its own inliers
     (``benchmark.reference.refit``, within the cmu0 cell's ``refit_px``
     limit) and to the plain chain on the same card tensors (the winner's
     inlier count, success and inliers equal on all but a flip at the
     threshold's edge, the transforms within RANSAC_GAP_PX over the
     inliers; the pairs equal bit for bit reported), timed at the
     headline's with its least time by operations;
  5. references: a 4-view strip (TRANS), 5 rotating views (the default
     Config) and a 6-view sweep in CYLINDER mode with MULTIBAND=2 stitched
     on the card and on the CPU (the plain versions, which the tests hold
     to the JAX package) must agree; the bundle adjustment of the rotating
     views on the card (BA_ON_HOST=False) and on the host must agree, the
     host's in C (``ba_pairs.calls`` > 0; none on the card), its cameras
     and LM iterations those of the host's torch chain (within rel 1e-9,
     equal), and two card runs bit for bit, as must two runs of the card's
     normal-equation assembly at 5, 38 (the headline's) and 100 cameras;
     BRIEF descriptors and matches of two headline views on the card must
     equal the CPU's bit for bit;
  6. TRANS path: stitch_images in TRANS mode over the strip, with every
     kernel's launch count read around this run alone; every adjacent pair
     must connect, the canvas must have the expected size, each pairwise
     transform must recover its views' true offset and the chain must
     place every view within CHAIN_LIMIT_PX of it;
  7. main path: stitch_images with the default Config (the caps of
     bench.py) over the headline set, counts read around this run alone
     (the host LM in C, ``ba_pairs.calls`` > 0, and the torch chain on the
     same graph taking as many LM iterations to the same cameras within
     rel 1e-9):
     every pair adjacent in the sweep must connect, the canvas must be
     within 5% of the size the true focal and sweep give, and the cameras
     must pass bench.py's quality gate (mean reprojection error of the
     adjacent pairs against the true homographies under 2.5 px);
  8. multiband path: the main path again at the band count of the
     benchmark's multiband configuration
     (``benchmark/configs/camera_multiband.json``, 5), counts read around
     this run alone: the main path's gates, the linear canvas's size, NCC
     above 0.97 against it, the wall, the ``blend`` stage and the
     multiband's two stage timers, the peak device memory, and the share of
     canvas pixels more than one u8 level off the float64 multiband
     reference's (``benchmark/reference_multiband.py``) under the cell's
     ``canvas_bad`` limit (``benchmark/limits/``);
  9. CLI: the headline views written as PNG files and a config file with
     every reference knob at its default and the headline caps;
     ``cli.main`` with ``--seed 1`` and ``--dump-matchinfo``, counts read
     around this run alone: the PNG it writes must equal the crop of the
     main path's canvas bit for bit; again with ``--load-matchinfo``: the
     same canvas size, equal valid masks, a u8 difference of at most 1;
  10. host-stream path: the main path with ``OPENPANO_HBM_BUDGET_GB=1.0``,
     so that the 1.54 GB paired stack stays in host memory (features batch
     by batch, the blend in 7 column bands), counts read around this run
     alone: the main path's gates, and against the main path's canvas the
     same size, valid masks agreeing on >= 99.9%, a u8 difference of at
     most 1;
  11. blend memory: the host-stream linear and multiband blends (7 bands)
     against the in-memory blends of the uploaded stack on the main and
     multiband paths' plans: each host-stream peak device memory below its
     in-memory counterpart's, canvases within 1e-4 where both are valid,
     valid masks agreeing on >= 99.9%;
  12. CYLINDER path: the headline views in sweep order in CYLINDER mode,
     FOCAL_LENGTH set so that the cylinder's radius is the views' true
     focal, counts read around this run alone: the canvas within 5% of the
     size the true yaws give, a valid fraction above 0.3, a non-empty crop;
  13. mesh path: ``init_distributed(device="cuda")`` at world size 1 (one
     NCCL rank, a file:// store), then (a) ``stitch_images(mesh=)`` on the
     headline, (b) the same at phase 8's band count (5), (c)
     ``stitch_cylinder(mesh=)`` and (d) (a) with
     OPENPANO_SHARDED_BLEND_HOST=1, counts and collective
     bytes read around each run alone: each run its path's gates, K1 and K2
     launched as often as on its one-device path (10 times), valid masks
     agreeing with that path's on >= 99.95% and a u8 difference of at most
     1; (a)'s cameras within 1e-6 (focal) and 1e-8 (R) of the main path's,
     its bundle adjustment on the card; (d) one band upload and (a)'s
     canvas bit for bit;
  14. transport: (a) the headline through stitch_images with the default
     Config, which takes the transport (grey and residual through the wire
     codec, the chroma streamed in a background thread, the streamed u8
     blend with coded strip downloads), (b) the same with
     STREAM_BLEND=False and (c) with OPENPANO_CODED_DOWNLOAD=0, run in the
     turns a b c c b a, counts read around each run alone: the main
     path's gates, K1 and K2 launched 10
     times, the three canvases and valid masks equal bit for bit; the bytes
     each way (coded against raw), the stage times and the host encode's
     time printed; (d) the host-stream linear blend of (a)'s plan with its
     coded band uploads and strips against coded_wire=False, bit for bit;
     (e) CodedFetch of a canvas-strip plane and of a plane too noisy for the
     cap against a plain .cpu(), bit for bit, with both downloads timed;
     (f) the point-major bundle adjustment (pairs_to_points, ba_optimize)
     of phase 5's rotating views on the card and on the CPU, from phase
     5's cameras: within 1e-9 (focal, relative) and 1e-12 (R); from them
     with the focals 5% long: within 1e-9 (focal) and 1e-10 (R), with the
     CPU's own change of R when the points move by 1e-15 printed beside
     it; two card runs bit for bit, the error lowered;
  15. headline bench: ``openpano_torch.bench.headline.run`` (what
     ``python -m openpano_torch.bench`` runs) on the headline views, in this
     process, counts read around it alone; its JSON line printed; bench.py's
     gates (the canvas shape, a valid share above 0.3, the reprojection
     error under 2.5 px, the multiband NCC above 0.97), K1 and K2 launched
     10 times in each timed run, and its kernel check passed;
  16. UAV strip: ``openpano_torch.bench.giga`` in trans mode at
     GIGA_r04.json's command (500 views of 500x560 at 70% overlap, working
     size 400), run once, counts read around it alone; its JSON line
     printed; every adjacent pair connected, each pairwise offset within 6
     px of the truth, the canvas width within 5% of the true extent, K1 and
     K2 launched once per feature batch (125 times); the chain's drift, the
     canvas height and the valid share printed;
  17. tools: (a) ``bench.profile_sift`` on the first 12 headline views: the
     substage times printed, the whole chunk launching K1 and K2 once
     each (orientation K1 only, descriptor K2 only), a batch of 2 or 4
     once each, and a ``torch.profiler`` trace of a feature batch with its
     device-busy share (printed, not gated); (b) ``bench.feature_batch``
     in this process at OPENPANO_FEATURE_BATCH 1, 4 and 8 over the 38
     headline views: the features bit for bit the same at every size, K1
     and K2 launched ceil(38 / B) times; (c) the times (printed, not
     gated) of the headline's all-pairs match at
     OPENPANO_MATCH_PRECISION=high and unset, and how many matches the
     two settings give apart; (d)
     ``bench.run_test``: the port's CLI in a subprocess on the card, in
     CYLINDER and ESTIMATE_CAMERA mode, each final size within 0.8 of its
     golden; (e) ``bench.ba_sweep`` r2's first schedule on the small set,
     and ``bench.comm_volume.measure`` at one NCCL rank: no collective byte
     in the feature compute, the closed-form bytes per LM iteration.
Every phase before 14 that stitches a uint8 stack without a mesh runs the
transport too (phase 10's without the chroma stream).  Each phase prints
its seconds.  The second-to-last line is the kernel report as JSON; the
last line is the device record.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmark import reference as bench_ref  # noqa: E402
from benchmark import reference_multiband  # noqa: E402
from openpano_torch import Config, stitch_images  # noqa: E402
from openpano_torch import _build, cli, native  # noqa: E402
from openpano_torch.bench import ba_sweep, comm_volume, giga, headline, \
    profile_sift, run_test  # noqa: E402
from openpano_torch.bench import feature_batch as batch_sweep  # noqa: E402
from openpano_torch.bench.headline import camera_error, canvas_ncc, \
    expected_canvas, headline_inputs  # noqa: E402
from openpano_torch.camera import ba_pairs  # noqa: E402
from openpano_torch.camera import bundle_adjuster as tba  # noqa: E402
from openpano_torch.camera.bundle_adjuster import assemble_scatter  # noqa: E402
from openpano_torch.camera.rotation import rodrigues, \
    rotation_to_angle  # noqa: E402
from openpano_torch.camera.estimator import estimate_cameras  # noqa: E402
from openpano_torch.geometry import ransac  # noqa: E402
from openpano_torch.match.matcher import match_all_pairs  # noqa: E402
from openpano_torch.ops import windows  # noqa: E402
from openpano_torch.io import wirecodec  # noqa: E402
from openpano_torch.io.image import read_img_u8, write_rgb  # noqa: E402
from openpano_torch.ops.imgproc import crop_with_mask  # noqa: E402
from openpano_torch.parallel import init_distributed, make_mesh  # noqa: E402
from openpano_torch.parallel import mesh as pmesh  # noqa: E402
from openpano_torch.sift import brief, detector, extrema  # noqa: E402
from openpano_torch.stitch import render, stitcher  # noqa: E402
from openpano_torch.stitch.cylstitcher import stitch_cylinder  # noqa: E402
from openpano_torch.stitch.multiband import _roi_sizes, blend_multiband, \
    blend_multiband_host_stream  # noqa: E402
from openpano_torch.stitch.render import blend_linear, \
    blend_linear_host_stream, plan_render  # noqa: E402
from openpano_torch.stitch.stitcherbase import compute_features, \
    feature_batch, grey_u8  # noqa: E402
from openpano_torch.stitch.warp import make_projector  # noqa: E402
from openpano_torch.synth import procedural_scene_large, render_views, \
    strip_views  # noqa: E402
from openpano_torch.utils import prng, timer  # noqa: E402

# the headline sweep of bench.py (photo scene there, procedural here)
N_VIEWS, VIEW_W, VIEW_H = (headline.FULL.n, headline.FULL.out_w,
                           headline.FULL.out_h)
OVERLAP = 0.4                   # the TRANS strip's
HEADLINE = dict(MAX_KP_PER_IMAGE=2048, MAX_MATCHES_PER_PAIR=1024)
REPROJ_LIMIT_PX = headline.REPROJ_LIMIT_PX
GATE = 1e-4                     # max|a-b| / max|b|, kernel vs plain
# the RANSAC kernel against the card's plain chain, whose sums take its
# libraries' orders: a match on the threshold's edge may fall the other
# way and move a pair's best hypothesis, so the winners (inlier count,
# success, inliers) agree on this share of the pairs; the transforms of
# the pairs that agree lie within RANSAC_GAP_PX over their inliers (a
# build summing in orders of its own put them 0.079 px apart on an H100)
RANSAC_AGREE = 0.99
RANSAC_GAP_PX = 0.25
# the chained placement on this strip is off by 24.98 px at most (H100 runs
# of this script); the limit leaves twice that
CHAIN_LIMIT_PX = 50.0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
SMALL = dict(RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
             MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
             MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
             SIFT_WORKING_SIZE=400)
TRANS = dict(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True)
CYLINDER = dict(CYLINDER=True, ESTIMATE_CAMERA=False, ORDERED_INPUT=True)
MB_NCC_LIMIT = headline.MB_NCC_LIMIT   # multiband against linear
BENCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "benchmark")
# the multiband benchmark cell's configuration (its band count) and limits
MB_CONFIG = os.path.join(BENCH_DIR, "configs", "camera_multiband.json")
MB_LIMITS = os.path.join(BENCH_DIR, "limits",
                         "camera_multiband.cmu0_unordered38.json")
with open(MB_CONFIG) as _f:
    MB_BANDS = json.load(_f)["program"]["MULTIBAND"]   # phases 8 and 13
HOST_BUDGET_GB = "1.0"          # the host-stream path's OPENPANO_HBM_BUDGET_GB
HOST_GROUPS = 7                 # its bands: ceil(1.54 GB / (1.0 GB / 4))
MESH_VALID_AGREE = 0.9995       # tests/test_parallel.py:61, mesh against one
# GIGA_r04.json's UAV strip (its "cmd"), run once by phase 16
UAV_ARGV = ["--images", "500", "--size", "500", "560", "--overlap", "0.7",
            "--working-size", "400"]

# name, wrapper (holds the launch count), kernel, plain version, TPU kernel
KERNELS = (
    ("orientation_histogram", windows.orientation_histogram, "ori_hist_cuda",
     windows.ori_hist_plain, "openpano_tpu/ops/windows.py:238"),
    ("descriptor_histogram", windows.descriptor_histogram, "desc_hist_cuda",
     windows.desc_hist_plain, "openpano_tpu/ops/windows.py:459"),
)
SLAB = ("gather_window_slabs", windows.gather_window_slabs,
        "openpano_tpu/ops/windows.py:93")
# name, wrapper, what it replaces: no TPU kernel (XLA fused the JAX chain)
EXTREMA = ("detect_extrema", extrema.detect_extrema,
           "none: openpano_tpu/sift/extrema.py is left to XLA")
RANSAC = ("estimate_transform", ransac.estimate_transform,
          "none: openpano_tpu/geometry/ransac.py is left to XLA")
WRAPPERS = [w for _, w, _, _, _ in KERNELS] + [SLAB[1], EXTREMA[1],
                                                 RANSAC[1]]
# the kernels every stitch path launches
ON_PATH = [n for n, _, _, _, _ in KERNELS] + [EXTREMA[0], RANSAC[0]]
# operations each in-window pixel needs: K1 weight (r^2, exp, product),
# bin (scale, add, floor, wrap) and the add into the bin; K2 the rotation
# and division by the bin width, three bin coordinates, the weight, the
# orientation wrap, and 8 trilinear corners of 3 products and an add each
OPS_PER_PIXEL = {"orientation_histogram": 10, "descriptor_histogram": 60}
# input bytes an active keypoint needs besides its active byte: s, y, x
# int32 and its floats (K1 rad, invden, h, w; K2 radius, hist_w, dir, h, w:
# the kernel's cos and sin follow from dir)
KP_BYTES = {"orientation_histogram": 12 + 4 * 4,
            "descriptor_histogram": 12 + 5 * 4}


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single runs by CUDA events, each after a write of
    more than the 50 MB L2: the main path finds the windows cold.  The
    write (about 0.1 ms) also keeps the card busy while the host reaches
    the launch, so host time does not fall between the events."""
    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def window_need(name: str, args) -> tuple[int, int, int]:
    """(distinct plane pixels, pixel visits, active keypoints) the function
    needs for these inputs: active keypoints' window pixels inside every
    mask."""
    mag = args[0]
    S, H, W = mag.shape
    s, y, x = (a.long() for a in args[2:5])
    if name == "orientation_histogram":
        rad, hb, wb, active, R = args[5], args[7], args[8], args[9], args[10]
        lo, hi = -R, R - 1
    else:
        rad, hw, co, si = args[5], args[6], args[7], args[8]
        hb, wb, active, R = args[10], args[11], args[12], args[13]
        lo, hi = -R, R
    ids = torch.nonzero(active).flatten()
    d = torch.arange(lo, hi + 1, device=mag.device, dtype=torch.float32)
    dy, dx = d.view(1, -1, 1), d.view(1, 1, -1)
    col = lambda v: v[ids].float().view(-1, 1, 1)
    r = col(rad)
    if name == "orientation_histogram":
        inside = ((dy >= -r) & (dy <= r - 1) & (dx >= -r) & (dx <= r - 1)
                  & (dy * dy + dx * dx <= r * r))
    else:
        x_rot = (dx * col(co) + dy * col(si)) / col(hw)
        y_rot = (-dx * col(si) + dy * col(co)) / col(hw)
        inside = ((dy.abs() <= r) & (dx.abs() <= r)
                  & (dy * dy + dx * dx <= r * r)
                  & (x_rot >= -2.5) & (x_rot <= 1.5)
                  & (y_rot >= -2.5) & (y_rot <= 1.5))
    py = y[ids].view(-1, 1, 1) + dy.long()
    px = x[ids].view(-1, 1, 1) + dx.long()
    inside &= ((px >= 1) & (px <= col(wb) - 2) & (py >= 1)
               & (py <= col(hb) - 2))
    flat = (s[ids].view(-1, 1, 1) * H + py) * W + px
    mark = torch.zeros(S * H * W, dtype=torch.bool, device=mag.device)
    mark[flat[inside]] = True
    return int(mark.sum()), int(inside.sum()), int(ids.numel())


def random_case(name: str, real):
    """Seeded random planes and keypoints at the shapes of ``real``: border
    keypoints, random radii up to the bound, 60% active."""
    g = torch.Generator(device=real[0].device).manual_seed(7)
    mag, ort = real[0], real[1]
    K = real[2].shape[0]
    S, H, W = mag.shape
    dev = mag.device
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    ri = lambda hi: torch.randint(0, hi, (K,), generator=g, device=dev,
                                  dtype=torch.int32)
    R = real[-1]
    planes = (u(S, H, W), u(S, H, W) * (2 * np.pi))
    kp = (ri(S), ri(H), ri(W), (ri(R) + 1).float())
    hb = torch.full((K,), float(H), device=dev)
    wb = torch.full((K,), float(W), device=dev)
    active = u(K) < 0.6
    if name == "orientation_histogram":
        return (*planes, *kp, u(K) * 0.1 + 0.005, hb, wb, active, R)
    dirv = u(K) * (2 * np.pi)
    return (*planes, *kp, u(K) * 3.5 + 1.5, torch.cos(dirv), torch.sin(dirv),
            dirv, hb, wb, active, R)


def edge_case(name: str, dev) -> tuple:
    """Crafted planes and keypoints whose pixels land exactly on bin edges.
    K2: direction 0 (cos 1, sin 0) and bin widths 2 and 4, so that
    ybin, xbin = offset / width + 1.5 hit -1 and 3 exactly, and
    orientations on the multiples of 2*pi/8, at 2*pi (hbin 8, which wraps
    to bin 0) and one ulp under it.  K1: orientations on its 36 bin edges,
    at 0, 2*pi and one ulp under 2*pi.  A few slots inactive."""
    S, H, W, K = 2, 96, 128, 64
    g = torch.Generator(device=dev).manual_seed(3)
    two_pi = torch.tensor(2 * np.pi, dtype=torch.float32, device=dev)
    under = torch.nextafter(two_pi, torch.zeros_like(two_pi))[None]
    if name == "orientation_histogram":
        R = 8
        step = torch.arange(36, device=dev) + 0.5
        vals = torch.cat([step * (two_pi / 36), torch.zeros_like(under),
                          two_pi[None], under])
    else:
        R = 19
        vals = torch.cat([torch.arange(9, device=dev) * (two_pi / 8), under])
    n = S * H * W
    ort = vals[torch.arange(n, device=dev) % len(vals)].reshape(S, H, W)
    mag = torch.rand(S, H, W, generator=g, device=dev) + 0.5
    i = torch.arange(K, device=dev)
    s = (i % S).to(torch.int32)
    y = (R + 2 + (i * 7) % (H - 2 * R - 4)).to(torch.int32)
    x = (R + 2 + (i * 13) % (W - 2 * R - 4)).to(torch.int32)
    y[:4] = torch.tensor([1, H - 2, 3, H - 5], dtype=torch.int32)  # borders
    rad = torch.where(i % 3 == 0, float(R), (i % R + 1).float())
    hb = torch.full((K,), float(H), device=dev)
    wb = torch.full((K,), float(W), device=dev)
    active = i % 9 != 4
    if name == "orientation_histogram":
        return (mag, ort, s, y, x, rad, torch.full((K,), 0.02, device=dev),
                hb, wb, active, R)
    zero = torch.zeros(K, device=dev)
    hw = torch.where(i % 2 == 0, 2.0, 4.0).to(dev)
    return (mag, ort, s, y, x, rad, hw, zero + 1.0, zero, zero, hb, wb,
            active, R)


def kernel_typed(args) -> tuple:
    """``args`` already of the types the kernel takes (f32, int32, bool, all
    contiguous), so that the wrapper's casts are no-ops and a timing sees the
    launch alone."""
    def typed(a):
        if not torch.is_tensor(a):
            return a
        if a.dtype != torch.bool:
            a = a.to(torch.float32 if a.is_floating_point() else torch.int32)
        return a.contiguous()
    return tuple(typed(a) for a in args)


def kernel_phase(batches: dict) -> list[dict]:
    """K1 and K2 against their plain versions on the inputs of a feature
    batch of each path (``batches``: path label -> captured arguments), on
    a random case of the same shapes and on the crafted edge case; timed
    at the first path's."""
    report = []
    for name, wrapper, cuda_attr, plain, replaces in KERNELS:
        cuda = getattr(windows, cuda_attr)
        cases = []
        for label, captured in batches.items():
            check(name in captured, f"the {label} path never reached {name}")
            real = captured[name]
            cases += [(f"{label} path", real),
                      (f"{label} random", random_case(name, real))]
        cases.append(("edges", edge_case(name, real[0].device)))
        errs = []
        for case, args in cases:
            a = cuda(*args)
            b = cuda(*args)
            p = plain(*args)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{name} ({case}): two runs differ")
            err = float((a - p).abs().max())
            rel = err / max(float(p.abs().max()), 1e-30)
            print(f"{name} [{case}] K={args[2].shape[0]} "
                  f"planes={tuple(args[0].shape)} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} bit-identical repeat=True")
            check(rel < GATE, f"{name} ({case}): rel err {rel:.3e} >= {GATE}")
            if case.endswith("path"):
                errs.append(err)
        real = next(iter(batches.values()))[name]
        typed = kernel_typed(real)
        ms = median_ms(lambda: cuda(*typed), 50)
        plain_ms = median_ms(lambda: plain(*real), 5)
        distinct, visits, n_active = window_need(name, real)
        K = real[2].shape[0]
        nbins = 36 if name == "orientation_histogram" else 128
        nbytes = (distinct * 8 + K + n_active * KP_BYTES[name]
                  + K * nbins * 4)
        ops = visits * OPS_PER_PIXEL[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        report.append(dict(
            name=name, route="cuda", source="openpano_torch/csrc/windows.cu",
            replaces=replaces, launches=None, max_abs_err=max(errs),
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, on_path=True))
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{report[-1]['bound_ms']:.4f} ms by {report[-1]['bound_by']} "
              f"({n_active}/{K} keypoints active, {distinct} distinct window "
              f"pixels, {visits} visits, {nbytes} B, {ops} ops)")
    return report


def capture_path_inputs(u8: np.ndarray, cfg: Config) -> dict:
    """Run the first feature batch of a path with recorders on the kernel
    launchers; keep each window kernel's first argument tuple and, under
    "detect_extrema", every octave's (octave, config, cap_cand, cap_kp)."""
    captured = {EXTREMA[0]: []}
    saved = {attr: getattr(windows, attr) for _, _, attr, _, _ in KERNELS}
    for name, _, attr, _, _ in KERNELS:
        def rec(*args, _name=name, _fn=saved[attr]):
            captured.setdefault(_name, args)
            return _fn(*args)
        setattr(windows, attr, rec)
    real = detector.detect_extrema

    def rec_extrema(octave, c, cap_cand=None, cap_kp=None):
        captured[EXTREMA[0]].append((octave, c, cap_cand, cap_kp))
        return real(octave, c, cap_cand, cap_kp)

    detector.detect_extrema = rec_extrema
    try:
        compute_features(torch.from_numpy(u8[:feature_batch()]).cuda(), cfg)
    finally:
        for attr, fn in saved.items():
            setattr(windows, attr, fn)
        detector.detect_extrema = real
    return captured


def extrema_phase(batches: dict) -> dict:
    """The extrema kernels against their plain version, bit for bit in every
    field and slot, on every octave of the captured feature batches; times
    of the kernels and the plain version at octave 0 of the first path's,
    with the least time the card could take: the DoG read once and the
    keypoints written once."""
    name, wrapper, replaces = EXTREMA
    for label, captured in batches.items():
        check(captured[name], f"the {label} path never reached {name}")
        for oi, args in enumerate(captured[name]):
            before = wrapper.launches
            a = extrema.detect_extrema(*args)
            b = extrema.detect_extrema(*args)
            p = extrema.detect_extrema_plain(*args)
            torch.cuda.synchronize()
            launched = (wrapper.launches - before) // 2
            repeat = all(torch.equal(u, v) for u, v in zip(a, b))
            same = all(torch.equal(u, v) for u, v in zip(a, p))
            print(f"{name} [{label} octave {oi}] dog="
                  f"{tuple(args[0].dog.shape)} caps={args[2]},{args[3]} "
                  f"keypoints={int(a.valid.sum())} launches a call="
                  f"{launched} bit-equal to plain={same} "
                  f"bit-identical repeat={repeat}")
            check(repeat, f"{name} ({label}, octave {oi}): two runs differ")
            check(same, f"{name} ({label}, octave {oi}): differs from its "
                  "plain version")
            check(launched <= 3, f"{name}: {launched} launches a call")
    args = next(iter(batches.values()))[name][0]
    ms = median_ms(lambda: extrema.detect_extrema(*args), 50)
    plain_ms = median_ms(lambda: extrema.detect_extrema_plain(*args), 5)
    B = args[0].dog.shape[0]
    nbytes = args[0].dog.numel() * 4 + B * args[3] * (3 * 8 + 3 * 4 + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{name}: kernels {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms by bytes (dog {tuple(args[0].dog.shape)}, "
          f"{nbytes} B)")
    return dict(name=name, route="cuda", source="openpano_torch/csrc/extrema.cu",
                replaces=replaces, launches=None, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, on_path=True)


def capture_ransac_inputs(u8: np.ndarray, cfg: Config) -> tuple:
    """What the stitch path of ``cfg`` hands ``estimate_transform_batch``
    for the views ``u8`` on the card: (match result, pos, valid, whs, ii,
    jj) of the pairs its matching keeps, their keys, the configuration and
    ``affine``."""
    feats = compute_features(u8, cfg, dev="cuda")
    whs = torch.tensor([[u8.shape[2], u8.shape[1]]] * u8.shape[0],
                       dtype=torch.float32, device="cuda")
    real, seen = stitcher.estimate_transform_batch, []

    def rec(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    stitcher.estimate_transform_batch = rec
    try:
        stitcher.build_pairwise_graph(feats, whs, cfg,
                                      prng.key((0, 7), "cuda"),
                                      ordered=cfg.ORDERED_INPUT,
                                      affine=cfg.TRANS)
    finally:
        stitcher.estimate_transform_batch = real
    check(len(seen) == 1, f"{len(seen)} RANSAC calls for one graph")
    (args, kw), = seen
    return args[:6], kw["keys"], cfg, args[8]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def inlier_counts(info) -> torch.Tensor:
    """The best hypothesis's inlier count of each pair: ``count`` where it
    connects, ``-confidence`` where it fails."""
    return torch.where(info.count > 0, info.count.double(),
                       -info.confidence.double()).round().long()


def homography_gaps(Ha, Hb, pts, w) -> np.ndarray:
    """Each pair's largest distance between the images of its rows ``pts``
    [P, M, 2] where ``w`` [P, M] is set, under Ha and under Hb, in
    float64 (0 for a pair with no such row)."""
    Ha, Hb, pts = (np.asarray(a.cpu(), np.float64) for a in (Ha, Hb, pts))
    d = np.linalg.norm(bench_ref.apply_h(Ha, pts) - bench_ref.apply_h(Hb, pts),
                       axis=-1)
    return np.where(w.cpu().numpy(), d, 0.0).max(axis=1)


def ransac_flops(res, nh: int, affine: bool) -> int:
    """Floating-point operations of the kernel's hypotheses, counting every
    one healthy: a fit of ns drawn rows (the scales' sums, the normal
    matrix's lower triangle and right-hand side by multiply-adds over the
    2 ns stacked rows, the Cholesky factor and two triangular solves) and
    the projection and test of every row up to the pair's last valid one
    (3 x 4 for the product, 2 divisions, 2 differences, 2 squares, an add
    and the comparison: 20)."""
    ns, npar = (7, 6) if affine else (8, 8)
    fit = (2 * ns * 3 + 2 * ns * (npar * (npar + 1) // 2 + npar) * 2
           + 2 * npar ** 3 // 3 + 2 * npar ** 2 + 36)
    M = res.valid.shape[1]
    last = (res.valid * torch.arange(1, M + 1, device=res.valid.device)
            ).amax(dim=1)
    return int(nh * (fit * res.valid.shape[0] + 20 * int(last.sum())))


def ransac_phase(batches: dict) -> dict:
    """The RANSAC kernel on each path's pairs (``batches``: path label ->
    :func:`capture_ransac_inputs`): one launch a call, two calls
    bit-identical; each connected pair's transform within the cmu0 cell's
    ``refit_px`` limit of a float64 refit of its own inliers; against the
    plain chain on the same card tensors, which sums in its libraries'
    orders, the best hypothesis's inlier count, success and inliers equal
    on at least RANSAC_AGREE of the pairs and the transforms of those that
    connect within RANSAC_GAP_PX over their inliers, the pairs equal bit
    for bit reported.  Times of the kernel and the plain chain on the
    first path's pairs, with the least time the card could take."""
    name, wrapper, replaces = RANSAC
    with open(os.path.join(BENCH_DIR, "limits",
                           "camera_linear.cmu0_unordered38.json")) as f:
        refit_limit = json.load(f)["refit_px"]
    worst = dict(refit=0.0, gap=0.0)
    for label, (args, keys, cfg, affine) in batches.items():
        res, pos, valid, whs, ii, jj = args
        call = lambda: ransac.estimate_transform_batch(
            *args, None, cfg, affine, keys=keys)
        before = wrapper.launches
        a, b = call(), call()
        torch.cuda.synchronize()
        launched = (wrapper.launches - before) / 2
        check(launched == 1, f"{name} ({label}): {launched} launches a call")
        check(all(same_bits(u, v) for u, v in zip(a, b)),
              f"{name} ({label}): two runs differ")
        p = ransac.estimate_transform_batch_plain(*args, keys, cfg, affine)
        P = len(ii)
        ok = a.count > 0
        check(int(ok.sum()) > 0, f"{name} ({label}): no pair connects")
        want = torch.as_tensor(bench_ref.refit(
            a.to_pos.cpu().numpy(), a.from_pos.cpu().numpy(),
            a.valid.cpu().numpy(), affine))
        refit = float(homography_gaps(a.homo, want, a.from_pos,
                                      a.valid).max())
        agree = (inlier_counts(a) == inlier_counts(p)) & (ok == (p.count > 0))
        for u, v in ((a.to_pos, p.to_pos), (a.from_pos, p.from_pos),
                     (a.valid, p.valid)):
            agree &= (u == v).reshape(P, -1).all(dim=1)
        both = agree & ok
        gap = homography_gaps(a.homo[both], p.homo[both], a.from_pos[both],
                              a.valid[both])
        gap = float(gap.max()) if gap.size else 0.0
        equal = sum(all(same_bits(f[k], g[k]) for f, g in zip(a, p))
                    for k in range(P))
        print(f"{name} [{label}] affine={affine} pairs={P} M="
              f"{res.idx.shape[1]} connect={int(ok.sum())} launches a call="
              f"1 bit-identical repeat=True refit_px={refit:.4g} (limit "
              f"{refit_limit}) against the card's plain chain: inlier count, "
              f"success and inliers equal on {int(agree.sum())}, largest "
              f"transform gap {gap:.4g} px, bit-equal on {equal}")
        check(refit < refit_limit, f"{name} ({label}): refit_px {refit:.4g}")
        check(float(agree.float().mean()) >= RANSAC_AGREE,
              f"{name} ({label}): the plain chain's best differs on "
              f"{P - int(agree.sum())} of {P} pairs")
        check(gap < RANSAC_GAP_PX, f"{name} ({label}): transforms {gap:.4g} "
              f"px from the plain chain's")
        worst = dict(refit=max(worst["refit"], refit),
                     gap=max(worst["gap"], gap))
    args, keys, cfg, affine = next(iter(batches.values()))
    ms = median_ms(lambda: ransac.estimate_transform_batch(
        *args, None, cfg, affine, keys=keys), 20)
    plain_ms = median_ms(lambda: ransac.estimate_transform_batch_plain(
        *args, keys, cfg, affine), 3)
    ops = ransac_flops(args[0], cfg.RANSAC_ITERATIONS, affine)
    bound_ms = ops / F32_FLOPS_PER_S * 1e3
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms by operations ({len(args[4])} pairs, "
          f"{cfg.RANSAC_ITERATIONS} hypotheses, {ops} flops; torch "
          f"{torch.__version__}, cuBLAS {cublas_version()})")
    return dict(name=name, route="cuda", source="openpano_torch/csrc/ransac.cu",
                replaces=replaces, launches=None, max_abs_err=worst["gap"],
                refit_px=worst["refit"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", library_ms=None,
                on_path=True)


def cublas_version() -> str:
    """The cuBLAS that PyTorch loads, by its wheel's version, or "unknown"
    where no such wheel is installed."""
    from importlib import metadata
    for dist in ("nvidia-cublas-cu12", "nvidia-cublas"):
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            pass
    return "unknown"



def slab_case(dev):
    """Seeded random K3 case: planes of sizes no multiple of 8 or 128,
    keypoints on every border and past it, planes out of range."""
    g = torch.Generator(device=dev).manual_seed(11)
    S, H, W, K = 6, 203, 397, 4096
    a = torch.rand(S, H, W, generator=g, device=dev)
    b = torch.rand(S, H, W, generator=g, device=dev)
    ri = lambda lo, hi: torch.randint(lo, hi, (K,), generator=g, device=dev,
                                      dtype=torch.int32)
    s, y, x = ri(-2, S + 2), ri(-8, H + 8), ri(-8, W + 8)
    y[:4] = torch.tensor([0, H - 1, 0, H - 1], dtype=torch.int32)
    x[:4] = torch.tensor([0, 0, W - 1, W - 1], dtype=torch.int32)
    return a, b, s, y, x


def slab_phase(desc_args) -> dict:
    """K3 against its plain version, bit for bit, on the planes and the
    descriptor keypoints of the captured feature batch and on a random
    case; times of the kernel, the plain version and the one indexing call
    that computes the same slabs from planes padded beforehand."""
    name, _, replaces = SLAB
    WR = windows.slab_rows(desc_args[-1])
    real = tuple(v.contiguous() for v in desc_args[:2]) + tuple(
        v.to(torch.int32).contiguous() for v in desc_args[2:5])
    for case, args in (("path", real), ("random", slab_case(real[0].device))):
        a1 = windows.win2_cuda(*args, WR)
        a2 = windows.win2_cuda(*args, WR)
        p = windows.win2_plain(*args, WR)
        torch.cuda.synchronize()
        for k in (0, 1):
            check(torch.equal(a1[k], a2[k]), f"{name} ({case}): two runs differ")
            check(torch.equal(a1[k], p[k]), f"{name} ({case}): differs from "
                  "its plain version")
        print(f"{name} [{case}] K={args[2].shape[0]} planes="
              f"{tuple(args[0].shape)} WR={WR} bit-equal to plain, "
              f"bit-identical repeat=True")
    a, b, s, y, x = real
    S, H, W = a.shape
    K = s.shape[0]
    ab = torch.stack([windows.pad_planes(a, WR), windows.pad_planes(b, WR)])
    idx = windows.slab_index(S, H, W, s, y, x, WR)
    lib = ab[:, idx[0], idx[1], idx[2]]
    out = windows.win2_cuda(*real, WR)
    check(torch.equal(lib[0], out[0]) and torch.equal(lib[1], out[1]),
          f"{name}: the indexing call computes other slabs")
    del lib, out
    ms = median_ms(lambda: windows.win2_cuda(*real, WR), 50)
    plain_ms = median_ms(lambda: windows.win2_plain(*real, WR), 10)
    library_ms = median_ms(lambda: ab[:, idx[0], idx[1], idx[2]], 10)
    # distinct in-plane pixels the slabs cover, read once from each plane
    inb = (idx[1] < H) & (idx[2] < W)
    flat = (idx[0] * H + idx[1].clamp(max=H - 1)) * W + idx[2].clamp(max=W - 1)
    mark = torch.zeros(S * H * W, dtype=torch.bool, device=a.device)
    mark[flat.expand(K, WR, windows.SLAB_LANES)[inb]] = True
    distinct = int(mark.sum())
    nbytes = distinct * 8 + K * 12 + 2 * K * WR * windows.SLAB_LANES * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
          f"(one indexing call) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by bytes ({K} keypoints, WR={WR}, {distinct} distinct plane "
          f"pixels, {nbytes} B)")
    return dict(name=name, route="cuda", source="openpano_torch/csrc/windows.cu",
                replaces=replaces, launches=None, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=library_ms, on_path=False)


def compare_card_cpu(label: str, views: np.ndarray, cfg: Config):
    """Stitch ``views`` on the card and on the CPU; the two must agree.
    Returns the card run's info."""
    out = {}
    for dev in ("cuda", "cpu"):
        info = {}
        canvas, valid = stitch_images(views, cfg, output="u8", device=dev,
                                      info_out=info)
        out[dev] = (canvas.astype(np.float64), valid, info)
    (gc, gv, gi), (cc, cv, ci) = out["cuda"], out["cpu"]
    check(gc.shape == cc.shape, f"{label}: canvas {gc.shape} vs {cc.shape}")
    kdiff = np.abs(gi["kpt_counts"] - ci["kpt_counts"]) / ci["kpt_counts"]
    ncc = canvas_ncc(gc, gv, cc, cv)
    agree = float((gv == cv).mean())
    print(f"reference [{label}]: canvas {gc.shape[:2]}, keypoints card "
          f"{gi['kpt_counts'].tolist()} cpu {ci['kpt_counts'].tolist()}, "
          f"valid agree {agree:.6f}, NCC {ncc:.6f}")
    check(kdiff.max() <= 0.02, f"{label}: keypoint counts differ by >2%")
    if "graph" in gi:
        pairs = lambda i: set(zip(*np.nonzero(np.triu(i["graph"].conf > 0,
                                                      1))))
        print(f"reference [{label}]: pairs {sorted(pairs(gi))}")
        check(pairs(gi) == pairs(ci), f"{label}: connected pairs differ")
    if "hfactor" in gi:
        print(f"reference [{label}]: h-factor card {gi['hfactor']} "
              f"({gi['trials']} trials, slope {gi['slope']:.6f}) cpu "
              f"{ci['hfactor']} ({ci['trials']} trials, slope "
              f"{ci['slope']:.6f})")
        check(gi["hfactor"] == ci["hfactor"], f"{label}: h-factors differ")
    check(agree >= 0.999 and ncc >= 0.999, f"{label}: canvases disagree")
    if "cams" in gi:
        rel = np.abs(gi["cams"].focal / ci["cams"].focal - 1).max()
        print(f"reference [{label}]: focal card "
              f"{np.round(gi['cams'].focal, 3).tolist()} cpu "
              f"{np.round(ci['cams'].focal, 3).tolist()} (max rel {rel:.2e}), "
              f"LM iterations {gi['lm_iters']} / {ci['lm_iters']}, ba_rms_px "
              f"{gi['ba_rms_px']:.6f} / {ci['ba_rms_px']:.6f}")
        check(rel < 0.01, f"{label}: focals differ by 1% or more")
    return gi


def reference_phase():
    """The TRANS strip, the default-Config rotating views and a CYLINDER +
    multiband sweep on the card and on the CPU; the bundle adjustment on
    the card and on the host.  Returns the rotating views' card run info
    and their host cameras."""
    views = np.round(strip_views(4, 320, 240, overlap=0.5, seed=0) * 255
                     ).astype(np.uint8)
    gi = compare_card_cpu("TRANS strip", views, Config(**TRANS, **SMALL))
    check(set(zip(*np.nonzero(np.triu(gi["graph"].conf > 0, 1))))
          >= {(0, 1), (1, 2), (2, 3)}, "TRANS strip: adjacent pairs missing")

    rot, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                          out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    rot = np.round(rot[[2, 0, 4, 1, 3]] * 255).astype(np.uint8)
    cfg = Config(**SMALL)
    ref = compare_card_cpu("default Config", rot, cfg)
    g = ref["graph"]
    whs = np.repeat([[320.0, 240.0]], 5, 0)
    args = (g.conf, g.homo, g.to_pos, g.from_pos, g.valid, whs)
    runs = []
    for on_host in (True, False, False):
        st = {}
        ba_pairs.calls = 0
        t0 = time.perf_counter()
        cams = estimate_cameras(*args, cfg.replace(BA_ON_HOST=on_host),
                                stats=st, device="cuda")
        runs.append((cams, st, time.perf_counter() - t0, ba_pairs.calls))
    (h, hs, ht, hcalls), (c1, cs, ct, ccalls), (c2, _, _, _) = runs
    frel = float(np.abs(c1.focal / h.focal - 1).max())
    rabs = float(np.abs(c1.R - h.R).max())
    print(f"bundle adjustment: host {hs['lm_iters']} LM iterations "
          f"{ht:.3f} s ({hcalls} calls into C), card {cs['lm_iters']} LM "
          f"iterations {ct:.3f} s ({ccalls}); focal max rel diff "
          f"{frel:.3e}, R max abs diff {rabs:.3e}")
    check(hcalls > 0 and ccalls == 0,
          "the host LM did not run in C, or the card's did")
    check(frel < 1e-6 and rabs < 1e-6, "card and host cameras differ")
    check(np.array_equal(c1.focal, c2.focal) and np.array_equal(c1.R, c2.R),
          "two card runs of the bundle adjustment differ")
    host_lm_check("rotating views", args, cfg, h, hs)
    for n in (5, N_VIEWS, 100):
        assembly_repeat(n)

    # 6 views in sweep order: the flat-projection multiband blend and the
    # perspective correction (seed 2: the scene of tests/test_torch_cylinder)
    cyl, _ = render_views(procedural_scene_large(600, 2400, seed=2), 6,
                          out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    cyl = np.round(cyl * 255).astype(np.uint8)
    compare_card_cpu("CYLINDER + MULTIBAND=2", cyl,
                     Config(**CYLINDER, MULTIBAND=2, **SMALL))
    return ref, h


@contextlib.contextmanager
def torch_chain():
    """The host LM on the torch chain (the card's route) in place of its C
    routine, for a comparison."""
    saved = tba._host_route
    tba._host_route = lambda t: False
    try:
        yield
    finally:
        tba._host_route = saved


def host_lm_check(label: str, args: tuple, cfg: Config, cams, stats: dict):
    """``estimate_cameras(*args, cfg)`` on the host's torch chain: as many
    LM iterations as the C routine's run that gave ``cams`` / ``stats``,
    and the same cameras within rel 1e-9."""
    st = {}
    t0 = time.perf_counter()
    with torch_chain():
        want = estimate_cameras(*args, cfg, stats=st)
    secs = time.perf_counter() - t0
    frel = float(np.abs(cams.focal / want.focal - 1).max())
    rabs = float(np.abs(cams.R - want.R).max())
    print(f"host LM [{label}]: C {stats['lm_iters']} iterations "
          f"{stats['lm_time_s']:.3f} s, torch chain {st['lm_iters']} "
          f"iterations {st['lm_time_s']:.3f} s ({secs:.3f} s in all); focal "
          f"max rel diff {frel:.3e}, R max abs diff {rabs:.3e}")
    check(stats["lm_iters"] == st["lm_iters"],
          f"{label}: the C routine and the torch chain iterate differently")
    check(frel < 1e-9 and rabs < 1e-9,
          f"{label}: the C routine's cameras differ from the torch chain's")


def brief_phase(u8: np.ndarray, perm: np.ndarray):
    """BRIEF on two headline views adjacent in the sweep, at the keypoints
    the card's features give them: descriptors and match indices on the
    card equal the CPU's bit for bit."""
    inv_perm = np.argsort(perm)
    pair = u8[[inv_perm[0], inv_perm[1]]]
    cfg = Config(**HEADLINE)
    imgs = torch.from_numpy(pair).cuda()
    feats = compute_features(imgs, cfg)
    grey = grey_u8(imgs)
    pts = feats.pos + torch.tensor([VIEW_W / 2.0, VIEW_H / 2.0], device="cuda")
    pat = brief.gen_brief_pattern(0)
    out = {}
    for dev in ("cuda", "cpu"):
        g, p, v = (t.to(dev) for t in (grey, pts, feats.valid))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        da, va = brief.compute_brief(g[0], p[0], v[0], pat.offsets, pat.s)
        db, vb = brief.compute_brief(g[1], p[1], v[1], pat.offsets, pat.s)
        m = brief.match_brief(da, va, db, vb, cfg)
        torch.cuda.synchronize()
        out[dev] = ([t.cpu() for t in (da, va, db, vb, *m)],
                    time.perf_counter() - t0)
    (card, t_card), (cpu, t_cpu) = out["cuda"], out["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(card, cpu))
    print(f"BRIEF: {int(card[1].sum())} / {int(card[3].sum())} descriptors of "
          f"{feats.valid.shape[1]} slots, {int(card[-1][0])} matches; card "
          f"equals the CPU bit for bit: {same} (card {t_card:.3f} s, CPU "
          f"{t_cpu:.3f} s, descriptors and matching)")
    check(same, "BRIEF on the card differs from the CPU")
    check(int(card[-1][0]) > 0, "BRIEF: no match between adjacent views")


def assembly_repeat(n: int):
    """The card's JtJ / Jtb assembly (an accumulating index_put_) on
    seeded f64 blocks of every pair of n cameras: two runs bit-identical,
    and equal to the CPU's slot-order sum up to rounding."""
    g = torch.Generator().manual_seed(n)
    a, b = np.triu_indices(n, 1)
    P = a.size
    J = torch.randn(P, 40, 12, generator=g, dtype=torch.float64) * 1e3
    Bp = J.transpose(1, 2) @ J
    bp = torch.randn(P, 12, generator=g, dtype=torch.float64) * 1e4
    offs = torch.arange(6)
    rows = torch.cat([torch.as_tensor(a)[:, None] * 6 + offs,
                      torch.as_tensor(b)[:, None] * 6 + offs], 1)
    cpu = assemble_scatter(Bp, bp, rows, n * 6)
    args = (Bp.cuda(), bp.cuda(), rows.cuda(), n * 6)
    r1, r2 = assemble_scatter(*args), assemble_scatter(*args)
    same = all(torch.equal(x, y) for x, y in zip(r1, r2))
    rel = max(float((x.cpu() - y).abs().max() / y.abs().max())
              for x, y in zip(r1, cpu))
    print(f"JtJ assembly on the card, {n} cameras, {P} pair slots: two runs "
          f"bit-identical={same}, max rel diff from the CPU {rel:.3e}")
    check(same, "two card runs of the JtJ assembly differ")
    check(rel < 1e-12, "the card's JtJ assembly differs from the CPU's")


def reset_counts():
    for w in WRAPPERS:
        w.launches = 0
    ba_pairs.calls = 0


def read_counts() -> dict:
    return {n: w.launches for n, w in
            [(n, w) for n, w, _, _, _ in KERNELS] + [SLAB[:2], EXTREMA[:2],
                                                     RANSAC[:2]]}


def drive(label: str, u8: np.ndarray, cfg: Config, key=None,
          entry=stitch_images, **kw):
    """``entry`` (stitch_images) once over ``u8``, u8 out, with every launch
    count set to 0 just before and read just after; prints the wall, the
    stages, the peak device memory and the launches, and fails if a kernel
    of the path never launched.  ``kw`` goes to ``entry`` (``mesh``).
    Returns (canvas, valid, info, launches); info holds the stage times as
    ``stages_s`` and the bytes through each collective as
    ``collective_bytes``."""
    reset_counts()
    pmesh.reset_bytes()
    timer.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = {}
    canvas, valid = entry(u8, cfg, key=key, output="u8", info_out=info, **kw)
    wall = time.perf_counter() - t0
    launches = read_counts()
    stages = {k: round(s, 4) for k, (_, s) in timer.totals().items()}
    info.update(stages_s=stages, wall_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                collective_bytes=dict(pmesh.BYTES))
    print(f"{label}: {wall:.3f} s wall, {len(u8) / wall:.2f} img/s, peak "
          f"device memory {info['peak_gib']:.2f} GiB")
    print(f"{label} stages_s: {json.dumps(stages)}")
    print(f"{label} kernels launched: {json.dumps(launches)}")
    check(all(launches[n] > 0 for n in ON_PATH),
          f"{label}: a kernel of the path never launched")
    return canvas, valid, info, launches


def trans_path(u8: np.ndarray, xy: np.ndarray) -> dict:
    """stitch_images in TRANS mode over the strip, with its gates."""
    cfg = Config(**TRANS)
    canvas, valid, info, launches = drive("TRANS path", u8, cfg)

    conf = info["graph"].conf
    check(all(conf[i, i + 1] > 0 for i in range(N_VIEWS - 1)),
          "TRANS: an adjacent pair did not connect")
    span = xy.max(0) - xy.min(0) + [VIEW_W, VIEW_H]
    scale = min(1.0, cfg.MAX_OUTPUT_SIZE / span.max())
    print(f"TRANS canvas {canvas.shape[1]}x{canvas.shape[0]} (expected "
          f"about {span[0] * scale:.0f}x{span[1] * scale:.0f}), valid "
          f"fraction {valid.mean():.4f}")
    check(canvas.dtype == np.uint8 and canvas.shape[2] == 3,
          "TRANS: canvas is not u8 RGB")
    check(abs(canvas.shape[1] - span[0] * scale) <= 0.01 * span[0] * scale,
          "TRANS: canvas width off")
    check(abs(canvas.shape[0] - span[1] * scale) <= 0.05 * span[1] * scale,
          "TRANS: canvas height off")
    check(valid.mean() > 0.8, "TRANS: canvas mostly empty")
    # placement against the true offsets, as the error of the views'
    # corners: each pairwise affine on its own, and the chain outward from
    # the middle view, where TRANS mode compounds the pairs' small scale and
    # shear errors over up to N/2 hops
    pair_err, chain_err = giga.strip_placement(info, xy, VIEW_W, VIEW_H)
    print(f"TRANS placement: pairwise corner error median "
          f"{np.median(pair_err):.3f} max {max(pair_err):.3f} px; chained "
          f"from the middle view max {chain_err:.3f} px over a {span[0]} px "
          f"strip")
    check(max(pair_err) < 6.0, "TRANS: a pairwise transform is off")
    check(chain_err < CHAIN_LIMIT_PX, "TRANS: views misplaced along the chain")
    return launches


def main_path(u8: np.ndarray, truth: dict, perm: np.ndarray,
              multiband: int = 0, label: str | None = None, mesh=None):
    """stitch_images with the default Config (and ``multiband`` levels)
    over the headline set, with the main path's gates; sharded over
    ``mesh`` when one is given.  Returns (canvas, valid, info, launches)."""
    cfg = Config(MULTIBAND=multiband, **HEADLINE)
    key = prng.key((0, 1), "cuda")                   # PRNGKey(1)
    label = label or ("multiband path" if multiband else "main path")
    canvas, valid, info, launches = drive(label, u8, cfg, key, mesh=mesh)
    calls = ba_pairs.calls
    print(f"bundle adjustment: {info['lm_iters']} LM iterations in "
          f"{info['lm_time_s']:.3f} s ({calls} calls into C), ba_rms_px "
          f"{info['ba_rms_px']:.4f} over {info['ba_pairs']} pairs, "
          f"{info['ba_points']} points; {info['connected_pairs']} connected "
          f"pairs, {info['total_inliers']} inliers")
    if mesh is None:
        # the default stitch runs the LM on the host, in C
        check(calls > 0, f"{label}: the host LM did not run in C")
    if mesh is None and label == "main path":
        g = info["graph"]
        whs = np.repeat([[float(VIEW_W), float(VIEW_H)]], N_VIEWS, 0)
        host_lm_check(label, (g.conf, g.homo, g.to_pos, g.from_pos, g.valid,
                              whs), cfg, info["cams"], info)

    inv_perm = np.argsort(perm)
    conf = info["graph"].conf
    check(all(conf[inv_perm[k], inv_perm[k + 1]] > 0
              for k in range(N_VIEWS - 1)),
          "a pair adjacent in the sweep did not connect")
    want_w, want_h = expected_canvas(truth, cfg)
    reproj = camera_error(info["homos"], truth, perm)
    focal = info["cams"].focal
    print(f"canvas {canvas.shape[1]}x{canvas.shape[0]} (expected {want_w}x"
          f"{want_h}), valid fraction {valid.mean():.4f}, keypoints per view "
          f"{int(info['kpt_counts'].min())}..{int(info['kpt_counts'].max())}, "
          f"focal {focal.min():.2f}..{focal.max():.2f} (true "
          f"{truth['focal_px']:.2f}), mean reprojection error of adjacent "
          f"pairs {reproj:.4f} px")
    check(canvas.dtype == np.uint8 and canvas.shape[2] == 3,
          "canvas is not u8 RGB")
    check(abs(canvas.shape[1] - want_w) <= 0.05 * want_w, "canvas width off")
    check(abs(canvas.shape[0] - want_h) <= 0.05 * want_h, "canvas height off")
    check(valid.mean() > 0.3, "canvas mostly empty")
    check(reproj < REPROJ_LIMIT_PX, f"camera quality gate: {reproj:.3f} px")
    return canvas, valid, info, launches


def multiband_path(u8: np.ndarray, truth: dict, perm: np.ndarray,
                   linear: tuple) -> tuple:
    """The main path at the multiband benchmark configuration's band count:
    its gates, the linear canvas's size, NCC above 0.97 against the linear
    canvas, and the canvas against the float64 multiband reference under
    the cell's ``canvas_bad`` limit.  Returns (canvas, valid, info,
    launches)."""
    with open(MB_LIMITS) as f:
        limit = json.load(f)["canvas_bad"]
    canvas, valid, info, launches = main_path(u8, truth, perm,
                                              multiband=MB_BANDS)
    lin, lin_valid, lin_info = linear
    plan = info["plan"]
    st = info["stages_s"]
    print(f"blend stage: multiband {st['blend']} s ({len(plan.items)} render "
          f"items of {len(plan.whs)} views, RoI planes {_roi_sizes(plan)}; "
          f"multiband.first_level {st['multiband.first_level']} s, "
          f"multiband.levels {st['multiband.levels']} s), linear "
          f"{lin_info['stages_s']['blend']} s")
    check(canvas.shape == lin.shape, f"multiband canvas {canvas.shape} vs "
          f"linear {lin.shape}")
    ncc = canvas_ncc(canvas.astype(np.float64), valid,
                     lin.astype(np.float64), lin_valid)
    print(f"multiband against linear: NCC {ncc:.6f} over "
          f"{(valid & lin_valid).mean():.4f} of the canvas, valid agree "
          f"{(valid == lin_valid).mean():.6f}")
    check(ncc > MB_NCC_LIMIT, f"multiband NCC against linear {ncc:.4f}")
    bad = multiband_reference_bad(u8, info["homos"], canvas, valid, MB_BANDS)
    print(f"multiband {MB_BANDS} bands against the float64 reference: "
          f"{bad:.3g} of the canvas off (limit {limit})")
    check(bad <= limit, f"multiband canvas off the reference: {bad}")
    return canvas, valid, info, launches


def multiband_reference_bad(u8: np.ndarray, homos, canvas: np.ndarray,
                            valid: np.ndarray, bands: int) -> float:
    """The share of canvas pixels more than one u8 level off the float64
    multiband reference's blend of the same views through the same
    transforms, or inside one of the two masks only."""
    n, h, w = u8.shape[:3]
    cfg = Config(MULTIBAND=bands, **HEADLINE)
    pl = reference_multiband.plan(np.asarray(homos, np.float64),
                                  np.repeat([[float(w), float(h)]], n, 0),
                                  n >> 1, "spherical", cfg.MAX_OUTPUT_SIZE)
    want, want_m = reference_multiband.blend(
        torch.as_tensor(u8, device="cuda"), pl,
        {"MULTIBAND": bands, "GAUSS_WINDOW_FACTOR": cfg.GAUSS_WINDOW_FACTOR})
    if tuple(want.shape) != canvas.shape:
        return 1.0
    got = torch.as_tensor(canvas, device="cuda")
    got_m = torch.as_tensor(valid, device="cuda")
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)
    bad = (got_m != want_m) | (got_m & want_m & (diff > 1))
    return float(bad.double().mean())


def u8_agreement(label: str, got: tuple, want: tuple) -> int:
    """Gate two (u8 canvas, valid) results: the same size, valid masks
    agreeing on >= 99.9% of pixels, a u8 difference of at most 1 where both
    are valid.  Returns the largest difference."""
    (cg, vg), (cw, vw) = got, want
    check(cg.shape == cw.shape, f"{label}: canvas {cg.shape} vs {cw.shape}")
    agree = float((vg == vw).mean())
    both = vg & vw
    diff = int(np.abs(cg[both].astype(np.int16)
                      - cw[both].astype(np.int16)).max())
    print(f"{label}: canvas {cg.shape[1]}x{cg.shape[0]}, valid agree "
          f"{agree:.6f}, max u8 difference {diff}, "
          f"{int((cg[both] != cw[both]).any(-1).sum())} pixels differ")
    check(agree >= 0.999, f"{label}: valid masks disagree")
    check(diff <= 1, f"{label}: u8 difference {diff} > 1")
    return diff


def run_cli(argv: list[str]) -> tuple[int, str, tuple, dict, float]:
    """cli.main(argv) with its stdout captured, the launch counts set to 0
    just before and read just after, and the stitcher's uncropped
    (canvas, valid) recorded.  Returns (rc, stdout, result, launches,
    wall)."""
    got = {}
    real = stitcher.stitch

    def recorder(*args, **kw):
        got["result"] = real(*args, **kw)
        return got["result"]

    buf = io.StringIO()
    stitcher.stitch = recorder
    reset_counts()
    timer.reset()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        stitcher.stitch = real
    return rc, buf.getvalue(), got["result"], read_counts(), wall


def cli_phase(u8: np.ndarray, linear: tuple) -> dict:
    """The headline through ``cli.main`` on the card: PNG views, a config
    file, --seed 1, --dump-matchinfo, then --load-matchinfo."""
    canvas, valid, _ = linear
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = []
        for i, view in enumerate(u8):
            files.append(os.path.join(tmp, f"view{i:02d}.png"))
            write_rgb(files[-1], view)
        values = {k: getattr(Config, k) for k in Config.REFERENCE_KNOBS}
        values.update(HEADLINE)
        cfg_path = os.path.join(tmp, "config.cfg")
        with open(cfg_path, "w") as f:
            for k, v in values.items():
                f.write(f"{k} {int(v) if isinstance(v, bool) else v}\n")
        check(cli.load_config(cfg_path) == Config(**HEADLINE),
              "the config file does not read back as the headline Config")
        print(f"CLI inputs: {len(files)} PNG views and the config file in "
              f"{time.perf_counter() - t0:.1f} s")
        out1, out2 = os.path.join(tmp, "a.png"), os.path.join(tmp, "b.png")
        mi = os.path.join(tmp, "matchinfo.txt")
        runs = []
        for extra, out in ((["--dump-matchinfo", mi], out1),
                           (["--load-matchinfo", mi], out2)):
            rc, text, result, launches, wall = run_cli(
                ["-c", cfg_path, "--seed", "1", "-o", out, *extra, *files])
            check(rc == 0, f"CLI exit code {rc}")
            label = "CLI" if extra[0] == "--dump-matchinfo" else \
                "CLI --load-matchinfo"
            print(f"{label}: {wall:.3f} s wall, kernels launched "
                  f"{json.dumps(launches)}")
            for line in text.splitlines():
                if line.startswith(("Stitched in", "metrics:", "Final Image",
                                    "Cropped to", "peak rss", "Loaded",
                                    "Dumped")):
                    print(f"  {line}")
            runs.append((read_img_u8(out), result, launches))
        print(f"matchinfo text: {os.path.getsize(mi)} bytes")
        (png1, res1, launches), (png2, res2, _) = runs
        crop = crop_with_mask(canvas, valid)
        same = png1.shape == crop.shape and np.array_equal(png1, crop)
        print(f"CLI PNG {png1.shape[1]}x{png1.shape[0]} equals the crop of "
              f"the main path's canvas bit for bit: {same}")
        check(same, "the CLI's PNG differs from the main path's crop")
        check(all(launches[n] > 0 for n in ON_PATH),
              "CLI: a kernel of the path never launched")
        check(np.array_equal(res2[1], res1[1]),
              "--load-matchinfo: valid masks differ")
        u8_agreement("CLI --load-matchinfo against CLI", res2, res1)
        print(f"--load-matchinfo canvas equals the first run's bit for bit: "
              f"{np.array_equal(res2[0], res1[0])}; PNGs equal: "
              f"{png1.shape == png2.shape and np.array_equal(png1, png2)}")
    return launches


def host_stream_path(u8: np.ndarray, truth: dict, perm: np.ndarray,
                     linear: tuple) -> tuple[dict, dict]:
    """The main path with OPENPANO_HBM_BUDGET_GB=1.0: the stack stays in
    host memory.  Its band uploads are recorded; gated against the main
    path's canvas.  Returns (launches, info)."""
    canvas, valid, lin_info = linear
    bands = []
    real = render.band_slice

    def recorder(imgs, ids, *a):
        bands.append(len(ids))
        return real(imgs, ids, *a)

    os.environ["OPENPANO_HBM_BUDGET_GB"] = HOST_BUDGET_GB
    render.band_slice = recorder
    try:
        groups = stitcher.host_stream_groups(u8.shape)
        print(f"host-stream trigger: paired stack "
              f"{stitcher.paired_gb(u8.shape):.4f} GB against a "
              f"{HOST_BUDGET_GB} GB budget, fires "
              f"{stitcher.stays_on_host(u8.shape)}, {groups} bands")
        check(stitcher.stays_on_host(u8.shape) and groups == HOST_GROUPS,
              "the host-stream trigger did not fire as predicted")
        hs, hv, info, launches = main_path(u8, truth, perm,
                                           label="host-stream path")
    finally:
        render.band_slice = real
        del os.environ["OPENPANO_HBM_BUDGET_GB"]
    print(f"host-stream path: {len(bands)} band uploads (of {HOST_GROUPS} "
          f"bands, empty ones upload nothing) of {bands} views; "
          f"peak device memory {info['peak_gib']:.2f} GiB against the main "
          f"path's {lin_info['peak_gib']:.2f} GiB; blend stage "
          f"{info['stages_s']['blend']} s against "
          f"{lin_info['stages_s']['blend']} s")
    check(0 < len(bands) <= HOST_GROUPS and max(bands) < len(u8)
          and sum(bands) >= len(u8),
          "the host-stream blend did not stream bands of the stack")
    u8_agreement("host-stream against main path", (hs, hv), (canvas, valid))
    return launches, info


def blend_memory_phase(u8: np.ndarray, lin_plan, mb_plan):
    """The host-stream blends alone against the in-memory blends of the
    uploaded stack, peak device memory reset before each call."""
    def measure(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2**30, base / 2**30)

    for label, plan, mb in (("linear", lin_plan, 0),
                            ("multiband", mb_plan, 2)):
        if mb:
            host = lambda: blend_multiband_host_stream(u8, plan, mb,
                                                       HOST_GROUPS)
        else:
            host = lambda: blend_linear_host_stream(u8, plan, False,
                                                    HOST_GROUPS)
        got, t_host, peak_host, base_host = measure(host)
        stack = torch.from_numpy(u8).cuda()        # the uploaded u8 stack

        def in_memory():
            src = stack.to(torch.float32) / 255.0  # the stitcher's blend stage
            out = (blend_multiband(src, plan, mb) if mb
                   else blend_linear(src, plan, False))
            return out.cpu().numpy()

        want, t_mem, peak_mem, base_mem = measure(in_memory)
        del stack
        vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
        both = vg & vw
        diff = float(np.abs(got[both] - want[both]).max())
        agree = float((vg == vw).mean())
        print(f"blend alone [{label}, {len(plan.items)} items, "
              f"{plan.out_w}x{plan.out_h}]: host stream {t_host:.3f} s, peak "
              f"{peak_host:.3f} GiB (from {base_host:.3f}); in memory "
              f"{t_mem:.3f} s, peak {peak_mem:.3f} GiB (from {base_mem:.3f}, "
              f"the u8 stack on the card); max abs diff {diff:.3e}, valid "
              f"agree {agree:.6f}")
        check(got.shape == want.shape, f"blend alone [{label}]: shapes differ")
        check(peak_host < peak_mem,
              f"blend alone [{label}]: the host stream's peak is not lower")
        check(diff <= 1e-4, f"blend alone [{label}]: canvases differ")
        check(agree >= 0.999, f"blend alone [{label}]: valid masks disagree")


def expected_cylinder_canvas(truth: dict, inv_perm: np.ndarray,
                             cfg: Config) -> tuple[int, int]:
    """(w, h) of the flat canvas the true yaws give in CYLINDER mode: the
    projector of h-factor 1 warps each view to out_w x out_h, and view k
    sits r * (yaw_k - yaw_mid) to the side of the middle view."""
    proj = make_projector(VIEW_W, VIEW_H, 1.0, cfg)
    yaws = truth["yaws"][inv_perm]
    shift = proj.r * (yaws - yaws[N_VIEWS >> 1])
    homos = np.stack([np.array([[1.0, 0.0, d], [0.0, 1.0, 0.0],
                                [0.0, 0.0, 1.0]]) for d in shift])
    whs = np.repeat([[float(proj.out_w), float(proj.out_h)]], N_VIEWS, 0)
    plan = plan_render(homos, whs, N_VIEWS >> 1, "flat", cfg.MAX_OUTPUT_SIZE)
    return plan.out_w, plan.out_h


def cylinder_path(u8: np.ndarray, truth: dict, perm: np.ndarray,
                  mesh=None, label: str = "CYLINDER path"):
    """stitch_images in CYLINDER mode over the headline views in sweep
    order, the cylinder's radius the views' true focal; with ``mesh``,
    ``stitch_cylinder(mesh=)`` (stitch_images drops a mesh in this mode).
    Returns (canvas, valid, info, launches)."""
    inv_perm = np.argsort(perm)
    focal = truth["focal_px"] * 43.266 / np.hypot(VIEW_W, VIEW_H)
    cfg = Config(**CYLINDER, FOCAL_LENGTH=float(focal), **HEADLINE)
    kw = {} if mesh is None else dict(entry=stitch_cylinder, mesh=mesh)
    canvas, valid, info, launches = drive(
        label, u8[inv_perm], cfg, prng.key((0, 1), "cuda"), **kw)
    want_w, want_h = expected_cylinder_canvas(truth, inv_perm, cfg)
    crop = crop_with_mask(canvas, valid)
    print(f"CYLINDER: FOCAL_LENGTH {focal:.4f}, h-factor {info['hfactor']} "
          f"after {info['trials']} trials (slope {info['slope']:.6f}), warped "
          f"views {info['plan'].whs[0].astype(int).tolist()}, canvas "
          f"{canvas.shape[1]}x{canvas.shape[0]} (expected {want_w}x{want_h}), "
          f"valid fraction {valid.mean():.4f}, crop {crop.shape[1]}x"
          f"{crop.shape[0]}, keypoints per view "
          f"{int(info['kpt_counts'].min())}..{int(info['kpt_counts'].max())}")
    check(canvas.dtype == np.uint8 and canvas.shape[2] == 3,
          "CYLINDER: canvas is not u8 RGB")
    check(abs(canvas.shape[1] - want_w) <= 0.05 * want_w,
          "CYLINDER: canvas width off")
    check(abs(canvas.shape[0] - want_h) <= 0.05 * want_h,
          "CYLINDER: canvas height off")
    check(valid.mean() > 0.3, "CYLINDER: canvas mostly empty")
    check(crop.size > 0, "CYLINDER: empty crop")
    return canvas, valid, info, launches


def mesh_gates(label: str, got: tuple, launches: dict, one: tuple,
               want: int):
    """A mesh run against its one-device path ``one`` (canvas, valid, info,
    launches): K1 and K2 launched ``want`` times (one launch per feature
    batch: 10 on the headline, as on one device), valid masks agreeing on
    >= 99.95%, a u8 difference of at most 1."""
    for name, _, _, _, _ in KERNELS[:2]:
        check(launches[name] == want,
              f"{label}: {name} launched {launches[name]} times, not "
              f"{want} (the one-device path {one[3][name]})")
    check(got[0].shape == one[0].shape, f"{label}: canvas {got[0].shape} "
          f"vs {one[0].shape}")
    agree = float((got[1] == one[1]).mean())
    check(agree >= MESH_VALID_AGREE,
          f"{label}: valid masks agree on {agree:.6f}")
    u8_agreement(f"{label} against the one-device path", got, one[:2])


MESH_INFO = ("cams", "lm_iters", "lm_time_s", "stages_s", "wall_s",
             "peak_gib", "collective_bytes")


def mesh_runs(mesh, u8: np.ndarray, truth: dict, perm: np.ndarray) -> dict:
    """The runs of the mesh path, through the entry points a user calls:
    (a) stitch_images(mesh=) on the headline, (b) the same at phase 8's
    band count, (c) stitch_cylinder(mesh=), (d) (a) with
    OPENPANO_SHARDED_BLEND_HOST=1, each with its path's gates.  Returns
    {run: (canvas, valid, info, launches)} and under "uploads" the band
    uploads of (d) by view count; info is cut to ``MESH_INFO``, so that the
    runs hold no device memory."""
    bands = []
    real = render.band_slice

    def recorder(imgs, ids, *a):
        bands.append(len(ids))
        return real(imgs, ids, *a)

    runs = {
        "a": main_path(u8, truth, perm, mesh=mesh, label="mesh (a) linear"),
        "b": main_path(u8, truth, perm, multiband=MB_BANDS, mesh=mesh,
                       label="mesh (b) multiband"),
        "c": cylinder_path(u8, truth, perm, mesh=mesh,
                           label="mesh (c) CYLINDER")}
    os.environ["OPENPANO_SHARDED_BLEND_HOST"] = "1"
    render.band_slice = recorder
    try:
        runs["d"] = main_path(u8, truth, perm, mesh=mesh,
                              label="mesh (d) host-u8 blend")
    finally:
        render.band_slice = real
        del os.environ["OPENPANO_SHARDED_BLEND_HOST"]
    for k, (canvas, valid, info, launches) in runs.items():
        print(f"mesh ({k}), collective bytes by stage: "
              f"{json.dumps(pmesh.bytes_by_stage(info['collective_bytes']))}")
        runs[k] = (canvas, valid, {i: info[i] for i in MESH_INFO if i in info},
                   launches)
    runs["uploads"] = bands
    return runs


def mesh_check(runs: dict, one: dict) -> dict:
    """Gate the mesh runs (``mesh_runs``' results) against the one-device
    runs (``one``: "main", "multiband", "CYLINDER" -> (canvas, valid, info,
    launches)): ``mesh_gates``, (a)'s cameras within 1e-6 (focal) and 1e-8
    (R) of the main path's, whose bundle adjustment ran on the host, (d)
    one band upload and (a)'s canvas bit for bit.  Returns (a)'s
    launches."""
    want = -(-len(runs["a"][2]["cams"].focal) // feature_batch())
    for k, base in (("a", "main"), ("b", "multiband"), ("c", "CYLINDER"),
                    ("d", "main")):
        mesh_gates(f"mesh ({k})", runs[k][:2], runs[k][3], one[base], want)
    info, main = runs["a"][2], one["main"][2]
    dfocal = float(np.abs(info["cams"].focal - main["cams"].focal).max())
    dR = float(np.abs(info["cams"].R - main["cams"].R).max())
    print(f"mesh (a) bundle adjustment on the card: {info['lm_iters']} LM "
          f"iterations in {info['lm_time_s']:.3f} s (the main path's on the "
          f"host: {main['lm_iters']} in {main['lm_time_s']:.3f} s); cameras "
          f"against the main path's: focal max abs diff {dfocal:.3e}, R max "
          f"abs diff {dR:.3e}")
    check(dfocal < 1e-6 and dR < 1e-8,
          "mesh (a): cameras differ from the main path's")
    print(f"mesh (d): band uploads, in views: {runs['uploads']}")
    check(len(runs["uploads"]) == 1, "mesh (d): not one band upload")
    same = all(np.array_equal(x, y) for x, y in zip(runs["a"][:2],
                                                   runs["d"][:2]))
    print(f"mesh (d) canvas equals (a)'s bit for bit: {same}")
    check(same, "mesh (d): the host-u8 blend's canvas differs from (a)'s")
    return runs["a"][3]


def mesh_phase(u8: np.ndarray, truth: dict, perm: np.ndarray,
               one: dict) -> dict:
    """The mesh path at one NCCL rank in this process (world size 1, a
    file:// store in a temporary directory): ``mesh_runs``, then
    ``mesh_check``.  Returns (a)'s launches."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_distributed(f"file://{tmp}/store", 1, 0, device="cuda")
        try:
            mesh = make_mesh()
            print(f"mesh: {mesh}, backend {dist.get_backend()}, world size "
                  f"{dist.get_world_size()}, device "
                  f"{pmesh.mesh_device(mesh)} "
                  f"({time.perf_counter() - t0:.2f} s to start)")
            runs = mesh_runs(mesh, u8, truth, perm)
        finally:
            dist.destroy_process_group()
    return mesh_check(runs, one)


def transport_run(label: str, u8: np.ndarray, truth: dict, perm: np.ndarray,
                  cfg_over: dict, env: dict):
    """The main path with ``cfg_over`` and ``env`` (restored after), the
    codec's counters read around this run alone."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    wirecodec.reset_stats()
    try:
        cfg = Config(**HEADLINE, **cfg_over)
        canvas, valid, info, launches = drive(
            label, u8, cfg, prng.key((0, 1), "cuda"))
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    stats = dict(wirecodec.STATS)
    print(f"{label}: host -> card {stats['up_bytes']:.0f} B for "
          f"{stats['up_plain_bytes']:.0f} B of planes; card -> host "
          f"{stats['down_bytes']:.0f} B for {stats['down_plain_bytes']:.0f} "
          f"B of planes; host encode {stats['encode_s']:.4f} s (grey split, "
          f"chroma and packing, both threads), host decode "
          f"{stats['decode_s']:.4f} s")
    inv_perm = np.argsort(perm)
    conf = info["graph"].conf
    check(all(conf[inv_perm[k], inv_perm[k + 1]] > 0
              for k in range(N_VIEWS - 1)),
          f"{label}: a pair adjacent in the sweep did not connect")
    reproj = camera_error(info["homos"], truth, perm)
    want_w, want_h = expected_canvas(truth, cfg)
    print(f"{label}: canvas {canvas.shape[1]}x{canvas.shape[0]}, valid "
          f"fraction {valid.mean():.4f}, reprojection {reproj:.4f} px")
    check(abs(canvas.shape[1] - want_w) <= 0.05 * want_w
          and abs(canvas.shape[0] - want_h) <= 0.05 * want_h,
          f"{label}: canvas size off")
    check(valid.mean() > 0.3 and reproj < REPROJ_LIMIT_PX,
          f"{label}: the main path's gates")
    for name, _, _, _, _ in KERNELS[:2]:
        check(launches[name] == -(-N_VIEWS // feature_batch()),
              f"{label}: {name} launched {launches[name]} times")
    return canvas, valid, info, launches, stats


def ba_points_run(graph, cams, dev: str, focal_scale: float = 1.0,
                  eps: float = 0.0):
    """pairs_to_points over every connected pair (i < j) of ``graph`` (its
    points scaled by 1 + ``eps``) and ba_optimize from ``cams`` with its
    focals times ``focal_scale``, on ``dev``.  Returns ([n, 6] params,
    seconds, [RMS px before, after])."""
    n = graph.conf.shape[0]
    ii, jj = np.nonzero(np.triu(graph.conf > 0, 1))
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    prob = tba.pairs_to_points(
        ii, jj, t(graph.from_pos[ii, jj] * (1.0 + eps)),
        t(graph.to_pos[ii, jj]), t(graph.valid[ii, jj]),
        t(np.ones(len(ii))))
    params = np.zeros((n, 6))
    params[:, 0] = cams.focal * focal_scale
    params[:, 1], params[:, 2] = cams.ppx, cams.ppy
    params[:, 3:6] = rotation_to_angle(torch.from_numpy(cams.R)).numpy()
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tba.ba_optimize(t(params), prob, n >> 1, n,
                          Config().LM_LAMBDA).cpu().numpy()
    secs = time.perf_counter() - t0
    rms = [float(tba._rms_points(tba._residuals(t(p), prob), prob))
           for p in (params, out)]
    return out, secs, rms


def transport_phase(u8: np.ndarray, truth: dict, perm: np.ndarray,
                    ref: tuple) -> dict:
    """Phase 14 (module docstring).  Returns (a)'s launches."""
    # the headline's share of row deltas past each upload codec's range
    grey, _ = native.wire_grey_res_u8(u8)
    rows = grey.reshape(-1, VIEW_W)
    chroma = np.concatenate([(u8[..., c].reshape(-1, VIEW_W).astype(np.int16)
                              - rows) & 0xFF for c in (0, 2)]).astype(
                                  np.uint8)
    rate = lambda p, bits: (native.wire_pack_plain(p, bits, 1.0)[1].size
                            / p.size)
    print(f"transport: the headline's exceptions, grey (4-bit) "
          f"{rate(rows, 4):.4f}, chroma (2-bit) {rate(chroma, 2):.4f}, "
          f"against the codec's budget of 0.12")
    del grey, rows, chroma
    variants = {
        "a": ("transport (a)", {}, {}),
        "b": ("transport (b) STREAM_BLEND=False", {"STREAM_BLEND": False},
              {}),
        "c": ("transport (c) OPENPANO_CODED_DOWNLOAD=0", {},
              {"OPENPANO_CODED_DOWNLOAD": "0"})}
    runs = {}
    # in turns, so that the host's drift shows: a b c c b a
    for k in ("a", "b", "c", "c2", "b2", "a2"):
        label, cfg_over, env = variants[k[0]]
        runs[k] = transport_run(label + ("" if len(k) == 1 else ", again"),
                                u8, truth, perm, cfg_over, env)
    canvas, valid, info = runs["a"][:3]
    for k in ("b", "c", "c2", "b2", "a2"):
        same = (np.array_equal(runs[k][0], canvas)
                and np.array_equal(runs[k][1], valid))
        print(f"transport ({k}) canvas and valid mask equal (a)'s bit for "
              f"bit: {same}; wall {runs[k][2]['wall_s']:.3f} s, blend stage "
              f"{runs[k][2]['stages_s']['blend']} s against (a)'s "
              f"{info['wall_s']:.3f} s, {info['stages_s']['blend']} s")
        check(same, f"transport ({k}): the canvas differs from (a)'s")

    # (d) the host stream's coded band uploads and strips
    out = {}
    for coded in (True, False):
        wirecodec.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[coded] = blend_linear_host_stream(u8, info["plan"], False,
                                              HOST_GROUPS, u8_out=True,
                                              coded_wire=coded)
        print(f"transport (d) host stream, {HOST_GROUPS} bands, coded_wire="
              f"{coded}: {time.perf_counter() - t0:.3f} s, host -> card "
              f"{wirecodec.STATS['up_bytes']:.0f} B, card -> host "
              f"{wirecodec.STATS['down_bytes']:.0f} B")
    same = np.array_equal(out[True], out[False])
    print(f"transport (d): coded band uploads equal the plain ones' canvas "
          f"bit for bit: {same}")
    check(same, "transport (d): coded and plain host streams differ")
    del out

    # (e) CodedFetch against a plain .cpu()
    rgb = torch.from_numpy(canvas).cuda().to(torch.int32)
    g = rgb[..., 1]
    planes = torch.cat([g, (rgb[..., 0] - g) & 0xFF, (rgb[..., 2] - g) & 0xFF,
                        torch.from_numpy(valid).cuda().to(torch.int32)]
                       ).to(torch.uint8).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(14)
    noisy = torch.randint(0, 256, (2048, 3072), generator=gen, device="cuda",
                          dtype=torch.uint8)
    # rows of small steps, as photographs give: the coded branch
    steps = torch.randint(-3, 4, (2048, 3072), generator=gen, device="cuda",
                          dtype=torch.int32)
    smooth = (torch.cumsum(steps, 1, dtype=torch.int32) & 0xFF).to(
        torch.uint8)
    for name, plane in (("canvas planes", planes), ("smooth rows", smooth),
                        ("noise", noisy)):
        n_exc = int(wirecodec.encode_plane_device(
            plane, cap=plane.numel())[0][-1])
        want = plane.cpu().numpy()
        times = {}
        for label, fn in (("coded", lambda: wirecodec.CodedFetch(plane).wait()),
                          ("plain", lambda: plane.cpu().numpy())):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            times[label] = time.perf_counter() - t0
            check(np.array_equal(got, want),
                  f"transport (e): {label} fetch of {name} differs")
        branch = "coded" if n_exc <= max(4096, plane.numel() // 12) \
            else "raw (past the cap)"
        print(f"transport (e) {name} {tuple(plane.shape)}: {n_exc} "
              f"exceptions ({n_exc / plane.numel():.4f}), the {branch} "
              f"branch; CodedFetch {times['coded'] * 1e3:.3f} ms, .cpu() "
              f"{times['plain'] * 1e3:.3f} ms, equal bit for bit")

    # (f) the point-major bundle adjustment, card against CPU: from phase
    # 5's cameras, held to 1e-9 (focal) and 1e-12 (R); from the same
    # cameras with every focal 5% long, where the LM moves R by about 2e-11
    # when the points move by one part in 1e15, held to 1e-9 and 1e-10
    ref_info, host_cams = ref
    graph = ref_info["graph"]
    for scale in (1.0, 1.05):
        (c1, t1, rms), (c2, _, _), (cpu, tc, _), (ulp, _, _) = (
            ba_points_run(graph, host_cams, d, scale, e)
            for d, e in (("cuda", 0.0), ("cuda", 0.0), ("cpu", 0.0),
                         ("cpu", 1e-15)))
        rot = lambda p: rodrigues(torch.from_numpy(p[:, 3:6])).numpy()
        frel = float(np.abs(c1[:, 0] / cpu[:, 0] - 1).max())
        rabs = float(np.abs(rot(c1) - rot(cpu)).max())
        sens = float(np.abs(rot(ulp) - rot(cpu)).max())
        r_gate = 1e-12 if scale == 1.0 else 1e-10
        print(f"transport (f) point-major BA, {graph.conf.shape[0]} cameras, "
              f"focals x{scale}: card {t1:.3f} s, CPU {tc:.3f} s; focal max "
              f"rel diff {frel:.3e}, R max abs diff {rabs:.3e} (gate "
              f"{r_gate:.3e}; the CPU's R moves {sens:.3e} when the points "
              f"move by 1e-15); RMS {rms[0]:.4f} -> {rms[1]:.4f} px, focal "
              f"{np.round(c1[:, 0], 3).tolist()}")
        check(frel < 1e-9 and rabs < r_gate,
              f"transport (f): card and CPU point-major BA differ (x{scale})")
        check(np.array_equal(c1, c2), "transport (f): two card runs of the "
              f"point-major BA differ (x{scale})")
        check(rms[1] < rms[0],
              f"transport (f): the BA did not lower the error (x{scale})")
    return runs["a"][3]


def bench_phase(inputs: tuple) -> dict:
    """Phase 15: the headline bench (``openpano_torch.bench.headline.run``,
    the entry of ``python -m openpano_torch.bench``) in this process on the
    headline views, counts read around it alone.  Its own gates (bench.py's,
    each timed run's K1 and K2 launches, the kernel check) raise inside;
    here again: every timed run launched K1 and K2 once per feature batch,
    the whole bench once per feature batch of each of its stitches besides
    the kernel check's one launch each, and ``kernel_parity.ok``.  Returns
    the launches of its stitches."""
    reset_counts()
    result = headline.run(inputs=inputs)
    launches = read_counts()
    print(json.dumps(result))
    extra = result["extra"]
    batches = extra["feature_batches"]
    stitches = 1 + len(extra["warm_walls_s"]) + 2 * (extra["multiband"]
                                                     is not None)
    parity = extra["kernel_parity"]
    print(f"bench: {result['value']} img/s (best of {extra['warm_walls_s']} "
          f"s, cold {extra['cold_wall_s']} s), reprojection "
          f"{extra['mean_reproj_err_px']} px, multiband NCC "
          f"{extra['multiband']['ncc_vs_linear']}, kernel parity "
          f"{parity['ori_hist_rel_err']} / {parity['desc_hist_rel_err']} / "
          f"resize {parity['resize_rel_err']}; link host -> card "
          f"{extra['link']['h2d_bytes_per_s']} GB/s, card -> host "
          f"{extra['link']['d2h_bytes_per_s']} GB/s; kernels launched "
          f"{json.dumps(launches)} over {stitches} stitches")
    check(parity["ok"], f"bench: kernel parity {parity}")
    for run in extra["launches"]:
        for name, _, _, _, _ in KERNELS:
            check(run[name] == batches,
                  f"bench: {name} launched {run[name]} times in a timed run")
    for name, _, _, _, _ in KERNELS:
        want = stitches * batches + parity["launches"][name]
        check(launches[name] == want,
              f"bench: {name} launched {launches[name]} times, not {want}")
    return {k: v - parity["launches"].get(k, 0) for k, v in launches.items()}


def uav_phase() -> dict:
    """Phase 16: the UAV strip of ``giga`` in trans mode at GIGA_r04.json's
    command, run once, counts read around it alone: ``giga.trans_gates``
    (every adjacent pair connects, each pairwise offset within 6 px of the
    truth, the canvas width within 5% of the true extent, K1 and K2 launched
    once per feature batch).  The chain's drift, the canvas height and the
    valid share are printed, not gated.  Returns the launches."""
    args = giga.parse_args(UAV_ARGV)
    reset_counts()
    result = giga.run_trans(args, cold=False)
    launches = read_counts()
    print(json.dumps(result))
    print(f"UAV strip: {result['images']} views, {result['wall_s']} s, canvas "
          f"{result['canvas'][0]}x{result['canvas'][1]} against the true "
          f"extent {result['true_extent'][0]}x{result['true_extent'][1]}, "
          f"valid share {result['valid_frac']}, pairwise offsets within "
          f"{result['max_pair_offset_err_px']} px, chain drift "
          f"{result['chain_drift_px']} px, peak device memory "
          f"{result['peak_device_gib']} GiB; kernels launched "
          f"{json.dumps(launches)} for {result['feature_batches']} feature "
          f"batches")
    bad = giga.trans_gates(result)
    check(not bad, f"UAV strip: {bad}")
    for name, _, _, _, _ in KERNELS:
        check(launches[name] == result["feature_batches"],
              f"UAV strip: {name} launched {launches[name]} times")
    return launches


def knob_ms(name: str, value: str, fn) -> tuple[float, float]:
    """(ms with ``name`` unset, ms with it set to ``value``) of ``fn``: the
    better of two ``median_ms`` of each, taken in turns unset, set, set,
    unset."""
    check(name not in os.environ, f"{name} is set already")
    times = {False: [], True: []}
    for on in (False, True, True, False):
        if on:
            os.environ[name] = value
        try:
            times[on].append(median_ms(fn, 3))
        finally:
            os.environ.pop(name, None)
    return min(times[False]), min(times[True])


def tools_phase(u8: np.ndarray) -> dict:
    """Phase 17: the tools (module docstring), each gate raising.  Returns
    the K1 / K2 launches of (a) and (b), counts read around each."""
    out = {}
    # (a) the feature substages, the steady state and one trace
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        lines = profile_sift.run(views=u8[:12], reps=3,
                                 trace_path=os.path.join(tmp, "trace.json"))
    out["profile"] = read_counts()
    prof, steady, calls, trace = lines
    print("profile_sift: " + ", ".join(
        f"{k[:-3]} {prof[k]:.2f} ms" for k in prof if k.endswith("_ms")))
    print(f"profile_feature_stage: {steady['ms_per_img']:.2f} ms a view one "
          f"call each (trials {[round(t, 1) for t in steady['trials_ms']]} "
          f"ms for {steady['views']}); batches: "
          f"{json.dumps(steady['batch_ms_per_img'])} ms a view")
    print(f"feature trace: {trace['wall_ms']:.2f} ms wall for "
          f"{trace['views']} views, device busy {trace['device_busy_ms']} ms "
          f"(idle share {trace['idle_share']}), {trace['device_events']} "
          f"device events; top: {json.dumps(trace['top_device_events'][:5])}")
    print(f"profile launches per call: {json.dumps(prof['launches_per_call'])}"
          f"; batches {json.dumps(calls['launches_per_call'])}")
    per = prof["launches_per_call"]
    want = {"full_chunk": (1, 1), "orientation": (1, 0),
            "descriptor": (0, 1), "resize": (0, 0), "pyramid": (0, 0),
            "extrema": (0, 0)}
    for stage, (k1, k2) in want.items():
        check((per[stage]["orientation_histogram"],
               per[stage]["descriptor_histogram"]) == (k1, k2),
              f"profile_sift: {stage} launched {per[stage]}")
    for B, c in calls["launches_per_call"].items():
        check(c == {"orientation_histogram": 1, "descriptor_histogram": 1},
              f"profile_sift: a batch of {B} launched {c}")
    # (b) the feature batch in this process
    reset_counts()
    lines, ok = batch_sweep.run(u8=u8, sizes=(1, 4, 8), trials=1,
                                cfg=Config(**HEADLINE))
    out["batch_sweep"] = read_counts()
    for line in lines:
        print(json.dumps(line))
    check(ok, "feature batch: a size failed, launched other than ceil(n/B) "
              "times or changed the features")
    want = sum(-(-N_VIEWS // B) for B in (1, 4, 8))
    check(all(out["batch_sweep"][n] == want for n, *_ in KERNELS),
          f"feature batch: {out['batch_sweep']}, not {want} each")
    # (c) the headline's all-pairs match at MATCH_PRECISION=high (TF32)
    # and unset (full f32)
    cfg = Config(**HEADLINE)
    f = compute_features(torch.from_numpy(u8).cuda(), cfg)
    run = lambda: match_all_pairs(f.desc, f.valid, cfg)
    full = run()
    os.environ["OPENPANO_MATCH_PRECISION"] = "high"
    try:
        high = run()
    finally:
        del os.environ["OPENPANO_MATCH_PRECISION"]
    pairs = lambda m: set(map(tuple, torch.cat(
        [torch.nonzero(m.valid)[:, :1], m.idx[m.valid]], 1).tolist()))
    moved = len(pairs(full) ^ pairs(high))
    match_off, match_on = knob_ms("OPENPANO_MATCH_PRECISION", "high", run)
    print(f"knob times (ms, best of 2 medians in turns unset, set, set, "
          f"unset): all-pairs match full f32 {match_off:.3f} high "
          f"{match_on:.3f} ({moved} of {len(pairs(full))} matches differ)")
    del f, full, high
    # (d) the CLI harness on the card
    for line in run_test.run():
        print(json.dumps(line))
        check(line["ok"], f"run_test {line['mode']}: {line['reason']}")
    # (e) one BA schedule on the small set, and the collective bytes
    (line,) = ba_sweep.run(sweep="r2", small=True, picks=["0"])
    print(json.dumps(line))
    check(line["lm_iters"] > 0 and line["reproj_px"] < REPROJ_LIMIT_PX,
          f"ba_sweep: {line}")
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", 1, 0, device="cuda")
        try:
            cv = comm_volume.measure(make_mesh(), comm_volume.views(8, 320,
                                                                    240))
        finally:
            dist.destroy_process_group()
    print(f"comm_volume at one NCCL rank: {json.dumps(cv)}")
    check(cv["feature"]["compute_bytes"] == 0,
          "comm_volume: the feature compute moved collective bytes")
    check(cv["dist_ba"]["collective_bytes_per_device_per_iteration"]
          == comm_volume.ba_iteration_bytes(),
          f"comm_volume: LM iteration bytes {cv['dist_ba']}")
    return out


@contextlib.contextmanager
def phase(label: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")


def main(kernels_only: bool = False) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    with phase("2 build"):
        for source in ("windows", "extrema", "ransac"):
            lib = _build.build_cuda(source)
            print(f"build: {lib.name}")
            for line in lib.with_suffix(".log").read_text().splitlines():
                if "ptxas info" in line and ("Used" in line
                                             or "Compiling" in line) \
                        or "spill" in line:
                    print(f"  {line.strip()}")

    with phase("3 inputs"):
        u8, truth, perm = headline_inputs()
        views, xy = strip_views(N_VIEWS, VIEW_W, VIEW_H, overlap=OVERLAP,
                                seed=0, offsets=True)
        strip = np.round(views * 255).astype(np.uint8)
        del views
        sweep = np.degrees(truth["yaws"].max() - truth["yaws"].min())
        print(f"inputs: {N_VIEWS} uint8 views {VIEW_W}x{VIEW_H} of a "
              f"{sweep + headline.FULL.hfov:.1f} degree sweep (focal "
              f"{truth['focal_px']:.2f} px), and a {N_VIEWS}-view strip at "
              f"overlap {OVERLAP}")

    with phase("4 kernels"):
        batches = {"main": capture_path_inputs(u8, Config(**HEADLINE)),
                   "TRANS": capture_path_inputs(strip, Config(**TRANS))}
        report = kernel_phase(batches)
        report.append(slab_phase(batches["main"]["descriptor_histogram"]))
        report.append(extrema_phase(batches))
        del batches
        report.append(ransac_phase({
            "main": capture_ransac_inputs(u8, Config(**HEADLINE)),
            "TRANS": capture_ransac_inputs(strip, Config(**TRANS))}))
    if kernels_only:
        print(json.dumps({"kernels": report}))
        return 0
    with phase("5 references and BRIEF"):
        ref = reference_phase()
        brief_phase(u8, perm)
    with phase("6 TRANS path"):
        trans_launches = trans_path(strip, xy)
    with phase("7 main path"):
        linear = main_path(u8, truth, perm)
        launches, lin_plan = linear[3], linear[2]["plan"]
    with phase("8 multiband path"):
        multiband = multiband_path(u8, truth, perm, linear[:3])
        mb_launches, mb_plan = multiband[3], multiband[2]["plan"]
    with phase("9 CLI"):
        cli_launches = cli_phase(u8, linear[:3])
    with phase("10 host-stream path"):
        host_launches, _ = host_stream_path(u8, truth, perm, linear[:3])
    with phase("11 blend memory"):
        blend_memory_phase(u8, linear[2]["plan"], mb_plan)
    with phase("12 CYLINDER path"):
        cylinder = cylinder_path(u8, truth, perm)
        cyl_launches = cylinder[3]
    with phase("13 mesh path"):
        mesh_launches = mesh_phase(u8, truth, perm, {
            "main": linear, "multiband": multiband, "CYLINDER": cylinder})
    del linear, multiband, cylinder
    with phase("14 transport"):
        transport_launches = transport_phase(u8, truth, perm, ref)
    with phase("15 headline bench"):
        bench_launches = bench_phase((u8, truth, perm))
    del strip
    with phase("16 UAV strip"):
        uav_launches = uav_phase()
    with phase("17 tools"):
        tools_launches = tools_phase(u8)
    del u8
    for entry in report:
        k = entry["name"]
        entry.update(launches=launches[k], trans_launches=trans_launches[k],
                     multiband_launches=mb_launches[k],
                     cylinder_launches=cyl_launches[k],
                     cli_launches=cli_launches[k],
                     host_stream_launches=host_launches[k],
                     mesh_launches=mesh_launches[k],
                     transport_launches=transport_launches[k],
                     bench_launches=bench_launches[k],
                     uav_launches=uav_launches[k],
                     profile_launches=tools_launches["profile"][k],
                     batch_sweep_launches=tools_launches["batch_sweep"][k])
    print(f"total: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": report}))
    # the cards the run used: those on which it allocated memory (the
    # cumulative count, which resetting the peak statistics leaves alone)
    used = [i for i in range(torch.cuda.device_count())
            if torch.cuda.memory_stats(i).get("allocated_bytes.all.allocated",
                                              0)]
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": len(used)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels"]))
