#!/usr/bin/env python3
"""Drive openpano_torch on one NVIDIA card, end to end, and report.

    python3 chip_smoke.py          # one card; exits non-zero without one

Phases, each fatal on failure:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: the package's CUDA source (one file, one nvcc run);
  3. kernels: each kernel on the inputs the main path gives it (captured from
     a feature batch of the strip below) and on a seeded random case of the
     same shapes, held against its plain PyTorch version (max|a-b| / max|b|
     < 1e-4) and run twice for identical bits; median times by CUDA events
     of the launch alone (arguments cast beforehand), the plain version's
     time, and the least time the card could take;
  4. reference: a small strip stitched on the card and on the CPU (the plain
     versions, which the tests hold to the JAX package) must agree;
  5. main path: stitch_images in TRANS mode over 38 uint8 views of 1300x867
     (the headline image count and size), with every kernel's launch count
     read around this run alone; every adjacent pair must connect, the
     canvas must have the expected size, each pairwise transform must
     recover its views' true offset and the chain must place every view
     within CHAIN_LIMIT_PX of it.
The second-to-last line is the kernel report as JSON; the last line is the
device record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from openpano_torch import Config, stitch_images  # noqa: E402
from openpano_torch import _build  # noqa: E402
from openpano_torch.ops import windows  # noqa: E402
from openpano_torch.stitch.stitcherbase import FEATURE_BATCH, \
    compute_features  # noqa: E402
from openpano_torch.synth import strip_views  # noqa: E402
from openpano_torch.utils import timer  # noqa: E402

N_VIEWS, VIEW_W, VIEW_H, OVERLAP = 38, 1300, 867, 0.4
GATE = 1e-4                     # max|a-b| / max|b|, kernel vs plain
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

# name, wrapper (holds the launch count), kernel, plain version, TPU kernel
KERNELS = (
    ("orientation_histogram", windows.orientation_histogram, "ori_hist_cuda",
     windows.ori_hist_plain, "openpano_tpu/ops/windows.py:237"),
    ("descriptor_histogram", windows.descriptor_histogram, "desc_hist_cuda",
     windows.desc_hist_plain, "openpano_tpu/ops/windows.py:458"),
)
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


def kernel_phase(captured: dict) -> list[dict]:
    report = []
    for name, wrapper, cuda_attr, plain, replaces in KERNELS:
        cuda = getattr(windows, cuda_attr)
        check(name in captured, f"the main path never reached {name}")
        real = captured[name]
        errs = []
        for case, args in (("path", real), ("random", random_case(name, real))):
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
            errs.append(err)
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
            replaces=replaces, launches=None, max_abs_err=errs[0],
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{report[-1]['bound_ms']:.4f} ms by {report[-1]['bound_by']} "
              f"({n_active}/{K} keypoints active, {distinct} distinct window "
              f"pixels, {visits} visits, {nbytes} B, {ops} ops)")
    return report


def capture_main_path_inputs(u8: np.ndarray, cfg: Config) -> dict:
    """Run one feature batch of the main path with recorders on the kernel
    launchers; keep each kernel's first argument tuple."""
    captured = {}
    saved = {attr: getattr(windows, attr) for _, _, attr, _, _ in KERNELS}
    for name, _, attr, _, _ in KERNELS:
        def rec(*args, _name=name, _fn=saved[attr]):
            captured.setdefault(_name, args)
            return _fn(*args)
        setattr(windows, attr, rec)
    try:
        compute_features(torch.from_numpy(u8[:FEATURE_BATCH]).cuda(), cfg)
    finally:
        for attr, fn in saved.items():
            setattr(windows, attr, fn)
    return captured


def reference_phase():
    """A 4-view strip on the card and on the CPU must agree."""
    cfg = Config(**TRANS, **SMALL)
    views = np.round(strip_views(4, 320, 240, overlap=0.5, seed=0) * 255
                     ).astype(np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        info = {}
        canvas, valid = stitch_images(views, cfg, output="u8", device=dev,
                                      info_out=info)
        out[dev] = (canvas.astype(np.float64), valid, info)
    (gc, gv, gi), (cc, cv, ci) = out["cuda"], out["cpu"]
    check(gc.shape == cc.shape, f"canvas {gc.shape} vs {cc.shape}")
    kdiff = np.abs(gi["kpt_counts"] - ci["kpt_counts"]) / ci["kpt_counts"]
    pairs = lambda i: set(zip(*np.nonzero(np.triu(i["graph"].conf > 0, 1))))
    m = gv & cv
    a, b = gc[m] - gc[m].mean(), cc[m] - cc[m].mean()
    ncc = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
    agree = float((gv == cv).mean())
    print(f"reference: canvas {gc.shape[:2]}, keypoints card "
          f"{gi['kpt_counts'].tolist()} cpu {ci['kpt_counts'].tolist()}, "
          f"pairs {sorted(pairs(gi))}, valid agree {agree:.6f}, NCC {ncc:.6f}")
    check(kdiff.max() <= 0.02, "keypoint counts differ by more than 2%")
    check(pairs(gi) == pairs(ci) >= {(0, 1), (1, 2), (2, 3)},
          "connected pairs differ")
    check(agree >= 0.999 and ncc >= 0.999, "canvases disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib = _build.build_cuda("windows")
    print(f"build: {time.perf_counter() - t0:.2f} s {lib.name}")

    cfg = Config(**TRANS)
    t0 = time.perf_counter()
    views, xy = strip_views(N_VIEWS, VIEW_W, VIEW_H, overlap=OVERLAP, seed=0,
                            offsets=True)
    u8 = np.round(views * 255).astype(np.uint8)
    del views
    print(f"inputs: {N_VIEWS} uint8 views {VIEW_W}x{VIEW_H}, overlap "
          f"{OVERLAP} ({time.perf_counter() - t0:.1f} s to make)")

    report = kernel_phase(capture_main_path_inputs(u8, cfg))
    reference_phase()

    for _, wrapper, _, _, _ in KERNELS:
        wrapper.launches = 0
    timer.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = {}
    canvas, valid = stitch_images(u8, cfg, output="u8", info_out=info)
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w, _, _, _ in KERNELS}
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    stages = {k: round(s, 4) for k, (_, s) in timer.totals().items()}
    print(f"main path: {wall:.3f} s wall, {N_VIEWS / wall:.2f} img/s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"stages_s: {json.dumps(stages)}")
    print(f"kernels launched: {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")

    # the result: every adjacent pair connected, the canvas of the expected
    # size, and each view placed where the texture put it
    conf = info["graph"].conf
    check(all(conf[i, i + 1] > 0 for i in range(N_VIEWS - 1)),
          "an adjacent pair did not connect")
    span = xy.max(0) - xy.min(0) + [VIEW_W, VIEW_H]
    scale = min(1.0, cfg.MAX_OUTPUT_SIZE / span.max())
    print(f"canvas {canvas.shape[1]}x{canvas.shape[0]} (expected about "
          f"{span[0] * scale:.0f}x{span[1] * scale:.0f}), valid fraction "
          f"{valid.mean():.4f}, keypoints per view "
          f"{int(info['kpt_counts'].min())}..{int(info['kpt_counts'].max())}")
    check(canvas.dtype == np.uint8 and canvas.shape[2] == 3,
          "canvas is not u8 RGB")
    check(abs(canvas.shape[1] - span[0] * scale) <= 0.01 * span[0] * scale,
          "canvas width off")
    check(abs(canvas.shape[0] - span[1] * scale) <= 0.05 * span[1] * scale,
          "canvas height off")
    check(valid.mean() > 0.8, "canvas mostly empty")
    # placement against the true offsets, as the error of the views' corners:
    # each pairwise affine on its own, and the chain outward from the middle
    # view, where TRANS mode compounds the pairs' small scale and shear
    # errors over up to N/2 hops
    corners = np.array([[-VIEW_W / 2, -VIEW_H / 2, 1], [VIEW_W / 2, -VIEW_H / 2, 1],
                        [-VIEW_W / 2, VIEW_H / 2, 1], [VIEW_W / 2, VIEW_H / 2, 1]])

    def corner_err(H, shift):
        p = corners @ H.T
        return float(np.abs(p[:, :2] / p[:, 2:] - corners[:, :2] - shift).max())

    pair_err = [corner_err(info["graph"].homo[k - 1, k], xy[k] - xy[k - 1])
                for k in range(1, N_VIEWS)]
    f = 0.5 * (VIEW_W + VIEW_H)
    mid = N_VIEWS >> 1
    chain_err = max(corner_err(info["homos"][k] * [[f], [f], [1]],
                               xy[k] - xy[mid]) for k in range(N_VIEWS))
    print(f"placement: pairwise corner error median {np.median(pair_err):.3f} "
          f"max {max(pair_err):.3f} px; chained from the middle view max "
          f"{chain_err:.3f} px over a {span[0]} px strip")
    check(max(pair_err) < 6.0, "a pairwise transform is off")
    check(chain_err < CHAIN_LIMIT_PX, "views misplaced along the chain")

    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
