"""On-card kernel regression check: the hand-written kernels against their
plain versions on the same card tensors.

The stitch reaches the CUDA kernels of ``ops/windows.py`` (K1, the
orientation histogram, and K2, the descriptor histogram) only for tensors
on the card; the CPU tests run the plain versions.  This check runs both on
the card with identical inputs, the JAX tool's case
(``tools/tpu_kernel_check.py``: S, H, W, K = 3, 256, 384, 96, WR = 48, from
``default_rng(seed)``), and bounds their disagreement by
max|a-b| / max|b| < 1e-4.  It reads each wrapper's launch count, so that a
plain path taken by mistake fails.  The JAX tool also gates its resize fork
(the TPU's matmul resize against the gather); here the counterpart is
``ops.imgproc.resize`` on the card against the same call on the CPU, on
the tool's case (257x389 to 181x263), under the same bound.  The
extrema kernels (``sift/extrema.py``, which the JAX package leaves to XLA)
run at the headline's shapes: the four octaves of a batch of
``FEATURE_BATCH`` views at its working size (959x640, from a smooth
seeded image) under the default caps, each held to the plain version on
the same card tensors bit for bit in every field and slot.

    python -m openpano_torch.bench.kernel_check   # one JSON line

The keys are the JAX tool's and ``extrema_equal``; ``pallas_active`` keeps
its name and says here whether every hand-written kernel launched (K1 and
K2 once, the extrema twice an octave).  On a CPU tensor there is no
kernel to check, and ``check`` raises.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..config import Config
from ..ops import windows as W
from ..ops.imgproc import resize
from ..sift import extrema
from ..sift.detector import octave_caps
from ..sift.pyramid import build_scale_space
from ..stitch.stitcher import resolve_device
from ..stitch.stitcherbase import FEATURE_BATCH

TOL = 1e-4   # tools/tpu_kernel_check.py:87
HEADLINE_WORK = (640, 959)    # the headline's 1300x867 views at working size


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = max(float(b.abs().max()), 1e-6)
    return float((a - b).abs().max()) / scale


def check_extrema(seed: int, dev) -> tuple[bool, int]:
    """The extrema kernels against the plain version at the headline's
    shapes; returns (every octave bit-equal, kernel launches)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = HEADLINE_WORK
    coarse = torch.rand(FEATURE_BATCH, h // 8, w // 8, generator=g,
                        device=dev)
    grey = resize(coarse, h, w)
    cfg = Config()
    before = extrema.detect_extrema.launches
    equal = True
    for oi, octave in enumerate(build_scale_space(grey, cfg)):
        caps = octave_caps(cfg, oi)[:2]
        got = extrema.detect_extrema(octave, cfg, *caps)
        want = extrema.detect_extrema_plain(octave, cfg, *caps)
        equal &= all(torch.equal(a, b) for a, b in zip(got, want))
    return equal, extrema.detect_extrema.launches - before


def check(seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"kernel check on {dev}: the kernels run on the "
                           f"card only, and a CPU tensor takes the plain "
                           f"version, so there is nothing to check")
    rng = np.random.default_rng(seed)
    S, H, Wd, K = 3, 256, 384, 96
    WR = 48  # the JAX tool's window bucket
    R = WR - 3  # the largest radius the case draws: the port's window bound

    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    f32, i32 = torch.float32, torch.int32
    mag = t(rng.uniform(0, 2, (S, H, Wd)), f32)
    ort = t(rng.uniform(0, 2 * np.pi, (S, H, Wd)), f32)
    s = t(rng.integers(0, S, K), i32)
    y = t(rng.uniform(8, H - 8, K), f32)
    x = t(rng.uniform(8, Wd - 8, K), f32)
    rad = t(rng.integers(3, WR - 2, K), f32)
    invden = t(rng.uniform(0.005, 0.05, K), f32)
    radius = t(rng.integers(4, WR - 2, K), f32)
    hw = t(rng.uniform(2.0, 6.0, K), f32)
    dirv = t(rng.uniform(0, 2 * np.pi, K), f32)

    launches0 = (W.orientation_histogram.launches,
                 W.descriptor_histogram.launches)
    ori_main = W.orientation_histogram(mag, ort, s, y, x, rad, invden, R)
    desc_main = W.descriptor_histogram(mag, ort, s, y, x, radius, hw, dirv, R)
    launched = (W.orientation_histogram.launches - launches0[0],
                W.descriptor_histogram.launches - launches0[1])

    # the plain versions on the same card tensors
    hb = torch.full((K,), float(H), device=dev)
    wb = torch.full((K,), float(Wd), device=dev)
    act = torch.ones(K, dtype=torch.bool, device=dev)
    ori_ref = W.ori_hist_plain(mag, ort, s, y, x, rad, invden, hb, wb, act, R)
    desc_ref = W.desc_hist_plain(mag, ort, s, y, x, radius, hw,
                                 torch.cos(dirv), torch.sin(dirv), dirv,
                                 hb, wb, act, R)
    ori_rel = _rel(ori_main, ori_ref)
    desc_rel = _rel(desc_main, desc_ref)

    img = rng.uniform(0, 1, (257, 389, 3)).astype(np.float32)
    r_card = resize(torch.from_numpy(img).to(dev), 181, 263, rgb=True)
    r_cpu = resize(torch.from_numpy(img), 181, 263, rgb=True)
    resize_rel = _rel(r_card.cpu(), r_cpu)
    extrema_equal, extrema_launched = check_extrema(seed, dev)

    active = launched == (1, 1) and extrema_launched == 2 * Config.NUM_OCTAVE
    ok = (active and ori_rel < TOL and desc_rel < TOL and resize_rel < TOL
          and extrema_equal)
    return {
        "backend": dev.type,
        "pallas_active": bool(active),
        "ori_hist_rel_err": round(ori_rel, 8),
        "desc_hist_rel_err": round(desc_rel, 8),
        "resize_rel_err": round(resize_rel, 8),
        "extrema_equal": bool(extrema_equal),
        "ok": bool(ok),
        "device": torch.cuda.get_device_name(dev),
        "launches": {"orientation_histogram": launched[0],
                     "descriptor_histogram": launched[1],
                     "detect_extrema": extrema_launched},
    }


if __name__ == "__main__":
    result = check()
    print(json.dumps(result))
    sys.exit(0 if result["ok"] else 1)
