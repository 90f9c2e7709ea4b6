"""Per-stage roofline accounting for the headline bench.

For each pipeline stage, estimate the three resources it can be bound by
(arithmetic, device-memory bytes and host-link bytes) from the workload's
shapes and the Config's kernel rules, then relate the measured stage time to
each peak.  The point is not three-digit precision: it is which roof each
stage sits under.  The work model is ``tools/roofline.py``'s, term by term,
and gives the same counts on the same shapes.

Peaks: one NVIDIA H100 SXM5 80 GB (data sheet, dense rates at its 700 W
limit): 67 TFLOP/s of f32 outside the tensor cores and 3.35 TB/s of HBM,
the bounds of the kernel table in PERF.md.  The host link has no data-sheet
rate that a run can rely on (PCIe generation, lanes, pinning, the host), so
``measure_link`` times it at the start of a run.
"""

from __future__ import annotations

import math

import torch

from ..ops.imgproc import working_size

# NVIDIA H100 SXM5 80 GB
H100_PEAK_F32 = 67e12      # FLOP/s, f32 outside the tensor cores
H100_PEAK_HBM = 3.35e12    # bytes/s
LINK_BYTES = 256 << 20     # one pinned copy each way


def _blur_window(sigma: float, gwf: int) -> int:
    # ops/gaussian.py kernel rule (config.py): ceil(0.3*(sigma/2-1)+0.8)*GWF
    k = int(math.ceil((0.3 * (sigma / 2.0 - 1.0) + 0.8) * gwf))
    return max(k | 1, 3)


def feature_stage(n: int, w: int, h: int, cfg) -> dict:
    """SIFT feature stage: coded grey upload + resize + pyramid + window
    kernels."""
    wh_, ww_ = working_size(w, h, cfg.SIFT_WORKING_SIZE)
    flops = 0.0
    hbm = 0.0
    # full->working grey resize: 4-tap gather + lerp per output px
    px0 = wh_ * ww_
    flops += n * px0 * 10
    hbm += n * (px0 * 4 * 4 + px0 * 4)
    # pyramid: per octave o (area / 2^o), per scale j: separable blur
    area = px0
    for o in range(cfg.NUM_OCTAVE):
        sigma = cfg.GAUSS_SIGMA
        for j in range(1, cfg.NUM_SCALE):
            win = _blur_window(sigma, cfg.GAUSS_WINDOW_FACTOR)
            flops += n * area * (2 * win * 2)          # col+row MAC
            hbm += n * area * 8 * 2                    # rd+wr, 2 passes
            # mag/ort (grad + atan2) + DoG |a-b|
            flops += n * area * 35
            hbm += n * area * 4 * 4
            sigma *= cfg.SCALE_FACTOR
        area /= 2.0
    # extrema + window kernels (orientation/descriptor histograms): the
    # JAX tool's 15% of the pyramid's arithmetic
    flops *= 1.15
    # wire: grey 4-bit codec + 2-bit residual, +5% exceptions
    wire = n * h * w * (0.5 + 0.25) * 1.05
    return {"flops": flops, "hbm_bytes": hbm, "wire_bytes": wire}


def match_stage(n_pairs: int, K: int, desc_len: int) -> dict:
    """2-NN distance matmuls over candidate pairs."""
    flops = n_pairs * 2.0 * K * K * desc_len
    hbm = n_pairs * (2 * K * desc_len * 4 + K * K * 4)
    return {"flops": flops, "hbm_bytes": hbm, "wire_bytes": 2e6}


def blend_stage(canvas_w: int, canvas_h: int, layers: float = 2.0) -> dict:
    """Linear blend: bilinear gathers per canvas px + u8 download."""
    px = canvas_w * canvas_h
    flops = px * layers * 25
    hbm = px * layers * (4 * 3 * 4 + 12)   # 4-tap RGB gather + write
    # download codec: 4 planes at 4-bit deltas = 2 B/px packed, plus a 2%
    # inline exception prefix of 4 B each
    wire = px * (4 * 0.5 + 0.02 * 4 * 4)
    return {"flops": flops, "hbm_bytes": hbm, "wire_bytes": wire}


def measure_link(device=None, nbytes: int = LINK_BYTES,
                 reps: int = 3) -> dict:
    """The host link's rate each way on the card: a pinned ``nbytes`` copy
    host -> card and card -> host, each timed by CUDA events, best of
    ``reps``.  Returns {"h2d_bytes_per_s", "d2h_bytes_per_s", "bytes"}.
    Raises off the card: a CPU has no host link to time."""
    from ..stitch.stitcher import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"no host link on {dev}: the link is the card's")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("h2d_bytes_per_s", card, host),
                           ("d2h_bytes_per_s", host, card)):
        best = math.inf
        with torch.cuda.device(dev):
            for _ in range(reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                dst.copy_(src, non_blocking=True)
                e1.record()
                e1.synchronize()
                best = min(best, e0.elapsed_time(e1) / 1e3)
        rates[name] = nbytes / best
    rates["bytes"] = nbytes
    return rates


def relate(est: dict, seconds: float, link_bps: float) -> dict:
    """Attach %-of-peak numbers and the implied binding resource, against
    the H100's peaks and the host link's measured rate ``link_bps``."""
    if seconds <= 0:
        return dict(est)
    out = dict(est)
    share = lambda amount, peak: 100 * amount / seconds / peak
    out["pct_peak_flops"] = round(share(est["flops"], H100_PEAK_F32), 2)
    out["pct_peak_hbm"] = round(share(est["hbm_bytes"], H100_PEAK_HBM), 2)
    out["pct_peak_wire"] = round(share(est["wire_bytes"], link_bps), 1)
    ideal = {
        "flops": est["flops"] / H100_PEAK_F32,
        "hbm": est["hbm_bytes"] / H100_PEAK_HBM,
        "wire": est["wire_bytes"] / link_bps,
    }
    out["bound"] = max(ideal, key=ideal.get)
    out["ideal_s"] = round(sum(ideal.values()), 4)
    for k in ("flops", "hbm_bytes", "wire_bytes"):
        out[k] = float(f"{est[k]:.3g}")
    return out
