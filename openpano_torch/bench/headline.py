"""Headline benchmark: end-to-end panorama stitch throughput and the
BASELINE.md metric set, on the card.

The workload is bench.py's: 38 shuffled views of 1300x867 of a 336 degree
sweep (40 degree field of view, 80% overlap, yaw jitter, seed 5, shuffled by
``default_rng(0)``), stitched with ESTIMATE_CAMERA, unordered input and the
bench's caps, key ``PRNGKey(1)``, u8 in and out; ``BENCH_SMALL=1`` gives 13
views of 640x480.  The scene is ``procedural_scene_large(1400, 11000)`` in
place of the photo scene, which is not in the repository.

One cold run, then ``warm_runs`` timed runs, each with one input pixel set
to the run's index; the best of them is reported.  Gates (bench.py's): the
canvas shape, a valid share above 0.3, the mean reprojection error of the
pairs adjacent in the sweep under 2.5 px, and for the multiband case
(``BENCH_SKIP_MULTIBAND=1`` skips it) an NCC above 0.97 against the linear
canvas; on the card also K1 and K2 launched once per feature batch in every
timed run, and the kernel check.

    python -m openpano_torch.bench [--device cpu] [--report]

prints one JSON line with the keys of bench.py's line.  ``vs_baseline`` is
the run's images per second over the reference's 0.745 img/s: its 38 views
in 51 s on an i7-6700HQ CPU (BASELINE.md).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import stitch_images
from ..config import Config
from ..io import wirecodec
from ..ops import windows
from ..stitch.render import plan_render
from ..stitch.stitcher import resolve_device
from ..stitch.stitcherbase import feature_batch
from ..synth import gt_pair_homography, procedural_scene_large, render_views
from ..utils import prng, timer
from . import device_record, kernel_check, roofline, sync

# the reference's CMU0 headline: 38 views in 51 s on an i7-6700HQ CPU
BASELINE_IMG_PER_S = 38 / 51.0
REPROJ_LIMIT_PX = 2.5       # bench.py:113
VALID_LIMIT = 0.3           # bench.py:74
MB_NCC_LIMIT = 0.97         # bench.py:173
JITTER = 0.05


@dataclass(frozen=True)
class Workload:
    """A headline sweep: ``n`` views of ``out_w`` x ``out_h``, ``hfov``
    degrees wide at ``overlap``, over a procedural scene of ``scene``
    (h, w), detected at ``working_size`` (SIFT_WORKING_SIZE; None keeps
    bench.py's, the Config default, and a sweep of small views takes a
    smaller one)."""
    n: int
    out_w: int
    out_h: int
    hfov: float
    overlap: float
    scene: tuple[int, int] = (1400, 11000)
    working_size: int | None = None


FULL = Workload(38, 1300, 867, 40, 0.8)
SMALL = Workload(13, 640, 480, 30, 0.5)


def config(**over) -> Config:
    """bench.py:39-42's Config (``over`` added)."""
    return Config(ESTIMATE_CAMERA=True, ORDERED_INPUT=False,
                  MAX_KP_PER_IMAGE=2048, MAX_MATCHES_PER_PAIR=1024, **over)


def headline_inputs(w: Workload = FULL):
    """The shuffled uint8 views, the truth with its yaws in the shuffled
    order, and the permutation."""
    views, truth = render_views(
        procedural_scene_large(*w.scene, seed=0), w.n, out_w=w.out_w,
        out_h=w.out_h, hfov_deg=w.hfov, overlap=w.overlap, jitter=JITTER,
        seed=5)
    perm = np.random.default_rng(0).permutation(w.n)
    u8 = np.round(views[perm] * 255.0).astype(np.uint8)
    return u8, dict(truth, yaws=truth["yaws"][perm]), perm


def expected_canvas(truth: dict, cfg: Config,
                    w: Workload = FULL) -> tuple[int, int]:
    """(w, h) of the spherical canvas the true cameras give: yaw rotations
    about the mean viewing direction (where ``straighten`` puts the frame),
    the true focal, the middle view as the resolution reference, the
    MAX_OUTPUT_SIZE cap."""
    f, yaws = truth["focal_px"], truth["yaws"]
    centre = np.arctan2(np.sin(yaws).sum(), np.cos(yaws).sum())
    Kinv = np.linalg.inv(np.diag([f, f, 1.0]))
    homos = []
    for yaw in yaws - centre:
        c, s = np.cos(yaw), np.sin(yaw)
        homos.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ Kinv)
    whs = np.repeat([[float(w.out_w), float(w.out_h)]], w.n, 0)
    plan = plan_render(np.stack(homos), whs, w.n >> 1, "spherical",
                       cfg.MAX_OUTPUT_SIZE)
    return plan.out_w, plan.out_h


def camera_error(homos: np.ndarray, truth: dict, perm: np.ndarray,
                 w: Workload = FULL) -> float:
    """bench.py:91-113: mean reprojection error, over the pairs adjacent in
    the sweep, of the recovered pairwise homography against the true one,
    on a grid over the overlap."""
    gx, gy = np.meshgrid(np.linspace(-w.out_w * 0.45, w.out_w * 0.05, 9),
                         np.linspace(-w.out_h * 0.4, w.out_h * 0.4, 7))
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], 1)
    inv_perm = np.argsort(perm)
    errs = []
    for orig in range(w.n - 1):
        i, j = inv_perm[orig], inv_perm[orig + 1]
        H_est = np.linalg.inv(homos[i]) @ homos[j]
        H_gt = gt_pair_homography(truth, i, j, w.out_w, w.out_h)
        pe, pg = grid @ H_est.T, grid @ H_gt.T
        errs.append(np.linalg.norm(pe[:, :2] / pe[:, 2:3]
                                   - pg[:, :2] / pg[:, 2:3], axis=1).mean())
    return float(np.mean(errs))


def canvas_ncc(a, va, b, vb) -> float:
    """Normalized cross-correlation of two canvases over the pixels valid
    in both."""
    m = va & vb
    x = a[m].astype(np.float64)
    y = b[m].astype(np.float64)
    x, y = x - x.mean(), y - y.mean()
    return float((x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum()))


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"bench gate failed: {msg}")


def _launches() -> dict:
    return {"orientation_histogram": windows.orientation_histogram.launches,
            "descriptor_histogram": windows.descriptor_histogram.launches}


def _stitch(views, cfg: Config, key, dev, info=None):
    """One timed stitch: (canvas, valid, wall s), the clock read after the
    card has finished."""
    sync(dev)
    t0 = time.perf_counter()
    out, valid = stitch_images(views, cfg, key=key, output="u8", device=dev,
                               info_out=info)
    sync(dev)
    return out, valid, time.perf_counter() - t0


def _roofline(w: Workload, cfg: Config, out, stage_s: dict, stats: dict,
              link: dict | None) -> dict:
    """The three stages' work and, on the card, their shares of the H100's
    peaks and of the measured link.  A stage's wire bytes are the run's own
    codec counts where the path took the transport (the feature stage: the
    bytes up less the chroma streamed in the background for the blend; the
    blend: the bytes down), the model's otherwise."""
    n = w.n
    feat = roofline.feature_stage(n, w.out_w, w.out_h, cfg)
    feat_wire = stats["up_bytes"] - stats["bg_up_bytes"]
    blend = roofline.blend_stage(int(out.shape[1]), int(out.shape[0]))
    stages = {
        # match_2nn runs over all C(n,2) candidate pairs
        "feature": (feat, stage_s.get("upload+calc_feature",
                                      stage_s.get("calc_feature", 0.0)),
                    feat_wire, "h2d_bytes_per_s"),
        "match_2nn": (roofline.match_stage(n * (n - 1) // 2,
                                           cfg.MAX_KP_PER_IMAGE, cfg.DESC_LEN),
                      stage_s.get("match_2nn", 0.0), 0, "d2h_bytes_per_s"),
        "blend": (blend, stage_s.get("blend", 0.0), stats["down_bytes"],
                  "d2h_bytes_per_s"),
    }
    rl = {}
    for name, (est, secs, wire, way) in stages.items():
        if wire > 0:
            est = dict(est, wire_bytes=float(wire))
        src = "wirecodec.STATS" if wire > 0 else "model"
        rl[name] = (roofline.relate(est, secs, link[way]) if link
                    else dict(est)) | {"wire_source": src}
    return rl


def run(workload: Workload | None = None, device=None, warm_runs: int = 3,
        multiband: bool | None = None, report: bool = False,
        inputs: tuple | None = None) -> dict:
    """The headline bench (module docstring); returns the dict it prints.
    ``workload`` defaults to ``FULL`` (``SMALL`` under ``BENCH_SMALL=1``),
    ``multiband`` to on unless ``BENCH_SKIP_MULTIBAND=1``; ``report``
    prints the best run's stage timer report to stderr.  ``inputs``: the
    workload's ``headline_inputs``, when the caller has made them."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if workload is None:
        workload = SMALL if os.environ.get("BENCH_SMALL", "0") == "1" else FULL
    if multiband is None:
        multiband = os.environ.get("BENCH_SKIP_MULTIBAND", "0") != "1"
    w, n = workload, workload.n
    record = device_record(dev)
    link = roofline.measure_link(dev) if on_card else None
    cfg = config(**({} if w.working_size is None
                     else {"SIFT_WORKING_SIZE": w.working_size}))
    key = prng.key((0, 1), dev)                      # PRNGKey(1)
    u8, truth, perm = inputs if inputs is not None else headline_inputs(w)
    batches = -(-n // feature_batch())

    _, _, cold_s = _stitch(u8, cfg, key, dev)
    runs = []
    for rep in range(warm_runs):
        v = u8.copy()
        v[0, 0, 0, 0] = rep
        timer.reset()
        wirecodec.reset_stats()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        before = _launches()
        info = {}
        out, valid, t = _stitch(v, cfg, key, dev, info)
        runs.append(dict(
            wall_s=t, info=info, totals=timer.totals(),
            stats=dict(wirecodec.STATS),
            launches={k: c - before[k] for k, c in _launches().items()},
            peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                      if on_card else None)))
    best = min(runs, key=lambda r: r["wall_s"])
    dt, info, stage_totals = best["wall_s"], best["info"], best["totals"]

    check(out.shape[0] > 100 and out.shape[1] > w.out_w,
          f"canvas {out.shape}")
    check(valid.mean() > VALID_LIMIT, f"valid share {valid.mean():.4f}")
    if on_card:
        for r in runs:
            check(all(c == batches for c in r["launches"].values()),
                  f"K1 / K2 launches {r['launches']}, not {batches} each")

    total_kpts = int(info["kpt_counts"].sum())
    feat_s = sum(s for lbl, (_, s) in stage_totals.items()
                 if lbl in ("upload+calc_feature", "calc_feature"))
    kpts_per_s = total_kpts / feat_s if feat_s > 0 else 0.0
    lm_iters = info.get("lm_iters", 0)
    lm_s = info.get("lm_time_s", 0.0)
    lm_per_s = lm_iters / lm_s if lm_s > 0 else 0.0
    reproj = camera_error(info["homos"], truth, perm, w)
    check(reproj < REPROJ_LIMIT_PX, f"camera quality {reproj:.3f} px")

    stage_s = {lbl: round(s, 3) for lbl, (_, s) in sorted(
        stage_totals.items(), key=lambda kv: -kv[1][1]) if s > 0.005}
    if report:
        print(timer.report(stage_totals), file=sys.stderr)

    if on_card:
        kernel_parity = kernel_check.check(device=dev)
        check(kernel_parity["ok"], f"kernel parity {kernel_parity}")
        parity_note = None
    else:
        kernel_parity = None
        parity_note = ("CPU run: the wrappers run their plain versions, so "
                       "there is no kernel to check and no host link to "
                       "time; the roofline gives the work model's counts "
                       "only, no share of the card's peaks")
    rl = _roofline(w, cfg, out, stage_s, best["stats"], link)

    mb_extra = None
    if multiband:
        cfg_mb = cfg.replace(MULTIBAND=2)
        _stitch(u8, cfg_mb, key, dev)                    # cold
        timer.reset()
        out_mb, valid_mb, mb_wall = _stitch(u8, cfg_mb, key, dev)
        mb_extra = {
            "wall_s": round(mb_wall, 3),
            "img_per_s": round(n / mb_wall, 3),
            "blend_stage_s": {lbl: round(s, 3) for lbl, (_, s)
                              in timer.totals().items()
                              if lbl.startswith("blend")},
            "ncc_vs_linear": round(canvas_ncc(out, valid, out_mb, valid_mb),
                                   4),
            "final_size": [int(out_mb.shape[1]), int(out_mb.shape[0])],
        }
        check(mb_extra["ncc_vs_linear"] > MB_NCC_LIMIT,
              f"multiband {mb_extra}")

    img_per_s = n / dt
    return {
        "metric": "stitch_images_per_s",
        "value": round(img_per_s, 3),
        "unit": "img/s",
        "vs_baseline": round(img_per_s / BASELINE_IMG_PER_S, 3),
        "extra": {
            "images": n,
            "wall_s": round(dt, 3),
            "sift_kpts_per_s_per_chip": round(kpts_per_s, 1),
            "total_kpts": total_kpts,
            "ba_lm_iters_per_s": round(lm_per_s, 1),
            "ba_lm_iters": lm_iters,
            "mean_reproj_err_px": round(reproj, 3),
            "final_size": [int(out.shape[1]), int(out.shape[0])],
            "stage_s": stage_s,
            "roofline": rl,
            "multiband": mb_extra,
            "kernel_parity": kernel_parity,
            "peak_rss_mb": round(timer.peak_rss_mb(), 1),
            **record,
            "baseline": "0.745 img/s: the reference's 38 views in 51 s on "
                        "an i7-6700HQ CPU (BASELINE.md)",
            "cold_wall_s": round(cold_s, 3),
            "warm_walls_s": [round(r["wall_s"], 3) for r in runs],
            "peak_device_gib": (round(best["peak_gib"], 3) if on_card
                                else None),
            "launches": [r["launches"] for r in runs],
            "feature_batches": batches,
            "link": ({k: (v if k == "bytes" else round(v / 1e9, 3))
                      for k, v in link.items()} if link else None),
            "link_unit": "GB/s",
            "wire": {k: best["stats"][k] for k in
                     ("up_bytes", "bg_up_bytes", "down_bytes")},
            "note": parity_note,
        },
    }
