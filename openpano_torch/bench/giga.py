"""Large-canvas benches (BASELINE.md's "UAV translation/affine mode with
large sharded canvas" and "synthetic 500-image gigapixel pano"), the
counterpart of ``tools/giga_bench.py`` with its arguments, defaults, modes
and Configs.

- ``trans`` (the default): an n-view translating strip of
  ``synth.strip_views`` (the procedural texture; the JAX tool crops its
  photo) stitched in TRANS mode; cold, then timed.  The views' true offsets
  give its gates (``trans_gates``): every adjacent pair connects, each
  pairwise transform within 6 px of its views' offset, the canvas width
  within 5% of the true extent, and on the card K1 and K2 launched once
  per feature batch.  GIGA_r04.json's run:
  ``--images 500 --size 500 560 --overlap 0.7 --working-size 400``.
- ``rot``: a yaw x pitch serpentine grid (62x8 of 2200x1400, f = 12000 px)
  rendered from ``procedural_scene_large`` at half the views' angular
  resolution, stitched with ESTIMATE_CAMERA over the ordered ring; run
  once.  Its reprojection error is measured against the true rotations.
- ``trans2d``: a 25x20 serpentine grid of 2000x1200 crops at ``--overlap``
  (0.4 by default, as the JAX tool's default, where its docstring says
  35%) from one ``procedural_scene_large(seed=13)`` texture, in TRANS
  mode; run once.

The rot and trans2d data take minutes to make: the scene and the views are
built in blocks over one spawned process per CPU, and the views are cached
under the temporary directory (``--no-cache`` makes them anew).  Each mode
prints one JSON line with the JAX tool's keys, plus the card's name and
power limit, peak device memory, peak host RSS beside the machine's memory,
the K1 / K2 launches and the seconds the data took.

    python -m openpano_torch.bench.giga [--mode trans|rot|trans2d] [...]

``--mesh N`` shards the stitch over N ranks: start one process per rank
(``torchrun --nproc-per-node N``), each with the same arguments; rank 0
prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import stitch_images, synth
from ..config import Config
from ..ops import windows
from ..stitch import stitcher
from ..stitch.stitcherbase import FEATURE_BATCH
from ..utils import prng, timer
from . import device_record, host_memory, sync

PAIR_LIMIT_PX = 6.0        # a pairwise transform against its views' offset
EXTENT_TOL = 0.05          # the canvas width against the true extent


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m openpano_torch.bench.giga")
    ap.add_argument("--images", type=int, default=60)
    ap.add_argument("--size", type=int, nargs=2, default=(1300, 560),
                    metavar=("W", "H"))
    ap.add_argument("--overlap", type=float, default=0.4)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the pipeline over N ranks, one process each")
    ap.add_argument("--working-size", type=int, default=640,
                    help="SIFT_WORKING_SIZE (large-n runs want smaller)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", choices=("trans", "rot", "trans2d"),
                    default="trans")
    ap.add_argument("--grid", type=int, nargs=2, default=(62, 8),
                    metavar=("COLS", "ROWS"), help="rot mode: yaw x pitch")
    ap.add_argument("--focal", type=float, default=12000.0)
    ap.add_argument("--pitch-px", type=float, default=770.0,
                    help="rot mode: vertical canvas step per pitch row")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--multipass", type=int, default=1,
                    help="rot mode: MULTIPASS_BA level (1 = incremental; "
                         "the banded chain solver keeps n~500 tractable)")
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    ap.add_argument("--dump-matchinfo", default=None, metavar="PATH",
                    help="rot mode: write the match graph as the "
                         "reference's matchinfo text")
    args = ap.parse_args(argv)
    args.size, args.grid = tuple(args.size), tuple(args.grid)
    if args.mode == "trans2d":
        if args.size == (1300, 560):
            args.size = (2000, 1200)
        if args.grid == (62, 8):
            args.grid = (25, 20)
    elif args.mode == "rot" and args.size == (1300, 560):
        args.size = (2200, 1400)    # rot default: narrow-fov tall views
    return args


def trans_config(working_size: int) -> Config:
    """tools/giga_bench.py:104-112: large-n capacity, ~600 keypoints a view
    at working size 400, so the 2048 cap would spend 4x the pair-distance
    memory for nothing."""
    return Config(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True,
                  MAX_OUTPUT_SIZE=79000, MAX_KP_PER_IMAGE=1024,
                  MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=working_size)


# the corner-dense procedural scene needs keypoint headroom, or the
# per-octave caps truncate candidates in scan order and vertical grid pairs
# cannot match (tools/giga_bench.py:207-219, 323-330)
GRID_CAPS = dict(MAX_OUTPUT_SIZE=79000, MAX_KP_PER_IMAGE=2048,
                 MAX_MATCHES_PER_PAIR=512, MAX_CAND_PER_OCTAVE=4096,
                 MAX_KP_PER_OCTAVE=2048, MAX_DESC_PER_OCTAVE=2048)


def rot_config(working_size: int, multipass: int) -> Config:
    """tools/giga_bench.py:211-219."""
    return Config(ESTIMATE_CAMERA=True, ORDERED_INPUT=True,
                  MULTIPASS_BA=multipass, SIFT_WORKING_SIZE=working_size,
                  **GRID_CAPS)


def trans2d_config(working_size: int) -> Config:
    """tools/giga_bench.py:323-330."""
    return Config(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True,
                  SIFT_WORKING_SIZE=working_size, **GRID_CAPS)


def strip_placement(info: dict, xy: np.ndarray, w: int,
                    h: int) -> tuple[list[float], float]:
    """TRANS placement against the views' true top-left offsets ``xy``, as
    the largest error of the views' corners: each pairwise transform (k-1,
    k) on its own, and the chain from the middle view (TRANS homographies
    carry 1/f with f = (w + h) / 2).  Returns (pairwise errors, chain
    error)."""
    corners = np.array([[-w / 2, -h / 2, 1], [w / 2, -h / 2, 1],
                        [-w / 2, h / 2, 1], [w / 2, h / 2, 1]])

    def corner_err(H, shift):
        p = corners @ H.T
        return float(np.abs(p[:, :2] / p[:, 2:] - corners[:, :2]
                            - shift).max())

    n = len(xy)
    homo = info["graph"].homo
    pair_err = [corner_err(homo[k - 1, k], xy[k] - xy[k - 1])
                for k in range(1, n)]
    f = 0.5 * (w + h)
    mid = n >> 1
    chain = max(corner_err(info["homos"][k] * [[f], [f], [1]],
                           xy[k] - xy[mid]) for k in range(n))
    return pair_err, chain


def _workers() -> int:
    return len(os.sched_getaffinity(0))


def _mesh(args):
    if not args.mesh:
        return None
    from ..parallel import init_distributed, make_mesh

    init_distributed(device=args.device)
    return make_mesh(args.mesh)


def _timed(views, cfg: Config, key, dev, mesh, info=None):
    """One stitch, u8 out, with the launch counts, the stage timer and the
    peak device memory reset before it.  Returns (canvas, valid, record)."""
    timer.reset()
    before = (windows.orientation_histogram.launches,
              windows.descriptor_histogram.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    out, valid = stitch_images(views, cfg, key=key, output="u8",
                               device=None if mesh else dev, info_out=info,
                               mesh=mesh)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = {"orientation_histogram":
                windows.orientation_histogram.launches - before[0],
                "descriptor_histogram":
                windows.descriptor_histogram.launches - before[1]}
    return out, valid, {
        "wall_s": round(dt, 3),
        "img_per_s": round(len(views) / dt, 2),
        "stage_s": {k: round(s, 3) for k, (_, s) in sorted(
            timer.totals().items(), key=lambda kv: -kv[1][1]) if s > 0.01},
        "peak_device_gib": (round(torch.cuda.max_memory_allocated(dev)
                                  / 2**30, 3) if dev.type == "cuda" else None),
        "launches": launches,
        "feature_batches": -(-len(views) // FEATURE_BATCH),
    }


def _canvas(out, valid) -> dict:
    mp = out.shape[0] * out.shape[1] / 1e6
    return {"canvas": [int(out.shape[1]), int(out.shape[0])],
            "megapixels": round(mp, 1),
            "valid_megapixels": round(mp * float(valid.mean()), 1),
            "valid_frac": round(float(valid.mean()), 3)}


def _host_path(shape) -> dict:
    return {"paired_gb": round(stitcher.paired_gb(shape), 2),
            "host_stream": bool(stitcher.stays_on_host(shape)),
            "host_stream_bands": (stitcher.host_stream_groups(shape)
                                  if stitcher.stays_on_host(shape) else None)}


def run_trans(args, cold: bool = True) -> dict:
    """The UAV strip: cold (unless ``cold`` is False), then timed."""
    dev = stitcher.resolve_device(args.device)
    n = args.images
    w, h = args.size
    cfg = trans_config(args.working_size)
    t0 = time.perf_counter()
    views, xy = synth.strip_views(n, w, h, overlap=args.overlap, seed=0,
                                  offsets=True)
    views8 = np.round(views * 255.0).astype(np.uint8)
    del views
    setup_s = time.perf_counter() - t0
    mesh = _mesh(args)
    key = prng.key((0, 0), dev)                      # PRNGKey(0)
    cold_s = None
    if cold:
        cold_s = _timed(views8, cfg, key, dev, mesh)[2]["wall_s"]
    info = {}
    out, valid, rec = _timed(views8, cfg, key, dev, mesh, info)
    conf = info["graph"].conf
    pair_err, chain = strip_placement(info, xy, w, h)
    span = xy.max(0) - xy.min(0) + [w, h]
    scale = min(1.0, cfg.MAX_OUTPUT_SIZE / span.max())
    result = {
        "images": n, **_canvas(out, valid),
        "wall_s": rec["wall_s"], "img_per_s": rec["img_per_s"],
        "mpix_per_s": round(out.shape[0] * out.shape[1] / 1e6
                            / rec["wall_s"], 1),
        "mesh": args.mesh or 1, "stage_s": rec["stage_s"],
        "mode": "trans", **device_record(dev), "cold_wall_s": cold_s,
        "setup_s": round(setup_s, 3),
        "peak_device_gib": rec["peak_device_gib"], **host_memory(),
        "launches": rec["launches"], "feature_batches": rec["feature_batches"],
        **_host_path(views8.shape),
        "adjacent_connected": bool(all(conf[k, k + 1] > 0
                                       for k in range(n - 1))),
        "max_pair_offset_err_px": round(max(pair_err), 3),
        "chain_drift_px": round(chain, 3),
        "true_extent": [int(round(span[0] * scale)),
                        int(round(span[1] * scale))],
    }
    if args.out:
        from ..io.image import write_rgb

        write_rgb(args.out, out)
    return result


def trans_gates(result: dict) -> list[str]:
    """The UAV strip's failed gates (module docstring); empty when it
    passed.  The chain's drift, the canvas height and the valid share are
    reported, not gated: the jittered chain of 500 affine steps drifts."""
    bad = []
    if not result["adjacent_connected"]:
        bad.append("an adjacent pair did not connect")
    err = result["max_pair_offset_err_px"]
    if not err < PAIR_LIMIT_PX:
        bad.append(f"a pairwise transform is {err} px off its views' offset")
    want = result["true_extent"][0]
    if abs(result["canvas"][0] - want) > EXTENT_TOL * want:
        bad.append(f"canvas width {result['canvas'][0]} against the true "
                   f"extent {want}")
    batches = result["feature_batches"]
    if result["device"] != "cpu" and any(
            c != batches for c in result["launches"].values()):
        bad.append(f"K1 / K2 launches {result['launches']}, not "
                   f"{result['feature_batches']} each")
    return bad


def _cache(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def rot_views(args):
    """The rotational grid's u8 views (from the cache when there), their
    true rotations, and the scene's (h, w) when it was built."""
    cols, rows = args.grid
    w, h = args.size
    f = args.focal
    yaw_step = 2 * np.pi / cols            # full-circle wrap
    pitch_step = args.pitch_px / f
    Rs, _ = synth.serpentine_rotations(cols, rows, yaw_step, pitch_step)
    cache = _cache(f"giga_rot_views_{cols}x{rows}_{w}x{h}_{f}.npy")
    scene_hw = None
    if os.path.exists(cache) and not args.no_cache:
        views8 = np.load(cache)
        print(f"# views from cache {cache}", file=sys.stderr)
    else:
        phi_need = (rows / 2) * pitch_step + np.arctan((h / 2) / f) + 0.03
        # the scene at half the views' angular resolution: the SIFT working
        # resize (~2.25x down) sits below even the halved Nyquist
        we = int(np.pi * f) // 2 * 2
        he = int(we * (2 * phi_need) / (2 * np.pi)) // 2 * 2
        scene_hw = [he, we]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            scene = os.path.join(tmp, "scene.npy")
            print(f"# scene {he}x{we} ...", file=sys.stderr)
            synth.procedural_scene_large_to(scene, he, we, seed=11,
                                            workers=_workers())
            print(f"# scene built in {time.perf_counter() - t0:.0f} s; "
                  f"rendering {len(Rs)} views", file=sys.stderr)
            dst = os.path.join(tmp, "views.npy") if args.no_cache \
                else cache + ".part"
            synth.render_views_sphere_to(dst, scene, Rs, w, h, f,
                                         workers=_workers())
            views8 = np.load(dst)
            if not args.no_cache:
                os.replace(dst, cache)
    return views8, Rs, scene_hw


def rot_errors(homos: np.ndarray, Rs: np.ndarray, f: float, w: int,
               h: int) -> np.ndarray:
    """The mean reprojection error of each consecutive pair (i, i + 1)'s
    recovered homography against the true rotations', on a grid over the
    view (tools/giga_bench.py:235-248)."""
    gx, gy = np.meshgrid(np.linspace(-w * 0.4, w * 0.4, 7),
                         np.linspace(-h * 0.4, h * 0.4, 5))
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], 1)
    errs = []
    for i in range(len(homos) - 1):
        H_est = np.linalg.inv(homos[i]) @ homos[i + 1]
        H_gt = synth.gt_rot_pair_homography(f, Rs[i], Rs[i + 1])
        pe, pg = grid @ H_est.T, grid @ H_gt.T
        errs.append(np.linalg.norm(pe[:, :2] / pe[:, 2:3]
                                   - pg[:, :2] / pg[:, 2:3], axis=1).mean())
    return np.asarray(errs)


def run_rot(args) -> dict:
    """The rotational gigapixel grid, run once."""
    dev = stitcher.resolve_device(args.device)
    cols, rows = args.grid
    n = cols * rows
    w, h = args.size
    t0 = time.perf_counter()
    views8, Rs, scene_hw = rot_views(args)
    setup_s = time.perf_counter() - t0
    print(f"# views ready in {setup_s:.0f} s", file=sys.stderr)

    cfg = rot_config(args.working_size, args.multipass)
    mesh = _mesh(args)
    info = {}
    out, valid, rec = _timed(views8, cfg, prng.key((0, 0), dev), dev, mesh,
                             info)
    errs = rot_errors(info["homos"], Rs, args.focal, w, h)
    if args.dump_matchinfo:
        from ..io.artifacts import dump_matchinfo_text

        dump_matchinfo_text(args.dump_matchinfo, info["graph"])
    focal = info["cams"].focal
    result = {
        "mode": "rot-gigapixel", "images": n, "grid": [cols, rows],
        **_canvas(out, valid), "wall_s": rec["wall_s"],
        "img_per_s": rec["img_per_s"],
        "mean_reproj_err_px": round(float(np.mean(errs)), 3),
        "lm_iters": info.get("lm_iters"), "mesh": args.mesh or 1,
        **host_memory(), "stage_s": rec["stage_s"],
        **device_record(dev), "setup_s": round(setup_s, 1),
        "scene": scene_hw, "lm_time_s": round(info.get("lm_time_s", 0.0), 3),
        "reproj_err_px_p50_p90_max": [round(float(np.percentile(errs, q)), 3)
                                      for q in (50, 90, 100)],
        "focal_px_min_median_max": [round(float(v), 1) for v in (
            focal.min(), np.median(focal), focal.max())],
        "connected_pairs": info.get("connected_pairs"),
        "peak_device_gib": rec["peak_device_gib"],
        "launches": rec["launches"], "feature_batches": rec["feature_batches"],
        **_host_path(views8.shape),
    }
    if args.out:
        from ..io.image import write_rgb

        write_rgb(args.out, out[::8, ::8])
    return result


def run_trans2d(args) -> dict:
    """The 2-D survey grid, run once."""
    dev = stitcher.resolve_device(args.device)
    cols, rows = args.grid
    n = cols * rows
    w, h = args.size
    ov = args.overlap
    sx = int(w * (1 - ov))
    sy = int(h * (1 - ov))
    rng = np.random.default_rng(3)
    cache = _cache(f"giga_t2d_{cols}x{rows}_{w}x{h}_{ov}.npy")
    t0 = time.perf_counter()
    # the views' top-left texture offsets, in serpentine order
    xy = np.empty((n, 2), np.int64)
    k = 0
    for r in range(rows):
        for c in (range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)):
            xy[k] = (c * sx + int(rng.integers(0, 33)),
                     r * sy + int(rng.integers(0, 33)))
            k += 1
    if os.path.exists(cache) and not args.no_cache:
        views8 = np.load(cache)
    else:
        th = (rows - 1) * sy + h + 64
        tw = (cols - 1) * sx + w + 64
        print(f"# texture {th}x{tw} ...", file=sys.stderr)
        with tempfile.TemporaryDirectory() as tmp:
            tex_path = os.path.join(tmp, "texture.npy")
            synth.procedural_scene_large_to(tex_path, th, tw, seed=13,
                                            dtype=np.uint8, workers=_workers())
            tex = np.load(tex_path, mmap_mode="r")
            views8 = np.empty((n, h, w, 3), np.uint8)
            for k, (x0, y0) in enumerate(xy):
                views8[k] = tex[y0:y0 + h, x0:x0 + w]
            del tex
        if not args.no_cache:
            np.save(cache + ".part.npy", views8)
            os.replace(cache + ".part.npy", cache)
    setup_s = time.perf_counter() - t0
    print(f"# views ready in {setup_s:.0f} s", file=sys.stderr)

    cfg = trans2d_config(args.working_size)
    mesh = _mesh(args)
    info = {}
    out, valid, rec = _timed(views8, cfg, prng.key((0, 0), dev), dev, mesh,
                             info)
    pair_err, chain = strip_placement(info, xy, w, h)
    return {
        "mode": "trans2d-gigapixel", "images": n, "grid": [cols, rows],
        **_canvas(out, valid), "wall_s": rec["wall_s"],
        "img_per_s": rec["img_per_s"], **host_memory(),
        "stage_s": rec["stage_s"], **device_record(dev),
        "setup_s": round(setup_s, 1),
        "peak_device_gib": rec["peak_device_gib"],
        "launches": rec["launches"], "feature_batches": rec["feature_batches"],
        "adjacent_connected": bool(all(info["graph"].conf[k, k + 1] > 0
                                       for k in range(n - 1))),
        "max_pair_offset_err_px": round(max(pair_err), 3),
        "chain_drift_px": round(chain, 3),
        **_host_path(views8.shape),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode == "rot":
        result, bad = run_rot(args), []
    elif args.mode == "trans2d":
        result, bad = run_trans2d(args), []
    else:
        result = run_trans(args)
        bad = trans_gates(result)
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_rank() != 0):
        print(json.dumps(result))
    for msg in bad:
        print(f"gate failed: {msg}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
