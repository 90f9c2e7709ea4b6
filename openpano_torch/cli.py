"""Command-line interface.

Reference: src/main.cc; counterpart of ``openpano_tpu/cli.py``, with the same
modes, flags, printed lines and artifacts.  The default mode stitches the
given images (work(), main.cc:205-235); the debug modes draw one pipeline
stage each (keypoint / raw_extrema / orientation / match / inlier / warp /
planet, main.cc:41-202,294-331) and write images under log/.  The config
is read from ``config.cfg`` in the working directory (or ``-c``), in the
reference's format with its fatal missing-key rule (init_config,
main.cc:237-292).  Everything runs on the card unless ``--device`` names
another device.

Usage:
  python -m openpano_torch.cli img1.png img2.png ... [-o out.png]
  python -m openpano_torch.cli --device cpu -c config.cfg a.png b.png
  python -m openpano_torch.cli --mode keypoint img.png
  python -m openpano_torch.cli --mode match img1.png img2.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .config import Config


def load_config(path: str | None) -> Config:
    if path and os.path.exists(path):
        return Config.from_file(path)
    if path:
        raise SystemExit(f"Cannot find config file {path}")
    if os.path.exists("config.cfg"):
        return Config.from_file("config.cfg")
    return Config()


def _detect(img: np.ndarray, cfg: Config, dev):
    """Features of one float RGB image (the float grey route)."""
    from .stitch.stitcherbase import compute_features

    return compute_features(torch.from_numpy(img)[None].to(dev), cfg)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _logpath(name: str) -> str:
    os.makedirs("log", exist_ok=True)
    return os.path.join("log", name)


def _write(name: str, img: np.ndarray) -> None:
    from .io.image import write_rgb

    out = _logpath(name)
    write_rgb(out, img)
    print(f"Wrote {out}")


def mode_keypoint(args, cfg):
    from .io.image import read_img
    from .utils.draw import PlaneDrawer

    img = read_img(args.images[0])
    feats = _detect(img, cfg, args.dev)
    pos = _host(feats.pos[0])[_host(feats.valid[0])]
    print(f"Found {len(pos)} keypoints")
    pld = PlaneDrawer(img.copy())
    h, w = img.shape[:2]
    for x, y in pos:
        pld.cross(x + w / 2, y + h / 2, 3)
    _write("keypoint.jpg", pld.img)


def _scale_space(img: np.ndarray, cfg: Config, dev):
    """The octaves of one float RGB image at the SIFT working size
    (feature.cc:31-36), batch of one."""
    from .ops.imgproc import resize, rgb2grey, working_size
    from .sift.pyramid import build_scale_space

    h, w = img.shape[:2]
    wh, ww = working_size(w, h, cfg.SIFT_WORKING_SIZE)
    work = resize(torch.from_numpy(img).to(dev), wh, ww, rgb=True)
    return build_scale_space(rgb2grey(work)[None], cfg)


def mode_raw_extrema(args, cfg):
    """Draw unrefined DoG extrema candidates (test_extrema mode 0,
    main.cc:41-58 / ExtremaDetector::get_raw_extrema)."""
    from .io.image import read_img
    from .sift.extrema import _candidate_mask
    from .utils.draw import PlaneDrawer

    img = read_img(args.images[0])
    h, w = img.shape[:2]
    pld = PlaneDrawer(img.copy())
    total = 0
    for octave in _scale_space(img, cfg, args.dev):
        mask = _host(_candidate_mask(octave.dog, cfg)[0])
        oh, ow = mask.shape[1], mask.shape[2]
        ss, yy, xx = np.nonzero(mask)
        total += len(ss)
        for y, x in zip(yy, xx):
            pld.cross(x / ow * w, y / oh * h, 3)
    print(f"Raw extrema: {total}")
    _write("extrema.jpg", pld.img)


def mode_orientation(args, cfg):
    """Draw oriented keypoints as arrows (test_orientation, main.cc:65-82):
    per octave, its refined extrema oriented on its own planes."""
    from .io.image import read_img
    from .sift.detector import octave_caps
    from .sift.extrema import detect_extrema
    from .sift.orientation import orient_keypoints
    from .utils.draw import PlaneDrawer

    img = read_img(args.images[0])
    h, w = img.shape[:2]
    pld = PlaneDrawer(img.copy())
    rng = np.random.default_rng(0)
    total = 0
    for oi, octave in enumerate(_scale_space(img, cfg, args.dev)):
        caps = octave_caps(cfg, oi)
        raw = detect_extrema(octave, cfg, cap_cand=caps[0], cap_kp=caps[1])
        ori, _ = orient_keypoints(raw, octave.mag, octave.ort, cfg,
                                  cap=caps[2])
        keep = _host(ori.valid[0])
        xs = _host(ori.real_x[0])[keep] * w
        ys = _host(ori.real_y[0])[keep] * h
        dirs = _host(ori.dir[0])[keep]
        total += len(xs)
        for x, y, d in zip(xs, ys, dirs):
            pld.set_rand_color(rng)
            pld.arrow(x, y, d, 7)
    print(f"FeaturePoint size: {total}")
    _write("orientation.jpg", pld.img)


def mode_match(args, cfg, draw_inliers=False):
    from .geometry.ransac import estimate_transform
    from .io.image import read_img
    from .match.matcher import match_pair
    from .ops.imgproc import hconcat
    from .utils import prng
    from .utils.draw import PlaneDrawer

    img1 = read_img(args.images[0])
    img2 = read_img(args.images[1])
    f1 = _detect(img1, cfg, args.dev)
    f2 = _detect(img2, cfg, args.dev)
    res = match_pair(f1.desc[0], f1.valid[0], f2.desc[0], f2.valid[0], cfg)
    print(f"Match size: {int(res.count[0])}")

    pld = PlaneDrawer(hconcat([img1, img2]))
    rng = np.random.default_rng(0)
    h1, w1 = img1.shape[:2]
    h2, w2 = img2.shape[:2]

    if draw_inliers:
        whs = torch.tensor([[w1, h1], [w2, h2]], dtype=torch.float32,
                           device=args.dev)
        info = estimate_transform(
            res, f1.pos, f1.valid, f2.pos, f2.valid, whs[0:1], whs[1:2],
            prng.key((0, 0), args.dev)[None], cfg, affine=cfg.TRANS)
        print(f"Confidence: {float(info.confidence[0]):.3f}, inliers: "
              f"{int(info.count[0])}")
        pts1 = _host(info.to_pos[0])[_host(info.valid[0])]
        pts2 = _host(info.from_pos[0])[_host(info.valid[0])]
    else:
        idx = _host(res.idx[0])[_host(res.valid[0])]
        pts1 = _host(f1.pos[0])[idx[:, 0]]
        pts2 = _host(f2.pos[0])[idx[:, 1]]

    for (x1, y1), (x2, y2) in zip(pts1, pts2):
        pld.set_rand_color(rng)
        a = (x1 + w1 / 2, y1 + h1 / 2)
        b = (x2 + w2 / 2 + w1, y2 + h2 / 2)
        pld.circle(*a, 4)
        pld.circle(*b, 4)
        pld.line(*a, *b)
    _write("inlier.jpg" if draw_inliers else "match.jpg", pld.img)


def mode_warp(args, cfg):
    from .io.image import read_img
    from .stitch.warp import make_projector, warp_image

    img = read_img(args.images[0])
    h, w = img.shape[:2]
    proj = make_projector(w, h, 1.0, cfg)
    warped = _host(warp_image(proj, torch.from_numpy(img).to(args.dev),
                              proj.out_h, proj.out_w, w, h))
    _write("warped.jpg", np.where(warped < 0, 1.0, warped))


def planet(img: np.ndarray, out_size: int = 1000) -> np.ndarray:
    """Toy polar remap of a float RGB image (main.cc:294-331), host numpy."""
    h, w = img.shape[:2]
    c = out_size / 2
    ii, jj = np.mgrid[0:out_size, 0:out_size].astype(np.float64)
    dist = np.hypot(c - ii, c - jj)
    ok = (dist < c) & (dist > 0)
    r = h - dist / c * h
    r = np.minimum(r, h - 1)
    theta = np.arctan2(c - ii, c - jj) % (2 * np.pi)
    sx = np.clip(theta / (2 * np.pi) * w, 0, w - 2)
    sy = np.clip(r, 0, h - 2)
    x0 = sx.astype(int)
    y0 = sy.astype(int)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    out = (
        img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx
    )
    out[~ok] = 1.0
    return out.astype(np.float32)


def mode_planet(args, cfg):
    from .io.image import read_img

    _write("planet.jpg", planet(read_img(args.images[0])))


def mode_stitch(args, cfg):
    from .io.image import read_img_u8, write_rgb
    from .stitch.cylstitcher import stitch_cylinder
    from .stitch.stitcher import stitch, stitch_hetero
    from .utils import prng

    t0 = time.time()
    imgs = [read_img_u8(f) for f in args.images]
    shapes = {im.shape for im in imgs}
    print(f"Read {len(imgs)} images in {time.time()-t0:.2f}s")

    t0 = time.time()
    key = prng.key((args.seed >> 32, args.seed), args.dev)  # PRNGKey(seed)
    info = {}
    graph = None
    if args.load_matchinfo:
        # the reference's fixture workflow (debug.cc:127-140, hook at
        # stitcher.cc:43-47): reload the dumped match graph and skip the
        # feature and match stages
        from .io.artifacts import load_matchinfo_text

        graph = load_matchinfo_text(
            args.load_matchinfo, len(imgs), cfg.MAX_MATCHES_PER_PAIR)
        print(f"Loaded match graph from {args.load_matchinfo}")
    if cfg.CYLINDER:
        if len(shapes) != 1:
            raise SystemExit("CYLINDER mode requires uniform image sizes")
        if graph is not None:
            raise SystemExit("--load-matchinfo is not supported in CYLINDER "
                             "mode (it matches warped keypoints)")
        canvas, valid = stitch_cylinder(np.stack(imgs), cfg, key,
                                        output="u8", device=args.dev)
    elif len(shapes) != 1:
        # mixed sizes: per-shape feature buckets + sentinel-padded blend
        canvas, valid = stitch_hetero(imgs, cfg, key, output="u8",
                                      device=args.dev, info_out=info)
    else:
        canvas, valid = stitch(np.stack(imgs), cfg, key, output="u8",
                               device=args.dev, info_out=info, graph=graph)
    print(f"Stitched in {time.time()-t0:.2f}s")
    if args.dump_matchinfo and "graph" in info:
        from .io.artifacts import dump_matchinfo_text

        dump_matchinfo_text(args.dump_matchinfo, info["graph"])
        print(f"Dumped match graph to {args.dump_matchinfo}")
    if args.debug_blend and "plan" in info:
        _debug_blend_dumps(imgs, info["plan"], args.dev)
    print(f"Final Image Size: ({canvas.shape[1]}, {canvas.shape[0]})")
    if info:
        # per-stage counts and residuals in one machine-readable line
        # beside the human-readable prints (SURVEY §5.5)
        metrics = {
            "kpt_counts": [int(c) for c in info.get("kpt_counts", [])],
            "connected_pairs": info.get("connected_pairs"),
            "total_inliers": info.get("total_inliers"),
            "ba_rms_px": round(info["ba_rms_px"], 4)
            if "ba_rms_px" in info else None,
            "ba_pairs": info.get("ba_pairs"),
            "ba_lm_iters": info.get("lm_iters"),
            "final_size": [int(canvas.shape[1]), int(canvas.shape[0])],
        }
        print("metrics: " + json.dumps(metrics))

    if cfg.CROP:
        from .ops.imgproc import crop_with_mask

        canvas = crop_with_mask(canvas, valid)
        print(f"Cropped to: ({canvas.shape[1]}, {canvas.shape[0]})")
    write_rgb(args.output, canvas)
    print(f"Wrote {args.output}")


def _debug_blend_dumps(imgs, plan, dev):
    """Per-image blender renders, the LinearBlender::debug_run analog
    (stitch/debug.cc:19-43): each image rendered alone onto the full
    canvas, written to log/blended-<i>.jpg."""
    from .stitch.render import blend

    stack = np.stack([np.asarray(im, np.float32) / 255.0
                      if np.asarray(im).dtype == np.uint8 else np.asarray(im)
                      for im in imgs])
    src = torch.from_numpy(stack).to(dev)
    for i in range(len(imgs)):
        sel = plan.items[:, 0] == i
        if not sel.any():
            continue
        sub = plan._replace(items=plan.items[sel])
        canvas = _host(blend(src, sub, ordered=False, multiband=0))
        _write(f"blended-{i:02d}.jpg", np.where(canvas < 0, 1.0, canvas))


MODES = {
    "stitch": mode_stitch,
    "keypoint": mode_keypoint,
    "match": lambda a, c: mode_match(a, c, draw_inliers=False),
    "inlier": lambda a, c: mode_match(a, c, draw_inliers=True),
    "warp": mode_warp,
    "planet": mode_planet,
    "raw_extrema": mode_raw_extrema,
    "orientation": mode_orientation,
}


def main(argv=None):
    from .stitch.stitcher import resolve_device
    from .utils import timer

    ap = argparse.ArgumentParser(
        prog="openpano_torch",
        description="Panorama stitcher on an NVIDIA card "
                    "(OpenPano-compatible)",
    )
    ap.add_argument("images", nargs="+", help="input image files")
    ap.add_argument("-o", "--output", default="out.jpg")
    ap.add_argument("-c", "--config", default=None, help="config.cfg path")
    ap.add_argument(
        "--mode", default="stitch", choices=sorted(MODES),
        help="debug modes visualize one pipeline stage (reference main.cc)",
    )
    ap.add_argument("--seed", type=int, default=0, help="RANSAC PRNG seed")
    ap.add_argument(
        "--dump-matchinfo", metavar="PATH", default=None,
        help="dump the match graph in the reference's text format "
             "(debug.cc:111-125) after stitching",
    )
    ap.add_argument(
        "--load-matchinfo", metavar="PATH", default=None,
        help="load a dumped match graph and skip feature+match "
             "(debug.cc:127-140)",
    )
    ap.add_argument(
        "--debug-blend", action="store_true",
        help="write per-image blender renders to log/ "
             "(LinearBlender::debug_run, debug.cc:19-43)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' runs "
             "the kernels' plain versions)",
    )
    args = ap.parse_args(argv)
    args.dev = resolve_device(args.device)

    cfg = load_config(args.config)
    MODES[args.mode](args, cfg)
    # per-label accumulated timings at exit, like the reference's
    # TotalTimerGlobalGuard (lib/timer.hh:70-84, printed from main.cc:336),
    # and the peak RSS (the reference measured it with src/memusg)
    rep = timer.report()
    if rep:
        print(rep)
    print(f"peak rss: {timer.peak_rss_mb():.0f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
