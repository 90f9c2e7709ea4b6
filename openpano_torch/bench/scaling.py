"""Scaling efficiency of the sharded stitch over world sizes, the
counterpart of ``tools/scaling_bench.py``.

Runs the sharded pipeline (``parallel.stitch_sharded``: SIFT, matching,
RANSAC, the incremental LM bundle adjustment, the banded blend) at each
world size of ``--devices``, one process per rank: NCCL ranks, one per
card, on the card; gloo ranks on the CPU (``--device cpu``), each on one
intra-op thread.  The views are ``synth.render_views`` of a
``procedural_scene_large`` (the JAX tool renders its photo; the smaller
``procedural_scene`` is too sparse at these sizes: on an H100 its 8 views
of 320x240 left view 7 unconnected).  Each world size
reports the best of ``--repeat`` timed runs after a warm one, the speedup
over the first size and the efficiency; a world size larger than the
machine's card count raises.

    python -m openpano_torch.bench.scaling [--devices 1 2 4] [--images 8]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from ..config import Config
from ..parallel.spawn import run_ranks
from ..stitch.stitcher import resolve_device
from ..synth import procedural_scene_large, render_views


def config() -> Config:
    """tools/scaling_bench.py:53-59."""
    return Config(ESTIMATE_CAMERA=True, ORDERED_INPUT=False,
                  RANSAC_ITERATIONS=400, SIFT_WORKING_SIZE=300,
                  MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
                  MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
                  MAX_MATCHES_PER_PAIR=512)


def views(n: int, w: int, h: int) -> np.ndarray:
    """n f32 views of w x h of a 30 degree camera yawing at 60% overlap
    (tools/scaling_bench.py:61-65, on procedural data)."""
    scene = procedural_scene_large(5 * h // 2, 15 * w // 2, seed=0)
    v, _ = render_views(scene, n, out_w=w, out_h=h, hfov_deg=30,
                        overlap=0.6, seed=3)
    return np.asarray(v, np.float32)


def _rank(mesh, imgs, repeat: int) -> dict:
    """On every rank: a warm stitch, then ``repeat`` timed ones."""
    import torch

    from ..parallel import stitch_sharded
    from ..parallel.mesh import mesh_device
    from ..utils import prng

    dev = mesh_device(mesh)
    key = prng.key((0, 0), dev)                      # PRNGKey(0)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    canvas = stitch_sharded(imgs, config(), mesh, key=key)
    ts = []
    for _ in range(repeat):
        sync()
        t0 = time.perf_counter()
        canvas = stitch_sharded(imgs, config(), mesh, key=key)
        sync()
        ts.append(time.perf_counter() - t0)
    return {"walls_s": ts, "canvas": canvas}


def run(sizes, images: int = 8, size=(320, 240), repeat: int = 3,
        device=None) -> list[dict]:
    """One result per world size: the JAX tool's keys, every timed wall,
    and rank 0's f32 canvas under ``canvas_f32``."""
    dev = resolve_device(device)
    imgs = views(images, *size)
    results = []
    t1 = None
    with tempfile.TemporaryDirectory() as store:
        for nd in sizes:
            ranked = run_ranks(_rank, nd, store, args=(imgs, repeat),
                               timeout_s=1800.0, device=dev.type)
            walls = ranked[0]["walls_s"]
            dt = min(walls)
            t1 = dt if t1 is None else t1
            canvas = ranked[0]["canvas"]
            results.append({
                "devices": nd, "step_s": round(dt, 4),
                "speedup": round(t1 / dt, 3),
                "efficiency": round(t1 / (dt * nd), 3),
                "canvas": list(canvas.shape[:2]),
                "walls_s": [round(t, 4) for t in walls],
                "canvas_f32": canvas,
            })
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m openpano_torch.bench.scaling")
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(320, 240),
                    metavar=("W", "H"))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.devices:
        sizes = args.devices
    else:
        import torch

        avail = torch.cuda.device_count() if dev.type == "cuda" else 8
        sizes = [d for d in (1, 2, 4, 8, 16) if d <= avail]
    from . import device_record

    results = run(sizes, args.images, tuple(args.size), args.repeat,
                  args.device)
    for r in results:
        r.pop("canvas_f32")
        print(json.dumps(r), flush=True)
    print(json.dumps({"scaling": results, **device_record(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
