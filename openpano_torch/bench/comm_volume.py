"""The bytes each rank hands the collectives in each sharded stage, the
counterpart of ``tools/comm_volume.py``.

    python -m openpano_torch.bench.comm_volume [--device cpu]
        [--devices 1 2 3 4] [--images 8] [--size 320 240]

The JAX tool compiles each sharded program and walks its HLO for
collective ops: what the compiler planned, per device and execution.  Here
the ranks run the stages, and ``parallel.mesh.BYTES`` (every collective
adds the bytes this rank hands it) is read around each: what the
collectives were actually sent.  One process per rank at each world size of
``--devices``: gloo ranks on the CPU (``--device cpu``), NCCL ranks on the
cards (at most the machine's count).  One JSON line per world size, with
the JAX tool's sections and each rank's counts:

- ``feature``: ``stitcherbase.compute_features_sharded`` on the views of
  ``bench.scaling`` (``--images`` of ``--size``) under its Config.  The
  JAX package's devices compute with no collective and the host fetches
  the features; here every rank computes its shard with no collective
  (``compute_bytes``, 0) and all-gathers the fixed-cap Features
  (``gather_bytes``, L x K x (2 + 128) f32 and K bools per rank's L
  images), which is also what replicates the descriptors for matching;
- ``match_ransac``: ``build_pairwise_graph(mesh=)`` on those features:
  the match and RANSAC results all-gathered over the pair axis, and
  ``replicated_operand_bytes_per_device``, the JAX tool's count of the
  descriptors every rank holds;
- ``dist_ba``: one LM iteration of ``parallel.dist_ba`` at 38 cameras and
  256 pair slots of 32 points (the JAX tool's problem, seeded): the bytes
  of two iterations less those of one, against the closed form of the
  dense f64 normal equations and the cost's two sums, ((6n)^2 + 6n + 2) x
  8 B;
- ``blend_sharded``: ``render.blend_linear_sharded`` of the JAX tool's
  12-view flat plan (640x480 views 200 px apart): the halo sent right and
  the strips all-gathered.

The JAX tool's ``derived_two_host`` efficiency rests on its TPU stage
times and an assumed link rate; it is not derived here (null).
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from ..stitch.stitcher import resolve_device
from . import device_record
from .scaling import config, views

N_CAMS, SLOTS, SLOT_POINTS = 38, 256, 32     # comm_volume.py:105-107
BLEND_VIEWS, BLEND_W, BLEND_H = 12, 640, 480  # comm_volume.py:153


def ba_iteration_bytes(n_cam: int = N_CAMS) -> int:
    """Closed form of one dense LM iteration's all-reduce: JtJ and Jtb of
    6n parameters, then the trial cost's two sums, all f64."""
    p = 6 * n_cam
    return (p * p + p + 2) * 8


def _ba_problem(dev):
    import torch

    from ..camera.bundle_adjuster import BAPairProblem

    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    prob = BAPairProblem(
        pt_to=t(rng.uniform(0, 800, (SLOTS, SLOT_POINTS, 2))),
        pt_from=t(rng.uniform(0, 800, (SLOTS, SLOT_POINTS, 2))),
        w=t(np.ones((SLOTS, SLOT_POINTS))),
        cam_to=t(rng.integers(0, N_CAMS, SLOTS), torch.int64),
        cam_from=t(rng.integers(0, N_CAMS, SLOTS), torch.int64),
        swapped=t(np.zeros(SLOTS, bool), torch.bool),
        pair_w=t(np.ones(SLOTS)))
    params = t(rng.uniform(500, 900, (N_CAMS, 6)))
    return params, prob


def _blend_plan():
    from ..stitch.render import plan_render

    homos = np.stack([np.eye(3) for _ in range(BLEND_VIEWS)])
    for i in range(BLEND_VIEWS):
        homos[i][0, 2] = 200.0 * (i - BLEND_VIEWS // 2)
    whs = np.repeat([[float(BLEND_W), float(BLEND_H)]], BLEND_VIEWS, 0)
    return plan_render(homos, whs, BLEND_VIEWS // 2, "flat", 16000)


def measure(mesh, imgs: np.ndarray) -> dict:
    """On every rank: this rank's bytes per stage (module docstring)."""
    import torch

    from ..parallel import mesh as pmesh
    from ..parallel.dist_ba import ba_optimize_pairs_sharded
    from ..stitch.render import blend_linear_sharded
    from ..stitch.stitcher import build_pairwise_graph
    from ..stitch.stitcherbase import compute_features_sharded, \
        feature_shards
    from ..utils import prng

    dev = pmesh.mesh_device(mesh)
    cfg = config()
    n, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]

    def counted(fn):
        pmesh.reset_bytes()
        out = fn()
        return out, pmesh.bytes_by_stage(dict(pmesh.BYTES))

    feats, fb = counted(lambda: compute_features_sharded(imgs, cfg, mesh))
    L, K = feature_shards(n, mesh.size()).shape[1], cfg.MAX_KP_PER_IMAGE
    gather = L * K * ((2 + cfg.DESC_LEN) * 4 + 1)
    total = sum(sum(d.values()) for d in fb.values())
    whs = torch.tensor([[float(w), float(h)]] * n, device=dev)
    _, mb = counted(lambda: build_pairwise_graph(
        feats, whs, cfg, prng.key((0, 1), dev), ordered=False, affine=False,
        mesh=mesh))

    params, prob = _ba_problem(dev)
    ba = []
    for iters in (1, 2):
        _, b = counted(lambda: ba_optimize_pairs_sharded(
            params, prob, 0, N_CAMS, 5.0, mesh, max_iter=iters,
            patience=iters))
        ba.append(b.get("ba", {}).get("all_reduce", 0))

    plan = _blend_plan()
    bimgs = np.random.default_rng(0).uniform(
        0, 1, (BLEND_VIEWS, BLEND_H, BLEND_W, 3)).astype(np.float32)
    _, bb = counted(lambda: blend_linear_sharded(bimgs, plan, True, mesh))
    return {
        "feature": {"collective_bytes_per_device": fb,
                    "gather_bytes": gather, "compute_bytes": total - gather,
                    "images_per_rank": L, "K": K},
        "match_ransac": {
            "collective_bytes_per_device": mb,
            "replicated_operand_bytes_per_device":
                n * K * cfg.DESC_LEN * 4 + n * K},
        "dist_ba": {
            "collective_bytes_per_device_per_iteration": ba[1] - ba[0],
            "closed_form": ba_iteration_bytes(),
            "first_iteration_with_initial_cost": ba[0]},
        "blend_sharded": {"collective_bytes_per_device": bb,
                          "canvas_bytes_total": plan.out_h * plan.out_w * 12},
    }


def run(sizes, images: int = 8, size=(320, 240), device=None) -> list[dict]:
    """One dict per world size: rank 0's counts under the JAX tool's keys,
    every rank's under ``per_rank``."""
    from ..parallel.spawn import run_ranks

    dev = resolve_device(device)
    imgs = views(images, *size)
    out = []
    with tempfile.TemporaryDirectory() as store:
        for nd in sizes:
            ranks = run_ranks(measure, nd, store, args=(imgs,),
                              timeout_s=600.0, device=dev.type)
            out.append({"devices": nd,
                        "method": "parallel.mesh.BYTES around each stage",
                        **ranks[0], "per_rank": ranks,
                        "derived_two_host": None})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m openpano_torch.bench.comm_volume")
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(320, 240),
                    metavar=("W", "H"))
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.devices:
        sizes = args.devices
    else:
        import torch

        sizes = ([1, 2, 3, 4] if dev.type == "cpu"
                 else list(range(1, torch.cuda.device_count() + 1)))
    record = device_record(dev)
    for r in run(sizes, args.images, tuple(args.size), args.device):
        print(json.dumps(dict(r, **record)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
