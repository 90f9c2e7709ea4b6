"""What each gloo rank of ``tests/test_torch_parallel*.py`` runs.

The ranks are spawned processes (``openpano_torch.parallel.spawn``) that
import this module to find their function, so it imports neither JAX nor
the JAX package; the test files, which do, hold the JAX references.  Each
function takes the rank's mesh first and returns numpy results; every
rank returns its own, so that the tests can hold the ranks to each other.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from openpano_torch import Config, stitch_images
from openpano_torch.parallel import mesh as pmesh
from openpano_torch.parallel import stitch_sharded
from openpano_torch.stitch import render, stitcher
from openpano_torch.stitch.cylstitcher import stitch_cylinder
from openpano_torch.stitch.multiband import blend_multiband_sharded
from openpano_torch.utils import prng


def _cams(info) -> dict:
    return dict(focal=info["cams"].focal, R=info["cams"].R,
                lm_iters=info["lm_iters"])


def stitch_suite(mesh, views, cfg_fields: dict, graph, hetero, cyl_views,
                 cyl_fields: dict, lm_cases) -> dict:
    """The sharded stitch of ``views`` (keypoints, match graph, cameras,
    canvas) through ``stitch_images`` (through ``stitch_sharded`` at 2
    ranks), with ``graph`` given (cameras and canvas), ``stitch_hetero``
    over the list ``hetero``, ``stitch_cylinder`` over ``cyl_views`` and
    ``stitch_images`` in CYLINDER mode at 1 rank (the mesh dropped: no
    collective runs), the sharded LM on each of ``lm_cases`` ((arrays, params,
    identity, n, kwargs) each) and on the first with a NaN in rank 0's
    pairs under the numeric checks, a ``device`` that is not the mesh's,
    and the mesh bootstrap's own checks.  ``graph`` / ``hetero`` /
    ``cyl_views`` None skip their runs."""
    import torch.distributed as dist

    from openpano_torch.parallel.dist_ba import ba_optimize_pairs_sharded
    from openpano_torch.camera.bundle_adjuster import BAPairProblem
    from openpano_torch.utils.debug import NumericsError

    out = {"jax_loaded": any(m.split(".")[0] in ("jax", "openpano_tpu")
                             for m in sys.modules)}
    cfg = Config(**cfg_fields)
    key = prng.key((0, 0), "cpu")

    feats = {}
    real = stitcher.compute_features_sharded

    def record(*args):
        feats["f"] = real(*args)
        return feats["f"]

    stitcher.compute_features_sharded = record
    try:
        info = {}
        if mesh.size() == 2:
            canvas = stitch_sharded(views, cfg, mesh, key=key, info_out=info)
        else:
            canvas = stitch_images(views, cfg, key=key, info_out=info,
                                   mesh=mesh)
    finally:
        stitcher.compute_features_sharded = real
    out["stitch"] = dict(canvas=canvas, conf=info["graph"].conf,
                         pos=feats["f"].pos.numpy(),
                         valid=feats["f"].valid.numpy(), **_cams(info))

    if graph is not None:
        info = {}
        canvas = stitcher.stitch(views, cfg, key=key, graph=graph,
                                 mesh=mesh, info_out=info)
        out["graph"] = dict(canvas=canvas, **_cams(info))

    if hetero is not None:
        info = {}
        canvas = stitcher.stitch_hetero(hetero, cfg, key=key, mesh=mesh,
                                        info_out=info)
        out["hetero"] = dict(canvas=canvas, conf=info["graph"].conf,
                             **_cams(info))

    try:
        stitcher.stitch(views, cfg, key=key, device="cuda", mesh=mesh)
        out["other_device"] = "ran"
    except ValueError as e:
        out["other_device"] = str(e)

    if cyl_views is not None:
        ccfg = Config(**cyl_fields)
        info = {}
        out["cylinder"] = dict(
            canvas=stitch_cylinder(cyl_views, ccfg, key=key, mesh=mesh,
                                   info_out=info),
            hfactor=info["hfactor"])
        if mesh.size() == 1:
            pmesh.reset_bytes()
            out["cylinder_images"] = stitch_images(cyl_views, ccfg, key=key,
                                                   device="cpu", mesh=mesh)
            out["cylinder_images_bytes"] = dict(pmesh.BYTES)

    out["lm"] = []
    for arrays, params, identity, n, kw in lm_cases:
        prob = BAPairProblem(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()})
        p, iters = ba_optimize_pairs_sharded(
            torch.from_numpy(params), prob, identity, n, 5.0, mesh, **kw)
        out["lm"].append((p.numpy(), iters))

    # slot 0 lies in rank 0's block: the other ranks' residuals are finite
    arrays, params, identity, n, kw = lm_cases[0]
    pt_to = arrays["pt_to"].copy()
    pt_to[0, 0, 0] = np.nan
    prob = BAPairProblem(**{k: torch.from_numpy(v) for k, v in
                            dict(arrays, pt_to=pt_to).items()})
    os.environ["OPENPANO_CHECK_NUMERICS"] = "1"
    t0 = time.perf_counter()
    try:
        ba_optimize_pairs_sharded(torch.from_numpy(params), prob, identity,
                                  n, 5.0, mesh, **kw)
        raised = None
    except NumericsError as e:
        raised = str(e)
    finally:
        del os.environ["OPENPANO_CHECK_NUMERICS"]
    out["lm_nan"] = (raised, time.perf_counter() - t0)

    pmesh.init_distributed(device="cpu")          # up already: a no-op
    again = pmesh.make_mesh()
    try:
        pmesh.make_mesh(mesh.size() + 1)
        refused = False
    except ValueError:
        refused = True
    out["bootstrap"] = dict(
        backend=dist.get_backend(), world=dist.get_world_size(),
        same_mesh=again == mesh and again.mesh_dim_names == ("d",),
        device=str(pmesh.mesh_device(mesh)), refuses_other_size=refused)
    return out


def blend_suite(mesh, lin_views, lin_plan, strip, strip_plan, mb_u8,
                mb_plan) -> dict:
    """The sharded linear blend of ``lin_views`` (f32, on the device and
    from the host as u8), the host path on ``strip``, and the sharded
    multiband of ``mb_u8`` (on the device as f32, and from the host), with
    every band upload recorded by its image count."""
    out = {"jax_loaded": any(m.split(".")[0] in ("jax", "openpano_tpu")
                             for m in sys.modules)}
    uploads = []
    real = render.band_slice

    def record(imgs, ids, *a):
        uploads.append(len(ids))
        return real(imgs, ids, *a)

    def run(label, fn):
        uploads.clear()
        out[label] = fn().numpy()
        out[label + "_uploads"] = list(uploads)

    render.band_slice = record
    try:
        lin_u8 = np.round(lin_views * 255.0).astype(np.uint8)
        run("linear", lambda: render.blend_linear_sharded(
            torch.from_numpy(lin_views), lin_plan, False, mesh))
        run("linear_host", lambda: render.blend_linear_sharded(
            lin_u8, lin_plan, False, mesh))
        run("linear_u8", lambda: render.blend_linear_sharded(
            torch.from_numpy(lin_u8), lin_plan, False, mesh))
        run("strip_host", lambda: render.blend_linear_sharded(
            strip, strip_plan, True, mesh))
        mb_f32 = torch.from_numpy(mb_u8.astype(np.float32) / 255.0)
        run("multiband", lambda: blend_multiband_sharded(
            mb_f32, mb_plan, 2, mesh))
        run("multiband_host", lambda: blend_multiband_sharded(
            mb_u8, mb_plan, 2, mesh))
    finally:
        render.band_slice = real
    return out
