"""CYLINDER-mode stitcher.

Reference: stitch/cylstitcher.{hh,cc}; counterpart of the single-device
``stitch_cylinder`` of ``openpano_tpu/stitch/cylstitcher.py``.  Pipeline
(cylstitcher.cc:20-28): features -> adjacent-pair matching -> h-factor
straightening search -> cylindrical pre-warp of all images -> chain
pairwise affine transforms from the middle image -> flat-projection blend
(linear or multiband) -> perspective correction.

Homography chaining, the slope metric and the <= 4-step h-factor search
(cylstitcher.cc:46-62, 89-137) are small f64 host math; features, matching,
the per-pair RANSAC of each trial (all pairs of a trial in one batch), the
keypoint and image warps and the blend run on the device.  The RANSAC keys
are the JAX package's: ``split(key, 8)``, trial k draws from key ``k`` (the
first) or ``1 + k``, the left half of the chain from key 4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..geometry.dlt import perspective_dlt
from ..geometry.ransac import MatchInfo, estimate_transform_batch
from ..match.matcher import MatchResult, match_adjacent_pairs
from ..ops.imgproc import INVALID, sample_bilinear
from ..utils import prng
from ..utils.timer import total_timer
from .render import RenderPlan, blend, plan_render
from .stitcher import blend_sharded, prologue, to_output
from .stitcherbase import DeferredImages, compute_features, \
    compute_features_sharded, upload_and_compute_features
from .warp import make_projector, warp_images, warp_keypoints


def _slice_pairs(m: MatchResult, lo: int, hi: int) -> MatchResult:
    return MatchResult(*(a[lo:hi] for a in m))


def _reverse_matches(m: MatchResult) -> MatchResult:
    return MatchResult(idx=m.idx.flip(-1), valid=m.valid, count=m.count)


def _estimate_chain(matches: MatchResult, pos, valid, whs: np.ndarray, ii,
                    jj, key, cfg: Config) -> MatchInfo:
    whs = torch.as_tensor(whs, dtype=torch.float32, device=pos.device)
    return estimate_transform_batch(matches, pos, valid, whs, ii, jj, key,
                                    cfg, affine=True)


def stitch_cylinder(imgs, cfg: Config, key=None, output: str = "f32",
                    device=None, info_out: dict | None = None, mesh=None):
    """CylinderStitcher::build (cylstitcher.cc:20-28).

    imgs: [n, H, W, 3] uint8 or float32 in [0, 1] (numpy or torch), of one
    shape; a uint8 host stack without a mesh takes the transport
    (``stitcherbase.upload_and_compute_features``).  key, output and device as for ``stitcher.stitch``.  Returns the
    corrected canvas (float32 numpy, INVALID=-1 where empty, pre-crop), or
    ``(canvas_u8, valid)`` with output="u8".  ``info_out`` collects the
    keypoint counts, the chosen ``hfactor`` with its ``slope`` and the
    ``trials`` of the search, the homographies and the render plan.

    mesh: as for ``stitcher.stitch``: the features shard over the ranks'
    images, each rank warps its block of the images and the warped images
    are all-gathered, and the flat-projection blend runs over the ranks'
    column bands before the perspective correction.  The h-factor search
    and the homography chain are small host math, run on every rank."""
    dev, key = prologue(cfg, output, key, device, mesh)
    if not torch.is_tensor(imgs) or imgs.device.type == "cpu":
        imgs = np.asarray(imgs)                   # host memory, no copy
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    mid = n >> 1
    if mesh is None and isinstance(imgs, np.ndarray) \
            and imgs.dtype == np.uint8:
        # the transport: the chroma streams under the h-factor search and
        # joins before the warp
        with total_timer("calc_feature"):
            imgs, feats = upload_and_compute_features(imgs, cfg, device=dev)
        imgs.start_background()
    else:
        with total_timer("upload"):
            imgs = torch.as_tensor(imgs).to(dev)
        with total_timer("calc_feature"):
            feats = (compute_features(imgs, cfg) if mesh is None
                     else compute_features_sharded(imgs, cfg, mesh))
    kpos, kvalid = feats.pos, feats.valid    # half-shifted, unwarped
    with total_timer("match_2nn"):
        matches = match_adjacent_pairs(feats.desc, feats.valid, cfg)

    # ---- h-factor straightening search (cylstitcher.cc:31-62) ----
    state = {"minslope": np.inf, "bestfactor": 1.0, "bestmat": None,
             "slope": 0.0, "trials": 0}

    def update_h_factor(factor: float, trial_key) -> float:
        """cylstitcher.cc:89-137: the drift slope of this factor's chain,
        keeping the chain if |slope| improved; 0.0 signals failure."""
        state["trials"] += 1
        projf = make_projector(W, H, factor, cfg)
        wkpos = warp_keypoints(projf, kpos, W, H)
        wwh = np.repeat([[projf.out_w, projf.out_h]], n, 0)
        ii = np.arange(mid, n - 1)          # pairs (k-1, k), k in [mid+1, n)
        infos = _estimate_chain(_slice_pairs(matches, mid, n - 1), wkpos,
                                kvalid, wwh, ii, ii + 1, trial_key, cfg)
        if bool((infos.confidence <= 0).any()):
            return 0.0
        chain = []
        acc = np.eye(3)
        for hm in infos.homo.cpu().numpy().astype(np.float64):
            acc = acc @ hm                  # k -> mid frame
            chain.append(acc.copy())
        c2 = chain[-1] @ np.array([0.0, 0.0, 1.0])
        c2 = c2[:2] / c2[2]
        slope = c2[1] / c2[0]
        if abs(slope) < state["minslope"]:
            state.update(minslope=abs(slope), bestfactor=factor,
                         bestmat=chain, slope=float(slope))
        return float(slope)

    keys = prng.split(key, 8)
    with total_timer("hfactor_search"):
        if n - mid > 1:
            newfactor = 1.0
            slope = update_h_factor(newfactor, keys[0])
            if state["bestmat"] is None:
                raise RuntimeError("Failed to find hfactor")
            centerx2 = state["bestmat"][0] @ np.array([0.0, 0.0, 1.0])
            order = 1.0 if (centerx2[0] / centerx2[2]) > 0 else -1.0
            for k in range(3):
                if abs(slope) < cfg.SLOPE_PLAIN:
                    break
                newfactor += (order if slope < 0 else -order) / (5 * 2 ** k)
                slope = update_h_factor(newfactor, keys[1 + k])

    proj = make_projector(W, H, state["bestfactor"], cfg)
    wW, wH = proj.out_w, proj.out_h
    wwh = np.repeat([[wW, wH]], n, 0).astype(np.float32)

    # ---- warp every image and keypoint (cylstitcher.cc:64-67) ----
    with total_timer("warp"):
        if isinstance(imgs, DeferredImages):
            imgs = imgs.get()
        if mesh is None:
            warped = warp_images(proj, imgs, wH, wW, W, H)
        else:
            warped = _warp_sharded(proj, imgs, wH, wW, W, H, mesh)
        wkpos = warp_keypoints(proj, kpos, W, H)

    # ---- accumulate homographies (cylstitcher.cc:69-86) ----
    with total_timer("chain"):
        homos = [np.eye(3) for _ in range(n)]
        for k in range(mid + 1, n):
            homos[k] = state["bestmat"][k - mid - 1]
        if mid > 0:
            # (i+1 <- i) for i in [0, mid), on reversed matches
            ii = np.arange(1, mid + 1)      # kp1 side: image i+1
            infos = _estimate_chain(
                _reverse_matches(_slice_pairs(matches, 0, mid)), wkpos,
                kvalid, wwh, ii, ii - 1, keys[4], cfg)
            conf = infos.confidence.cpu().numpy()
            for i in range(mid):
                if conf[i] <= 0:
                    raise RuntimeError(
                        f"Failed to match between image {i} and {i + 1}.")
            step = infos.homo.cpu().numpy().astype(np.float64)  # i -> i+1
            for i in range(mid - 1, -1, -1):
                homos[i] = homos[i + 1] @ step[i]
        homos = np.stack(homos)

    # ---- flat-projection blend (cylstitcher.cc:24-27) + correction ----
    with total_timer("blend"):
        plan = plan_render(homos, wwh.astype(np.float64), mid, "flat",
                           cfg.MAX_OUTPUT_SIZE)
        if mesh is None:
            canvas = blend(warped, plan, ordered=True,
                           multiband=cfg.MULTIBAND)
        else:
            canvas = blend_sharded(warped, plan,
                                   cfg.replace(ORDERED_INPUT=True), mesh)
        del warped
        canvas = perspective_correction(canvas, plan, homos, wwh, mid)
        result = to_output(canvas, output)
    if info_out is not None:
        info_out.update(
            kpt_counts=feats.valid.sum(1).cpu().numpy(),
            hfactor=state["bestfactor"], slope=state["slope"],
            trials=state["trials"], homos=homos, plan=plan)
    return result


def _warp_sharded(proj, imgs: torch.Tensor, wH: int, wW: int, W: int, H: int,
                  mesh) -> torch.Tensor:
    """The cylindrical warp of this rank's contiguous block of the images
    (the image axis padded to a mesh multiple with copies of image 0),
    all-gathered into the [n, wH, wW, 3] stack on every rank."""
    from ..parallel.mesh import all_gather, shard_on

    n = imgs.shape[0]
    blk = shard_on(mesh, n)
    ids = torch.as_tensor([i if i < n else 0 for i in blk],
                          device=imgs.device)
    mine = warp_images(proj, imgs[ids], wH, wW, W, H)
    return all_gather(mesh, mine, "warp")[:n]


def perspective_correction(canvas: torch.Tensor, plan: RenderPlan,
                           homos: np.ndarray, whs: np.ndarray,
                           mid: int) -> torch.Tensor:
    """Stretch the panorama's four projected end-corners back to a rectangle
    (cylstitcher.cc:139-180): corners of the first / last image are mapped
    into canvas pixels, a 4-point DLT maps the output rectangle onto them,
    and the canvas is resampled once more.  As in the JAX package, the
    corners are divided by the render resolution, so the correction holds
    when MAX_OUTPUT_SIZE downscaled the canvas."""
    h, w = canvas.shape[0], canvas.shape[1]

    def to_canvas(img_idx, corner):
        v = np.array([corner[0] * whs[img_idx, 0], corner[1] * whs[img_idx, 1],
                      1.0])
        p = homos[img_idx] @ v
        p = p[:2] / p[2]
        return (p - plan.proj_min) / plan.resolution

    last = len(homos) - 1
    corners = np.stack([to_canvas(0, (-0.5, -0.5)), to_canvas(0, (-0.5, 0.5)),
                        to_canvas(last, (0.5, -0.5)), to_canvas(last, (0.5, 0.5))])
    corners_std = np.array([[0, 0], [0, h], [w, 0], [w, h]], np.float64)
    # output-rect px -> canvas px: the raw DLT, unnormalized
    # (cylstitcher.cc:166), in f64 on the host
    Hc = perspective_dlt(torch.from_numpy(corners),
                         torch.from_numpy(corners_std),
                         torch.ones(4, dtype=torch.float64))
    Hc = Hc.to(device=canvas.device, dtype=torch.float32)

    jj = torch.arange(w, dtype=torch.float32, device=canvas.device)[None, :]
    ii = torch.arange(h, dtype=torch.float32, device=canvas.device)[:, None]
    # the 3x3 map as explicit f32 products (no tensor cores, hence no TF32)
    src = [jj * Hc[d, 0] + ii * Hc[d, 1] + Hc[d, 2] for d in range(3)]
    z = src[2]
    zsafe = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
    color, ok = sample_bilinear(canvas, src[1] / zsafe, src[0] / zsafe)
    return torch.where((ok & (z > 0))[..., None], color, INVALID)
