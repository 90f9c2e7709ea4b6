"""General stitcher: ESTIMATE_CAMERA (the default), TRANS and the naive
flat mode; CYLINDER mode is ``cylstitcher.py``.

Reference: stitch/stitcher.{hh,cc} (Stitcher::build, stitcher.cc:32-63);
counterpart of ``openpano_tpu/stitch/stitcher.py`` on one device.  Pipeline:
features -> all-pairs (or ordered ring) matching + RANSAC -> camera
estimation with the incremental bundle adjustment (or homography chaining)
-> spherical (or flat) render plan -> linear (or multiband) blend.

A uint8 host stack (with no mesh and no preloaded match graph) takes the
transport, as in the JAX package: its grey and residual planes upload
through the wire codec and feed the features, and its chroma streams in a
background thread released once the features are on the host and joined at
the blend (``stitcherbase.upload_and_compute_features``).  A stack whose
x-paired f32 copy would not fit the device budget
(``OPENPANO_HBM_BUDGET_GB``, 8 by default), or any uint8 host stack when
``OPENPANO_HOST_BLEND=1``, never goes to the device whole: only its grey
planes upload, and the blend streams column bands of it
(``render.blend_linear_host_stream``,
``multiband.blend_multiband_host_stream``).  With u8 output, no multiband
and ``STREAM_BLEND`` (the default), an in-memory blend streams its finished
strips to the host (``render.blend_linear_stream_u8``, through the download
codec unless ``OPENPANO_CODED_DOWNLOAD=0``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..camera.camera import estimate_focal, estimate_focal_robust, intrinsic
from ..camera.estimator import estimate_cameras
from ..config import Config
from ..geometry.ransac import ESTIMATE_MIN_NR_MATCH, MatchInfo, \
    estimate_transform_batch
from ..match.matcher import MatchResult, match_all_pairs, match_ring_pairs, \
    pair_indices
from ..sift.descriptor import Features
from ..utils import prng
from ..utils.debug import assert_finite
from ..utils.timer import span, total_timer
from .render import blend, blend_linear_host_stream, blend_linear_sharded, \
    blend_linear_stream_u8, f32_to_u8, plan_render
from .stitcherbase import DeferredImages, HostImages, compute_features, \
    compute_features_sharded, upload_and_compute_features


class PairwiseGraph:
    """Host-side n x n match graph (reference: Stitcher::pairwise_matches,
    stitcher.hh:38; both [i][j] and the inverted [j][i] are filled,
    stitcher.cc:88-92)."""

    def __init__(self, n: int, M: int):
        self.n = n
        self.conf = np.zeros((n, n))
        self.homo = np.zeros((n, n, 3, 3))
        self.to_pos = np.zeros((n, n, M, 2))
        self.from_pos = np.zeros((n, n, M, 2))
        self.valid = np.zeros((n, n, M), bool)

    def fill_pair(self, i: int, j: int, confidence: float, homo: np.ndarray,
                  to_pos: np.ndarray, from_pos: np.ndarray, valid: np.ndarray):
        """Per-pair match data (numpy) with homo j->i."""
        if float(confidence) <= 0:
            return False
        H = np.asarray(homo, np.float64)
        Hinv = np.linalg.inv(H)
        Hinv /= Hinv[2, 2]                       # stitcher.cc:79-80
        self.conf[i, j] = self.conf[j, i] = float(confidence)
        self.homo[i, j] = H
        self.homo[j, i] = Hinv
        self.to_pos[i, j] = to_pos
        self.from_pos[i, j] = from_pos
        self.to_pos[j, i] = from_pos
        self.from_pos[j, i] = to_pos
        self.valid[i, j] = self.valid[j, i] = valid
        return True


def build_pairwise_graph(feats: Features, whs: torch.Tensor, cfg: Config,
                         key: torch.Tensor, ordered: bool,
                         affine: bool, mesh=None) -> PairwiseGraph:
    """2-NN matching over the ordered ring (or all pairs), then RANSAC over
    the pairs with enough matches to connect.

    ``mesh``: the features are every rank's (replicated); the pair axis of
    both stages is padded to a mesh multiple and sharded, each rank running
    its contiguous block and all-gathering the results.  The matching pads
    with (0, 0) self-pairs whose counts are masked to 0; the pairs kept for
    RANSAC are bucketed to a multiple of lcm(64, mesh size), the padding
    slots masked empty so that they fail, as in the JAX package."""
    n = feats.desc.shape[0]
    # Features are prefix-packed, so the keypoint axis slices down to the
    # largest count (next power of two, at least 256)
    K_cap = feats.desc.shape[1]
    max_cnt = int(feats.valid.sum(1).max())
    K_eff = 256
    while K_eff < max_cnt:
        K_eff <<= 1
    K_eff = min(K_eff, K_cap)
    feats = Features(*(a[:, :K_eff] for a in feats))
    if ordered:
        # (i, i+1) ring with the head-tail wrap pair, which may fail
        # (linear_pairwise_match, stitcher.cc:116-136)
        ii = list(range(n))
        jj = [(i + 1) % n for i in ii]
    else:
        ii, jj = pair_indices(n)

    with total_timer("match_2nn"):
        if mesh is None:
            match = match_ring_pairs if ordered else match_all_pairs
            res = match(feats.desc, feats.valid, cfg)
        else:
            res = _match_sharded(feats, ii, jj, cfg, ordered, mesh)

    # pairs below the RANSAC minimum never connect
    # (transform_estimate.cc:21,39); keys stay those of the ORIGINAL pair
    # slots, so which pairs are dropped never moves another pair's draws
    counts = res.count.cpu().numpy()
    keep = np.nonzero(counts >= ESTIMATE_MIN_NR_MATCH)[0]
    keys = prng.split(key, len(ii))
    pair_ii = [ii[k] for k in keep]
    pair_jj = [jj[k] for k in keep]
    M = cfg.MAX_MATCHES_PER_PAIR
    P = len(keep)
    graph = PairwiseGraph(n, M)
    filled = {}
    if P:
        with total_timer("ransac"):
            if mesh is None:
                kd = torch.as_tensor(keep, device=res.idx.device)
                infos = estimate_transform_batch(
                    MatchResult(*(f[kd] for f in res)), feats.pos,
                    feats.valid, whs, pair_ii, pair_jj, key, cfg, affine,
                    keys=keys[kd])
            else:
                infos = _ransac_sharded(res, keep, keys, feats, whs, ii, jj,
                                        cfg, affine, mesh)
        with span("match.graph"):
            homo = infos.homo.cpu().numpy()
            conf = infos.confidence.cpu().numpy()
            to_pos = infos.to_pos.cpu().numpy().astype(np.float64)
            from_pos = infos.from_pos.cpu().numpy().astype(np.float64)
            pvalid = infos.valid.cpu().numpy()
            for p, (i, j) in enumerate(zip(pair_ii, pair_jj)):
                filled[(i, j)] = graph.fill_pair(
                    i, j, conf[p], homo[p], to_pos[p], from_pos[p],
                    pvalid[p])
    if ordered:
        # an unmatched adjacent pair is fatal except the head-tail wrap
        # (stitcher.cc:127); pairs dropped above count as unmatched
        for i, j in zip(ii, jj):
            if i != n - 1 and not filled.get((i, j), False):
                raise RuntimeError(f"Image {i} and {j} don't match")
    return graph


def _match_sharded(feats: Features, ii, jj, cfg: Config, ordered: bool,
                   mesh) -> MatchResult:
    """2-NN matching of this rank's block of the pair list padded with (0, 0)
    self-pairs, in the single-device chunks; the blocks all-gathered, the
    padding's counts masked to 0."""
    from ..match.matcher import _chunk_for, _match_index_pairs
    from ..parallel.mesh import all_gather, shard_on

    P = len(ii)
    blk = shard_on(mesh, P)
    pi = [ii[p] if p < P else 0 for p in blk]
    pj = [jj[p] if p < P else 0 for p in blk]
    chunk = _chunk_for(feats.desc.shape[1]) if ordered else 32
    res = _match_index_pairs(feats.desc, feats.valid, pi, pj, cfg, chunk)
    res = MatchResult(*(all_gather(mesh, f, "match") for f in res))
    return _emptied(res, torch.arange(res.count.shape[0]) < P)


def _emptied(res: MatchResult, live: torch.Tensor) -> MatchResult:
    """``res`` with the pairs where ``live`` is False emptied (no valid
    match, count 0): padding that never connects."""
    live = live.to(res.count.device)
    return MatchResult(idx=res.idx, valid=res.valid & live[:, None],
                       count=torch.where(live, res.count, 0))


def _ransac_sharded(res: MatchResult, keep: np.ndarray, keys: torch.Tensor,
                    feats: Features, whs: torch.Tensor, ii, jj, cfg: Config,
                    affine: bool, mesh) -> MatchInfo:
    """RANSAC over the kept pairs, bucketed to a multiple of lcm(64, mesh
    size) (padding slots masked empty, so that they fail) and sharded like
    the matching; each pair draws from its original slot's key, so the
    draws do not move with the rank count.  Returns the kept pairs'
    MatchInfo on every rank."""
    from ..parallel.mesh import all_gather, shard_on

    nd = mesh.size()
    mult = 64 * nd // np.gcd(64, nd)
    keep_p = np.concatenate([keep, np.zeros(-len(keep) % mult, np.int64)])
    blk = shard_on(mesh, len(keep_p))
    mine = keep_p[blk.start : blk.stop]
    kd = torch.as_tensor(mine, device=res.idx.device)
    sub = _emptied(MatchResult(*(f[kd] for f in res)),
                   torch.as_tensor(np.arange(blk.start, blk.stop) < len(keep)))
    infos = estimate_transform_batch(
        sub, feats.pos, feats.valid, whs, [ii[k] for k in mine],
        [jj[k] for k in mine], None, cfg, affine, keys=keys[kd])
    return MatchInfo(*(all_gather(mesh, f, "ransac")[: len(keep)]
                       for f in infos))


def _build_linear_simple(graph: PairwiseGraph, n: int, mid: int,
                         whs: np.ndarray, cfg: Config) -> np.ndarray:
    """Chain pairwise homographies outward from the middle image and
    prescale by diag(1/f, 1/f, 1) (stitcher.cc:156-195).  The naive mode
    (not TRANS) takes f from the focal estimate; TRANS, or a failed
    estimate, takes (w + h) / 2 of the middle image."""
    homos = np.zeros((n, 3, 3))
    homos[mid] = np.eye(3)
    for k in range(mid + 1, n):
        if graph.conf[k - 1, k] <= 0:
            raise RuntimeError(f"Image {k-1} and {k} don't match")
        homos[k] = homos[k - 1] @ graph.homo[k - 1, k]
    for k in range(mid - 1, -1, -1):
        if graph.conf[k + 1, k] <= 0:
            raise RuntimeError(f"Image {k} and {k+1} don't match")
        homos[k] = homos[k + 1] @ graph.homo[k + 1, k]
    f = -1.0
    if not cfg.TRANS:                             # stitcher.cc:180-181
        f = (estimate_focal_robust if cfg.ROBUST_FOCAL else estimate_focal)(
            graph.conf, graph.homo)
    if f <= 0:
        f = 0.5 * (whs[mid, 0] + whs[mid, 1])     # stitcher.cc:182-184
    M = np.diag([1.0 / f, 1.0 / f, 1.0])
    return M[None] @ homos


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: openpano_torch runs on the card by default; "
                "pass device='cpu' to run its plain versions on the CPU")
        device = "cuda"
    return torch.device(device)


def prologue(cfg: Config, output: str, key, device, mesh=None):
    """Validate the call; the device and the key (PRNGKey(0) by default) on
    it.  With a mesh the device is the rank's, and a ``device`` that names
    another raises."""
    cfg.validate()
    if output not in ("f32", "u8"):
        raise ValueError(f"output must be 'f32' or 'u8', not {output!r}")
    if mesh is None:
        dev = resolve_device(device)
    else:
        from ..parallel.mesh import mesh_device

        dev = mesh_device(mesh)
        named = None if device is None else torch.device(device)
        if named is not None and (named.type != dev.type or (
                named.index is not None and named.index != dev.index)):
            raise ValueError(f"device {named} conflicts with the mesh's "
                             f"{dev}")
    return dev, prng.key((0, 0), dev) if key is None else key.to(dev)


def paired_gb(shape) -> float:
    """GB of the x-paired f32 blend stack of an [N, H, W, 3] set (36 B a
    pixel: 4-byte floats, 3 channels, paired, plus the f32 copy)."""
    return shape[0] * shape[1] * shape[2] * 36 / 1e9


def _budget_gb() -> float:
    return float(os.environ.get("OPENPANO_HBM_BUDGET_GB", "8"))


def stays_on_host(shape) -> bool:
    """Whether a uint8 host stack of this shape takes the host-stream path:
    its paired stack exceeds ``OPENPANO_HBM_BUDGET_GB``, or
    ``OPENPANO_HOST_BLEND=1`` forces it."""
    return (paired_gb(shape) > _budget_gb()
            or os.environ.get("OPENPANO_HOST_BLEND", "") == "1")


def host_stream_groups(shape) -> int:
    """Column bands of the host-stream blend: one per quarter budget of the
    paired stack, at least 2."""
    return max(2, int(np.ceil(paired_gb(shape) / max(_budget_gb() * 0.25,
                                                     0.1))))


def sharded_blend_on_host(shape) -> bool:
    """Whether the sharded blend of a uint8 host stack reads it from host
    memory, each rank uploading only its band's images: its paired stack
    exceeds ``OPENPANO_HBM_BUDGET_GB``, or
    ``OPENPANO_SHARDED_BLEND_HOST=1`` forces it."""
    return (paired_gb(shape) > _budget_gb()
            or os.environ.get("OPENPANO_SHARDED_BLEND_HOST", "") == "1")


def stitch(imgs, cfg: Config, key=None, output: str = "f32", device=None,
           info_out: dict | None = None, graph: PairwiseGraph | None = None,
           mesh=None):
    """Stitcher::build (stitcher.cc:32-63).

    imgs: [n, H, W, 3] uint8 or float32 in [0, 1] (numpy or torch).
    key: threefry key ``[2]`` (``utils.prng.key``); None means (0, 0),
    like ``PRNGKey(0)``.  output="f32" returns the blended canvas (float32
    numpy, INVALID=-1 where empty, pre-crop); output="u8" returns
    ``(canvas_u8, valid)``.  ``info_out`` collects per-image keypoint
    counts, the match graph, ``connected_pairs``, ``total_inliers``, the
    cameras (``cams``) and the bundle adjustment's statistics in
    ESTIMATE_CAMERA mode, the homographies and the render plan.

    graph: a preloaded match graph (``io.artifacts.load_matchinfo_text``):
    the feature and match stages are skipped (the reference's
    load_matchinfo fixture, debug.cc:127-140), and ``info_out`` gets no
    keypoint counts.  Otherwise a uint8 host stack (numpy or a CPU tensor)
    takes the transport, and one past the device budget stays in host
    memory (module docstring).

    mesh: a ``parallel.make_mesh`` mesh of ``torch.distributed`` ranks.
    Every rank calls with the same arguments and returns the whole result;
    each stage shards over the ranks (``parallel/pipeline.py``), on the
    rank's device (``device``, if given, must name it).  A uint8 host stack
    past the budget, or any under ``OPENPANO_SHARDED_BLEND_HOST=1``, stays
    in host memory: each rank uploads its feature images and then its
    blend band's images only."""
    dev, key = prologue(cfg, output, key, device, mesh)
    if not torch.is_tensor(imgs) or imgs.device.type == "cpu":
        imgs = np.asarray(imgs)                   # host memory, no copy
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    whs_np = np.repeat([[float(W), float(H)]], n, 0)
    host_u8 = isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8
    if mesh is None:
        on_host = graph is None and host_u8 and stays_on_host(imgs.shape)
    else:
        on_host = host_u8 and sharded_blend_on_host(imgs.shape)
    feats = None
    if mesh is None and graph is None and host_u8:
        with total_timer("calc_feature"):
            imgs, feats = upload_and_compute_features(
                imgs, cfg, rgb_stream=not on_host, device=dev)
        imgs.start_background()  # the chroma streams under match and BA
        assert_finite("calc_feature", pos=feats.pos, desc=feats.desc)
        return _stitch_core(imgs, feats, whs_np, cfg, key, output, info_out)
    if not on_host:
        with total_timer("upload"):
            imgs = torch.as_tensor(imgs).to(dev)
    if graph is None:
        with total_timer("calc_feature"):
            feats = (compute_features(imgs, cfg, dev) if mesh is None
                     else compute_features_sharded(imgs, cfg, mesh))
        assert_finite("calc_feature", pos=feats.pos, desc=feats.desc)
    if on_host:
        imgs = HostImages(imgs, dev)
    return _stitch_core(imgs, feats, whs_np, cfg, key, output, info_out,
                        graph, mesh)


def stitch_hetero(imgs_list, cfg: Config, key=None, output: str = "f32",
                  device=None, info_out: dict | None = None, mesh=None):
    """Stitch images of MIXED sizes (reference: per-image shapes throughout,
    stitch/imageref.hh:13-35 and stitcherbase.cc:9-27).

    The images are bucketed by (H, W) for the feature stage, one feature
    call per bucket (each bucket gets its own working-size resize, as the
    reference resizes per image at feature.cc:33-36); every image passes as
    float32, as in the JAX package.  The blend stack pads each image to the
    largest shape with the INVALID sentinel, which sampling carries through
    (Color::NO).  imgs_list: [Hi, Wi, 3] uint8 or float32 arrays.  Returns
    like :func:`stitch`; with ``mesh``, as the JAX package does, every
    stage after the bucketed features shards over the ranks."""
    dev, key = prologue(cfg, output, key, device, mesh)
    n = len(imgs_list)
    imgs_list = [np.asarray(im) for im in imgs_list]
    whs_np = np.asarray(
        [[float(im.shape[1]), float(im.shape[0])] for im in imgs_list])

    def to_f32(im):
        return (im.astype(np.float32) / 255.0 if im.dtype == np.uint8
                else im.astype(np.float32))

    buckets: dict[tuple, list[int]] = {}
    for i, im in enumerate(imgs_list):
        buckets.setdefault(im.shape[:2], []).append(i)
    order, parts = [], []
    with total_timer("calc_feature"):
        for idxs in buckets.values():
            stack = torch.from_numpy(np.stack([to_f32(imgs_list[i])
                                               for i in idxs])).to(dev)
            parts.append(compute_features(stack, cfg))
            order.extend(idxs)
        inv = torch.as_tensor(np.argsort(order), device=dev)
        feats = Features(*(torch.cat(f, dim=0)[inv] for f in zip(*parts)))

    with total_timer("upload"):
        Hm = max(im.shape[0] for im in imgs_list)
        Wm = max(im.shape[1] for im in imgs_list)
        stack = np.full((n, Hm, Wm, 3), -1.0, np.float32)
        for i, im in enumerate(imgs_list):
            stack[i, : im.shape[0], : im.shape[1]] = to_f32(im)
        src = torch.from_numpy(stack).to(dev)
    return _stitch_core(src, feats, whs_np, cfg, key, output, info_out,
                        mesh=mesh)


def _stitch_core(imgs, feats: Features | None, whs_np: np.ndarray,
                 cfg: Config, key: torch.Tensor, output: str,
                 info_out: dict | None, graph: PairwiseGraph | None = None,
                 mesh=None):
    """Shared tail of Stitcher::build after the features: match graph ->
    cameras (or homography chain) -> render plan -> blend
    (stitcher.cc:38-63).  imgs: [n, H, W, 3] blend stack on the card (or
    the CPU), uint8 or float32 in [0, 1] with INVALID beyond each image's
    ``whs`` extent, which becomes float32 in the blend stage; or
    ``HostImages``, whose blend streams from host memory (with a mesh:
    each rank uploads its band's images).  ``graph``, when given, replaces
    the match stage (and ``feats`` is None).  ``mesh`` shards matching,
    RANSAC, the bundle adjustment and the blend over the ranks."""
    n = whs_np.shape[0]
    mid = n >> 1                                  # assign_center, :138-141
    dev = imgs.device
    whs = torch.as_tensor(whs_np, dtype=torch.float32, device=dev)
    if info_out is not None and feats is not None:
        info_out["kpt_counts"] = feats.valid.sum(1).cpu().numpy()
    if graph is None:
        with total_timer("pairwise_match"):
            graph = build_pairwise_graph(feats, whs, cfg, key,
                                         ordered=cfg.ORDERED_INPUT,
                                         affine=cfg.TRANS, mesh=mesh)
        assert_finite("pairwise_match", conf=graph.conf, homo=graph.homo,
                      to_pos=graph.to_pos, from_pos=graph.from_pos)
    if info_out is not None:
        conn = graph.conf > 0
        info_out.update(
            graph=graph, connected_pairs=int(np.triu(conn, 1).sum()),
            total_inliers=int((graph.valid & conn[:, :, None]).sum() // 2))

    if cfg.ESTIMATE_CAMERA:
        with total_timer("estimate_camera"):
            cams = estimate_cameras(
                graph.conf, graph.homo, graph.to_pos, graph.from_pos,
                graph.valid, whs_np, cfg, stats=info_out, device=dev,
                mesh=mesh)
        assert_finite("estimate_camera", focal=cams.focal, R=cams.R)
        homos = np.zeros((n, 3, 3))
        for i in range(n):                        # stitcher.cc:143-154
            K = intrinsic(cams.focal[i], cams.ppx[i], cams.ppy[i])
            homos[i] = cams.R[i].T @ np.linalg.inv(K)
        proj = "spherical"
        if info_out is not None:
            info_out["cams"] = cams
    else:
        homos = _build_linear_simple(graph, n, mid, whs_np, cfg)
        proj = "flat"

    with total_timer("blend"):
        if isinstance(imgs, DeferredImages):
            with span("blend.join"):
                imgs = imgs.get()      # join the background chroma stream
        with span("blend.plan"):
            plan = plan_render(homos, whs_np, mid, proj, cfg.MAX_OUTPUT_SIZE)
        if mesh is not None:
            src = imgs.host if isinstance(imgs, HostImages) else imgs
            result = to_output(blend_sharded(src, plan, cfg, mesh), output)
        elif isinstance(imgs, HostImages):
            with span("blend.render"):
                result = _blend_host_stream(imgs, plan, cfg, output)
        else:
            src = imgs.to(torch.float32)
            if imgs.dtype == torch.uint8:
                src = src / 255.0
            if output == "u8" and cfg.MULTIBAND == 0 and cfg.STREAM_BLEND:
                # its strips download while later bands render
                # (``blend.download`` inside ``blend.render``)
                with span("blend.render"):
                    rgba = blend_linear_stream_u8(src, plan,
                                                  cfg.ORDERED_INPUT)
                result = (rgba[..., :3], rgba[..., 3] > 0)
            else:
                with span("blend.render"):
                    canvas = blend(src, plan, ordered=cfg.ORDERED_INPUT,
                                   multiband=cfg.MULTIBAND)
                with span("blend.download"):
                    result = to_output(canvas, output)
    if info_out is not None:
        info_out.update(homos=homos, plan=plan)
    return result


def blend_sharded(imgs, plan, cfg: Config, mesh) -> torch.Tensor:
    """The blend stage over the ranks' column bands: multiband when
    ``cfg.MULTIBAND`` > 0, else linear.  ``imgs``: a host numpy stack (each
    rank uploads its band's images) or a stack on the rank's device."""
    if cfg.MULTIBAND > 0:
        from .multiband import blend_multiband_sharded

        return blend_multiband_sharded(imgs, plan, cfg.MULTIBAND, mesh)
    return blend_linear_sharded(imgs, plan, cfg.ORDERED_INPUT, mesh)


def _blend_host_stream(imgs: HostImages, plan, cfg: Config, output: str):
    """The blend stage of a stack kept in host memory, in
    ``host_stream_groups`` column bands: multiband through its band stream,
    linear through the u8 strips when the output is u8, else through the
    f32 strips."""
    groups = host_stream_groups(imgs.host.shape)
    if cfg.MULTIBAND > 0:
        from .multiband import blend_multiband_host_stream

        canvas = blend_multiband_host_stream(imgs.host, plan, cfg.MULTIBAND,
                                             groups, device=imgs.device)
    elif output == "u8":
        rgba = blend_linear_host_stream(imgs.host, plan, cfg.ORDERED_INPUT,
                                        groups, u8_out=True,
                                        device=imgs.device)
        return rgba[..., :3], rgba[..., 3] > 0
    else:
        canvas = blend_linear_host_stream(imgs.host, plan, cfg.ORDERED_INPUT,
                                          groups, device=imgs.device)
    return to_output(torch.from_numpy(canvas), output)


def to_output(canvas: torch.Tensor, output: str):
    """The f32 canvas as host numpy, or ``(canvas_u8, valid)`` for "u8"."""
    if output == "u8":
        u8, valid = f32_to_u8(canvas)
        return u8.cpu().numpy(), valid.cpu().numpy()
    return canvas.cpu().numpy()
