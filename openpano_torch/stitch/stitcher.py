"""General stitcher, TRANS mode: features -> ordered matching + RANSAC ->
homography chaining -> flat render plan -> linear blend.

Reference: stitch/stitcher.{hh,cc} (Stitcher::build, stitcher.cc:32-63);
counterpart of ``openpano_tpu/stitch/stitcher.py`` on one device.  Camera
estimation (the default ESTIMATE_CAMERA mode) and the naive flat mode need
the camera stack, which this package does not have yet: ``stitch`` refuses
those configurations, as it does CYLINDER and MULTIBAND.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..geometry.ransac import ESTIMATE_MIN_NR_MATCH, estimate_transform_batch
from ..match.matcher import MatchResult, match_all_pairs, match_ring_pairs, \
    pair_indices
from ..sift.descriptor import Features
from ..utils import prng
from ..utils.timer import total_timer
from .render import blend_linear, f32_to_u8, plan_render
from .stitcherbase import compute_features


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
                         affine: bool) -> PairwiseGraph:
    """2-NN matching over the ordered ring (or all pairs), then RANSAC over
    the pairs with enough matches to connect."""
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
        match = match_ring_pairs if ordered else match_all_pairs
        res = match(feats.desc, feats.valid, cfg)

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
        kd = torch.as_tensor(keep, device=res.idx.device)
        with total_timer("ransac"):
            infos = estimate_transform_batch(
                MatchResult(*(f[kd] for f in res)), feats.pos, feats.valid,
                whs, pair_ii, pair_jj, key, cfg, affine, keys=keys[kd])
        homo = infos.homo.cpu().numpy()
        conf = infos.confidence.cpu().numpy()
        to_pos = infos.to_pos.cpu().numpy().astype(np.float64)
        from_pos = infos.from_pos.cpu().numpy().astype(np.float64)
        pvalid = infos.valid.cpu().numpy()
        for p, (i, j) in enumerate(zip(pair_ii, pair_jj)):
            filled[(i, j)] = graph.fill_pair(
                i, j, conf[p], homo[p], to_pos[p], from_pos[p], pvalid[p])
    if ordered:
        # an unmatched adjacent pair is fatal except the head-tail wrap
        # (stitcher.cc:127); pairs dropped above count as unmatched
        for i, j in zip(ii, jj):
            if i != n - 1 and not filled.get((i, j), False):
                raise RuntimeError(f"Image {i} and {j} don't match")
    return graph


def _build_linear_simple(graph: PairwiseGraph, n: int, mid: int,
                         whs: np.ndarray) -> np.ndarray:
    """Chain pairwise homographies outward from the middle image and
    prescale by diag(1/f, 1/f, 1) with f = (w + h) / 2 of the middle image
    (stitcher.cc:156-195, TRANS mode: no focal estimate)."""
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
    f = 0.5 * (whs[mid, 0] + whs[mid, 1])        # stitcher.cc:182-184
    M = np.diag([1.0 / f, 1.0 / f, 1.0])
    return M[None] @ homos


def check_supported(cfg: Config) -> Config:
    """Refuse the configurations whose code is not ported yet, naming the
    ROADMAP item that brings it."""
    cfg.validate()
    if cfg.CYLINDER:
        raise NotImplementedError(
            "CYLINDER mode is not ported yet (ROADMAP Queue 1, item 13)")
    if cfg.ESTIMATE_CAMERA:
        raise NotImplementedError(
            "ESTIMATE_CAMERA needs the camera stack, not ported yet "
            "(ROADMAP Queue 1, item 8); use TRANS=True, ESTIMATE_CAMERA=False")
    if not cfg.TRANS:
        raise NotImplementedError(
            "the naive flat mode needs the focal estimate of the camera "
            "stack, not ported yet (ROADMAP Queue 1, item 8)")
    if cfg.MULTIBAND > 0:
        raise NotImplementedError(
            "MULTIBAND blending is not ported yet (ROADMAP Queue 1, item 12)")
    return cfg


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: openpano_torch runs on the card by default; "
                "pass device='cpu' to run its plain versions on the CPU")
        device = "cuda"
    return torch.device(device)


def stitch(imgs, cfg: Config, key=None, output: str = "f32", device=None,
           info_out: dict | None = None):
    """Stitcher::build (stitcher.cc:32-63) for TRANS mode.

    imgs: [n, H, W, 3] uint8 or float32 in [0, 1] (numpy or torch).
    key: threefry key ``[2]`` (``utils.prng.key``); None means (0, 0),
    like ``PRNGKey(0)``.  output="f32" returns the blended canvas (float32
    numpy, INVALID=-1 where empty, pre-crop); output="u8" returns
    ``(canvas_u8, valid)``.  ``info_out`` collects per-image keypoint
    counts, the match graph, the homographies and the render plan."""
    check_supported(cfg)
    if output not in ("f32", "u8"):
        raise ValueError(f"output must be 'f32' or 'u8', not {output!r}")
    dev = resolve_device(device)
    key = prng.key((0, 0), dev) if key is None else key.to(dev)
    imgs = torch.as_tensor(np.asarray(imgs) if not torch.is_tensor(imgs)
                           else imgs)
    n, H, W = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    with total_timer("upload"):
        imgs = imgs.to(dev)
    with total_timer("calc_feature"):
        feats = compute_features(imgs, cfg)
    whs_np = np.repeat([[float(W), float(H)]], n, 0)
    whs = torch.as_tensor(whs_np, dtype=torch.float32, device=dev)
    mid = n >> 1                                  # assign_center, :138-141
    if info_out is not None:
        info_out["kpt_counts"] = feats.valid.sum(1).cpu().numpy()
    with total_timer("pairwise_match"):
        graph = build_pairwise_graph(feats, whs, cfg, key,
                                     ordered=cfg.ORDERED_INPUT, affine=True)
    homos = _build_linear_simple(graph, n, mid, whs_np)
    with total_timer("blend"):
        plan = plan_render(homos, whs_np, mid, "flat", cfg.MAX_OUTPUT_SIZE)
        src = imgs.to(torch.float32)
        if imgs.dtype == torch.uint8:
            src = src / 255.0
        canvas = blend_linear(src, plan, ordered=cfg.ORDERED_INPUT)
        if output == "u8":
            u8, valid = f32_to_u8(canvas)
            result = (u8.cpu().numpy(), valid.cpu().numpy())
        else:
            result = canvas.cpu().numpy()
    if info_out is not None:
        info_out.update(graph=graph, homos=homos, plan=plan,
                        connected_pairs=int(np.triu(graph.conf > 0, 1).sum()))
    return result
