"""Camera estimation: focal init, max-spanning-tree traversal,
incremental bundle adjustment schedule.

Reference: stitch/camera_estimator.{hh,cc}; counterpart of
``openpano_tpu/camera/estimator.py``.  The traversal (a Prim-style walk of
the match graph by descending confidence, camera_estimator.cc:105-159) and
the MULTIPASS_BA schedule (:74-99) are sequential over at most n steps and
stay on the host; every optimize() call runs the LM loop
(``bundle_adjuster.ba_optimize_pairs``) over a prefix of the pair slots,
padded to a bucketed size.

Where the LM runs: on the host CPU when ``Config.BA_ON_HOST`` (the
default), else on the card.  The problem arrays move to that device once
per bucket; the per-call activation weights follow them.
"""

from __future__ import annotations

import functools
import heapq
import os
import time

import numpy as np
import torch

from ..config import Config
from ..utils.debug import assert_finite
from ..utils.timer import span, total_timer
from .bundle_adjuster import (LM_MAX_ITER, BAPairProblem, _pairs_residuals,
                              ba_optimize_pairs)
from .camera import (CameraSet, estimate_focal, estimate_focal_robust,
                     intrinsic, straighten)
from .rotation import GEO_EPS_SQR

SLOT = 32  # match points per pair slot (estimator.py:152-159 there)


def _np_rod(v: np.ndarray) -> np.ndarray:
    """Numpy axis-angle -> R (the semantics of rotation.rodrigues,
    camera.cc:120-144), for per-edge host work."""
    v = np.asarray(v, np.float64)
    theta2 = float(v @ v)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    if theta2 < GEO_EPS_SQR:
        return np.eye(3) + K
    theta = np.sqrt(theta2)
    u = v / theta
    Ku = K / theta
    c, s = np.cos(theta), np.sin(theta)
    return c * np.eye(3) + (1 - c) * np.outer(u, u) + s * Ku


def _np_unrod(R: np.ndarray) -> np.ndarray:
    """Numpy R -> axis-angle with SVD re-orthogonalization (the semantics
    of rotation.rotation_to_angle, camera.cc:91-117)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    Rn = U @ Vt
    if np.linalg.det(Rn) < 0:
        Rn = -Rn
    r = np.array([
        Rn[2, 1] - Rn[1, 2], Rn[0, 2] - Rn[2, 0], Rn[1, 0] - Rn[0, 1]
    ])
    s = np.linalg.norm(r)
    if s < 1e-7:  # GEO_EPS
        return np.zeros(3)
    theta = np.arccos(np.clip((np.trace(Rn) - 1) * 0.5, -1.0, 1.0))
    return r * (theta / s)


def traverse_spanning_tree(confidence: np.ndarray):
    """Maximum-spanning-tree walk (camera_estimator.cc:105-159).

    confidence: [n,n] symmetric, 0 where unmatched.  Returns (root, edges)
    where edges is the visit-ordered list of (now, next); the root is the
    first endpoint of the first maximum in (i, j) scan order and the heap
    breaks ties on (-conf, frm, i).  Raises on a disconnected match graph,
    listing the stray images."""
    n = confidence.shape[0]
    best = (-1, -1, 0.0)
    for i in range(n):
        for j in range(i + 1, n):
            if confidence[i, j] > best[2]:
                best = (i, j, confidence[i, j])
    if best[0] == -1:
        raise RuntimeError("No connected images are found!")
    root = best[0]

    vst = [False] * n
    vst[root] = True
    q: list = []

    def enqueue(frm):
        for i in range(n):
            if i != frm and not vst[i] and confidence[frm, i] > 0:
                heapq.heappush(q, (-confidence[frm, i], frm, i))

    enqueue(root)
    edges = []
    cnt = 1
    while q:
        _, now, nxt = heapq.heappop(q)
        if vst[nxt]:
            continue
        vst[nxt] = True
        cnt += 1
        edges.append((now, nxt))
        enqueue(nxt)
    if cnt != n:
        stray = " ".join(str(i) for i in range(n) if not vst[i])
        raise RuntimeError(
            f"Found a tree of size {cnt}!={n}, image {stray} are not connected well!"
        )
    return root, edges


def _bucket(nact: int, cap: int) -> int:
    """Prefix bucket ladder: x2 up to 64, then x1.5 steps (96, 128, 192,
    256, 384, ...), capped at the slot count."""
    b = 8
    while b < min(nact, cap):
        if b < 64:
            b *= 2
        elif (b & (b - 1)) == 0:
            b += b // 2
        else:
            b += b // 3
    return min(b, cap)


def _fill_slabs(activation, nslots, to_pos, from_pos, valid, strided: bool):
    """Pair-major slabs [P, SLOT, 2] x2, weights [P, SLOT] and per-slot
    cameras / swap flags for the activation list, ``nslots[k]`` slots for
    entry k.  ``strided`` takes an evenly strided subset of each pair's
    inliers when it has more than its slots hold (a head prefix would bias
    toward one image region)."""
    P = max(sum(nslots), 1)
    pt_to = np.zeros((P, SLOT, 2))
    pt_from = np.zeros((P, SLOT, 2))
    w = np.zeros((P, SLOT))
    cam_a = np.zeros(P, np.int32)
    cam_b = np.zeros(P, np.int32)
    swapped = np.zeros(P, bool)
    s = 0
    for ((a, b), sw), ns in zip(activation, nslots):
        m = valid[a, b]
        pt = to_pos[a, b][m]                      # coords in image a ('to')
        pf = from_pos[a, b][m]
        cnt = len(pt)
        if strided:
            take = min(cnt, ns * SLOT)
            sel = np.arange(take) * cnt // max(take, 1)
            pt, pf, cnt = pt[sel], pf[sel], take
        for c in range(ns):
            seg = slice(c * SLOT, min((c + 1) * SLOT, cnt))
            k = seg.stop - seg.start
            pt_to[s, :k] = pt[seg]
            pt_from[s, :k] = pf[seg]
            w[s, :k] = 1.0
            cam_a[s] = a                          # stored: to=a, from=b
            cam_b[s] = b
            swapped[s] = sw
            s += 1
    return pt_to, pt_from, w, cam_a, cam_b, swapped


def _ba_device(cfg: Config, device, mesh=None) -> torch.device:
    """Where the LM runs: the mesh's device whatever ``BA_ON_HOST`` says (as
    in the JAX package, whose mesh LM runs on the devices); else the host
    CPU under ``BA_ON_HOST``, else ``device``."""
    if mesh is not None:
        from ..parallel.mesh import mesh_device

        return mesh_device(mesh)
    if cfg.BA_ON_HOST:
        return torch.device("cpu")
    from ..stitch.stitcher import resolve_device

    return resolve_device(device)


def estimate_cameras(
    confidence: np.ndarray,        # [n,n] pairwise confidence
    homos: np.ndarray,             # [n,n,3,3]; homos[i,j] maps j -> i
    to_pos: np.ndarray,            # [n,n,M,2] inlier coords in image i
    from_pos: np.ndarray,          # [n,n,M,2] inlier coords in image j
    valid: np.ndarray,             # [n,n,M]
    whs: np.ndarray,               # [n,2]
    cfg: Config,
    stats: dict | None = None,
    device=None,
    mesh=None,
) -> CameraSet:
    """Full CameraEstimator::estimate (camera_estimator.cc:46-103).

    ``device``: where the LM runs when ``cfg.BA_ON_HOST`` is False (None
    means the card, and raises without one); with BA_ON_HOST it runs on
    the CPU.  ``stats`` (a dict) accumulates 'lm_iters' and 'lm_time_s'
    over the whole schedule and receives 'ba_rms_px', 'ba_points' and
    'ba_pairs'.

    ``mesh`` (``parallel.make_mesh``): every LM run shards its pair slots
    over the ranks (``parallel.dist_ba``) on this rank's device, whatever
    ``BA_ON_HOST`` says; every rank returns the same cameras."""
    n = confidence.shape[0]
    dev = _ba_device(cfg, device, mesh)

    # the focal, the spanning tree and the LM problem's slabs
    with span("cameras.schedule"):
        focal = (estimate_focal_robust if cfg.ROBUST_FOCAL
                 else estimate_focal)(confidence, homos)
        focals = (np.full(n, focal) if focal > 0
                  else (whs[:, 0] + whs[:, 1]) * 0.5)
        params = np.zeros((n, 6))
        params[:, 0] = focals

        root, edges = traverse_spanning_tree(confidence)

        # the pair-major problem over all confident unordered pairs, slots
        # in the order the incremental schedule activates them
        # (camera_estimator.cc:74-99): pair (i, j) activates when its later
        # endpoint joins the tree, so the active set is always a slot
        # prefix; a pair's inliers fill ceil(count / SLOT) slots of the
        # same cameras
        conn = {(i, j) for i in range(n) for j in range(i + 1, n)
                if confidence[i, j] > 0 and valid[i, j].any()}
        activation: list[tuple[tuple[int, int], bool]] = []  # (key, swapped)
        act_slots: list[int] = []
        visited_sim = {root}
        for _, nxt in edges:
            visited_sim.add(nxt)
            for i in sorted(visited_sim - {nxt}):
                key = (min(i, nxt), max(i, nxt))
                if key in conn:
                    # stored orientation is to=key[0], from=key[1]; the
                    # schedule wants to=nxt (add_match(i, next), cc:76-88)
                    activation.append((key, key[1] == nxt))
                    act_slots.append(
                        max(-(-int(valid[key].sum()) // SLOT), 1))
        slots_by_key = {k: ns for (k, _), ns in zip(activation, act_slots)}
        full = _fill_slabs(activation, act_slots, to_pos, from_pos, valid,
                           False)
        P = full[0].shape[0]
        if os.environ.get("OPENPANO_BA_DEBUG"):
            print(f"[ba] pairs={len(activation)} slots={P} M={SLOT}")

        # intermediate passes run on a strided subset of each pair's inliers
        # (up to cap_k slots); the final polish sees every point
        cap_k = max(int(cfg.BA_INTERMEDIATE_POINT_SLOTS), 0)
        if cap_k > 0 and cfg.MULTIPASS_BA > 0:
            act_slots_c = [min(ns, cap_k) for ns in act_slots]
            capped = _fill_slabs(activation, act_slots_c, to_pos, from_pos,
                                 valid, True)
        else:
            act_slots_c, capped = act_slots, full
        slots_c_by_key = {k: ns for (k, _), ns in zip(activation,
                                                      act_slots_c)}
        Pc = capped[0].shape[0]

        # banded LM solve for chain/ring match graphs: automatic from 100
        # cameras; OPENPANO_BA_BANDED=1/0 forces/disables (structure
        # permitting)
        from .banded import is_chain_structure

        struct_ok = len(activation) > 0 and is_chain_structure(
            full[3][:P], full[4][:P], n)
        benv = os.environ.get("OPENPANO_BA_BANDED", "auto")
        banded = struct_ok and (benv == "1" or (benv != "0" and n >= 100))

    n_active = n_active_c = 0
    prob_cache: dict = {}

    def prob_for(b: int, nact: int, use_capped: bool) -> BAPairProblem:
        """The first ``b`` slots on the LM's device, converted once per
        bucket; the first ``nact`` are active."""
        key = (b, use_capped)
        with span("cameras.problem"):
            if key not in prob_cache:
                tt, tf, ww, ca, cb, sw = capped if use_capped else full
                t = lambda a, dt=None: torch.as_tensor(a[:b], dtype=dt,
                                                       device=dev)
                prob_cache[key] = BAPairProblem(
                    pt_to=t(tt), pt_from=t(tf), w=t(ww),
                    cam_to=t(ca, torch.int64), cam_from=t(cb, torch.int64),
                    swapped=t(sw), pair_w=None)
            pw = torch.zeros(b, dtype=torch.float64, device=dev)
            pw[:nact] = 1.0
            return prob_cache[key]._replace(pair_w=pw)

    def run_ba(max_iter=LM_MAX_ITER, patience=5, rel_tol=0.0,
               use_capped=False):
        nonlocal params
        use_capped = use_capped and cap_k > 0
        nact = n_active_c if use_capped else n_active
        if nact == 0:
            return
        b = _bucket(nact, Pc if use_capped else P)
        with total_timer(f"ba_lm[{b}]"):
            t0 = time.perf_counter()
            if mesh is None:
                run = ba_optimize_pairs
            else:
                from ..parallel.dist_ba import ba_optimize_pairs_sharded

                run = functools.partial(ba_optimize_pairs_sharded, mesh=mesh)
            out, iters = run(
                torch.as_tensor(params, device=dev),
                prob_for(b, nact, use_capped), root, n, cfg.LM_LAMBDA,
                adaptive=cfg.BA_ADAPTIVE_LM, max_iter=max_iter,
                patience=patience, rel_tol=rel_tol, banded=banded, bucket=b)
            params = out.cpu().numpy()
            if stats is not None:
                stats["lm_iters"] = stats.get("lm_iters", 0) + iters
                stats["lm_time_s"] = (stats.get("lm_time_s", 0.0)
                                      + time.perf_counter() - t0)

    inter = dict(max_iter=cfg.BA_INTERMEDIATE_ITERS,
                 patience=cfg.BA_INTERMEDIATE_PATIENCE,
                 rel_tol=cfg.BA_INTERMEDIATE_REL_TOL, use_capped=True)
    # the intermediate BA of MULTIPASS_BA=1 runs once per BA_BATCH_IMAGES
    # added images
    batch_k = max(int(cfg.BA_BATCH_IMAGES), 1)
    since_ba = 0
    visited = {root}
    for now, nxt in edges:
        # initialize camera[nxt] from camera[now] (camera_estimator.cc:59-69);
        # under OPENPANO_CHECK_NUMERICS the homography it reads is checked
        # here, where it enters the cameras (the LM checks the points)
        assert_finite("estimate_camera",
                      **{f"homos[{now}, {nxt}]": homos[now, nxt]})
        K_now = intrinsic(params[now, 0], params[now, 1], params[now, 2])
        R_now = _np_rod(params[now, 3:6])
        K_next = intrinsic(params[nxt, 0], 0.0, 0.0)
        Mt = np.linalg.inv(K_now) @ homos[now, nxt] @ K_next   # next -> now
        R_next = (R_now.T @ Mt).T
        params[nxt, 1:3] = 0.0
        params[nxt, 3:6] = _np_unrod(R_next)

        visited.add(nxt)
        if cfg.MULTIPASS_BA > 0:
            for i in sorted(visited - {nxt}):
                key = (min(i, nxt), max(i, nxt))
                if key in conn:
                    n_active += slots_by_key[key]
                    n_active_c += slots_c_by_key[key]
                    if cfg.MULTIPASS_BA == 2:
                        run_ba(**inter)
            if cfg.MULTIPASS_BA == 1:
                since_ba += 1
                if since_ba >= batch_k or len(visited) == n:
                    run_ba(**inter)
                    since_ba = 0

    pair_swapped = full[5]
    if cfg.MULTIPASS_BA == 0:                     # camera_estimator.cc:92-99
        # one global BA; the reference adds every pair as add_match(i, j)
        # with j < i, i.e. to = the smaller index = stored orientation
        pair_swapped[:] = False
        prob_cache.clear()                        # the swap flags changed
        n_active = P
        run_ba()
    elif cfg.BA_INTERMEDIATE_ITERS < LM_MAX_ITER:
        run_ba(cfg.BA_FINAL_MAX_ITER, patience=cfg.BA_FINAL_PATIENCE)

    if stats is not None and len(activation):
        # final self-consistency residual over all active pairs, on the
        # LM's device
        tt, tf, ww, ca, cb, sw = full
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
        prob_all = BAPairProblem(
            pt_to=t(tt), pt_from=t(tf), w=t(ww),
            cam_to=t(ca, torch.int64), cam_from=t(cb, torch.int64),
            swapped=t(sw), pair_w=torch.ones(P, dtype=torch.float64,
                                             device=dev))
        r, wm = _pairs_residuals(t(params), prob_all)
        r, wm = r.cpu().numpy(), wm.cpu().numpy()
        npts = float((wm > 0).sum())
        stats["ba_rms_px"] = float(
            np.sqrt(np.sum(r ** 2) / max(npts * 2.0, 1.0)))
        stats["ba_points"] = int(npts)
        stats["ba_pairs"] = len(activation)

    cams = CameraSet(
        focal=params[:, 0].copy(),
        ppx=params[:, 1].copy(),
        ppy=params[:, 2].copy(),
        R=np.stack([_np_rod(params[i, 3:6]) for i in range(n)]),
    )
    if cfg.STRAIGHTEN:
        cams = straighten(cams)                   # camera_estimator.cc:101
    return cams
