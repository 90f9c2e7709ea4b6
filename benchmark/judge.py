"""The numbers that decide ``correct``, each of the program's outputs held
against the references (``sift_ref.py``, ``reference.py``) at the timed
sizes.

A captured panorama (``Capture``) holds what the timed path produced for
one view set: the keypoints the detector described, the descriptors the
matcher got and the matches it returned,
the match graph after RANSAC, the final transforms (``homos``) and the u8
canvas with its mask; and what the benchmark made: the views and their
truth.  ``numbers`` works out each number; ``variant="control"`` puts the
reference, computed one precision step down, in the program's place
(``PERF.md`` gives the readings and the limits).  This module imports
nothing of the port.

The numbers, by layer:

- the features (``sift_ref.py`` builds each view's scale space again
  from the u8 views, in float64): ``kp_diff``, the keypoints (octave
  level, row, column) that the program and the reference disagree on,
  over the reference's (each side's keypoints with a direction, under the
  configuration's caps); ``kp_offset``, the largest gap, over the
  keypoints both find, between their refined positions (octave pixels)
  and scales (scale steps); ``ori_miss``, the share of the program's
  directions farther than ``ORI_TOL`` from every peak of the reference's
  histogram of that keypoint, and of the reference's clear peaks farther
  than that from the program's directions; ``desc_miss``, the share of
  the descriptors the matcher got that lie farther than ``DESC_TOL``
  (over DESC_INT_FACTOR) from the reference's for the same keypoint and
  direction;
- ``match_diff`` (match): the matches the program and the reference
  matcher disagree on, over all the reference's matches, every matched
  pair;
- ``refit_px`` (RANSAC): the largest distance, over the inliers of every
  connected pair, between the program's transform and the reference's fit
  to the same inliers (an affine fit under TRANS and CYLINDER, as
  transform_estimate.cc:34-37 fits);
- ``truth_px`` (cameras, and the geometry before them): the largest,
  over the pairs adjacent in the scene, of the mean distance on a grid
  between the final transforms' pair map and the true one;
  ``truth_mean_px`` the mean over those pairs, for a chain of many pairs
  whose largest is a tail;
- ``canvas_bad`` (blend): the share of canvas pixels where the masks
  differ or a channel differs by more than one level from the reference's
  blend of the benchmark's views through the final transforms (1 when the
  canvas sizes differ).

Per mode: CYLINDER matches the n - 1 pairs (i, i + 1), no wrap pair, and
its graph holds each pair at [i, i + 1] or [i + 1, i]; its final
transforms map cylinder-warped views.  A reference module that defines
``view_map`` (a view's points carried into another through the final
transforms) and ``canvas`` (the whole canvas from the views) judges the
pair maps and the canvas in its own way (``reference_cylinder.py``); one
that does not takes the plain homography and ``plan`` with ``blend``.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import sift_ref

LOW = {"float64": torch.float32, "float32": torch.bfloat16}


def _ref(s: dict):
    """The configuration's reference module, ``benchmark/<name>.py``."""
    return importlib.import_module("benchmark." + s.get("reference",
                                                       "reference"))


@dataclass
class Capture:
    """One stitched panorama, on the host."""
    views: np.ndarray            # [N, H, W, 3] u8, as handed in
    truth: dict
    desc: torch.Tensor           # [N, K, 128] as the matcher got them
    valid: torch.Tensor          # [N, K]
    match_idx: torch.Tensor      # [P, M, 2]
    match_count: torch.Tensor    # [P]
    graph: dict                  # conf, homo, to_pos, from_pos, valid
    homos: np.ndarray            # [N, 3, 3]
    canvas: np.ndarray           # [h, w, 3] u8
    mask: np.ndarray             # [h, w] bool
    kps: list | None = None      # per view: sift_ref.KP_FIELDS
    hfactor: float | None = None  # CYLINDER: the h-factor the program chose
    cache: dict = field(default_factory=dict)


def pair_list(n: int, s: dict):
    """The pairs the stitcher matches under the settings ``s``: (i, i+1)
    with no wrap pair in CYLINDER mode, the ring (i, i+1 mod n) for other
    ordered input, else every i < j in row-major order."""
    if s.get("CYLINDER", False):
        return list(range(n - 1)), list(range(1, n))
    if s["ORDERED_INPUT"]:
        return list(range(n)), [(i + 1) % n for i in range(n)]
    ii, jj = np.triu_indices(n, 1)
    return ii.tolist(), jj.tolist()


# a peak's tests widened (or narrowed) by this share: f32 histograms sit
# within 1e-6 of the float64 ones, so only a test decided by rounding moves
PEAK_SLACK = 1e-4
# a direction or a descriptor this far off counts as missed
ORI_TOL = 0.1            # radians, about half of a 10-degree bin
DESC_TOL = 0.01          # of DESC_INT_FACTOR


def _keys(kp: dict, H0: int, W0: int) -> torch.Tensor:
    return (kp["s"].long() * H0 + kp["y"].long()) * W0 + kp["x"].long()


def _circ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = torch.remainder(a - b, 2 * math.pi)
    return torch.minimum(d, 2 * math.pi - d)


def _view_features(view, got: dict, s: dict, device) -> dict:
    """The feature numbers of one view: ``got`` holds the keypoints
    (``sift_ref.KP_FIELDS``) and descriptors the program (or the control)
    gave it."""
    f64 = torch.float64
    octs = sift_ref.scale_space(torch.as_tensor(view, device=device), s, f64)
    H0, W0 = octs[0]["h"], octs[0]["w"]
    got = {k: torch.as_tensor(v, device=device) for k, v in got.items()}
    # the reference's keypoints as the configuration caps their directions
    ref = sift_ref.oriented(octs, sift_ref.detect(octs, s), s, f64)
    gk, rk = _keys(got, H0, W0), _keys(ref, H0, W0)
    ug, first = np.unique(gk.cpu().numpy(), return_index=True)
    ug = torch.as_tensor(ug, device=device)
    first = torch.as_tensor(first, device=device)
    ur = torch.unique(rk)
    diff = int((~torch.isin(ug, ur)).sum()) + int((~torch.isin(ur, ug)).sum())
    # refined positions and scales of the keypoints both found
    both = torch.isin(ug, ur)
    gi = first[both]
    order = torch.argsort(rk)
    ri = order[torch.searchsorted(rk[order], ug[both])]
    steps = lambda sf: s["NUM_SCALE"] * torch.log(
        sf.double() / s["GAUSS_SIGMA"]) / math.log(s["SCALE_FACTOR"])
    gaps = [(got["real_x"][gi].double() - ref["real_x"][ri]).abs()
            * ref["w"][ri], (got["real_y"][gi].double() - ref["real_y"][ri])
            .abs() * ref["h"][ri],
            (steps(got["scale_factor"][gi]) - steps(ref["scale_factor"][ri]))
            .abs()]
    offset = float(torch.stack(gaps).max()) if gi.numel() else 0.0
    # the reference's orientations and descriptors of the program's keypoints
    kp = {k: got[k] for k in sift_ref.KP_FIELDS}
    kp["scale_factor"] = kp["scale_factor"].double()
    hist = sift_ref.orientations(octs, {k: v[first] for k, v in kp.items()},
                                 s, f64)
    dirs, loose = sift_ref.peaks(hist, s, PEAK_SLACK)
    _, clear = sift_ref.peaks(hist, s, -PEAK_SLACK)
    slot_key = torch.searchsorted(ug, gk)       # each slot's unique key
    gd = got["dir"].double()
    fwd = torch.where(loose[slot_key], _circ(gd[:, None], dirs[slot_key]),
                      torch.full_like(dirs[slot_key], math.pi)).amin(1)
    M = s["MAX_ORI_PER_KP"]
    rank = torch.argsort(torch.argsort(
        torch.where(clear, -hist, torch.zeros_like(hist)), dim=1,
        stable=True), dim=1)
    want = clear & (rank < M)                   # [U, 36]
    # the program's directions by keypoint, [U, most slots a keypoint has]
    by = torch.argsort(slot_key, stable=True)
    sk = slot_key[by]
    start = torch.searchsorted(sk, sk, right=False)
    col = torch.arange(len(sk), device=device) - start
    per = torch.full((len(ug), int(col.max()) + 1 if len(sk) else 1),
                     float("nan"), dtype=f64, device=device)
    per[sk, col] = gd[by]
    back = torch.nan_to_num(_circ(dirs[:, :, None], per[:, None, :]),
                            nan=math.pi).amin(2)
    angles = torch.cat([fwd, back[want]])
    want_desc = sift_ref.descriptors(octs, kp, s, f64)
    err = (got["desc"].double() - want_desc).norm(dim=1) / s["DESC_INT_FACTOR"]
    return {"diff": diff, "total": int(ur.numel()), "offset": offset,
            "ori": angles.cpu(), "desc": err.cpu()}


def _features(cap: Capture, s: dict, variant: str, device) -> dict:
    """The feature numbers over every view, worked out once a capture and
    variant; the control computes its features in bfloat16."""
    key = ("features", variant)
    if key not in cap.cache:
        rows = []
        for i, view in enumerate(cap.views):
            if variant == "control":
                low = LOW[s["precision"]["features"]]
                kp, desc = sift_ref.features(
                    torch.as_tensor(view, device=device), s, low)
                got = {**{k: kp[k] for k in sift_ref.KP_FIELDS},
                       "desc": desc.float()}
            else:
                # the descriptors as the matcher got them, in the order of
                # the keypoints the detector described
                desc = cap.desc[i][cap.valid[i]]
                if desc.shape[0] != cap.kps[i]["x"].shape[0]:
                    return {n: float("inf") for n in FEATURE_NUMBERS}
                got = {**cap.kps[i], "desc": desc}
            rows.append(_view_features(view, got, s, device))
        cap.cache[key] = {
            "kp_diff": sum(r["diff"] for r in rows)
            / max(sum(r["total"] for r in rows), 1),
            "kp_offset": max(r["offset"] for r in rows)}
        for name, tol in (("ori", ORI_TOL), ("desc", DESC_TOL)):
            v = torch.cat([r[name] for r in rows])
            cap.cache[key][name + "_miss"] = (float((v > tol).double().mean())
                                              if len(v) else 0.0)
    return cap.cache[key]


FEATURE_NUMBERS = ("kp_diff", "kp_offset", "ori_miss", "desc_miss")


def _feature_number(name: str):
    def number(cap: Capture, s: dict, variant: str, device) -> float:
        if cap.kps is None and variant != "control":
            return float("inf")
        return _features(cap, s, variant, device)[name]
    number.__name__ = name
    return number


def match_diff(cap: Capture, s: dict, variant: str, device) -> float:
    ref = _ref(s)
    n, K = cap.desc.shape[0], cap.desc.shape[1]
    ii, jj = pair_list(n, s)
    desc, valid = cap.desc.to(device), cap.valid.to(device)
    args = (desc, valid, ii, jj, s["MATCH_REJECT_NEXT_RATIO"],
            s["MAX_MATCHES_PER_PAIR"])
    want = ref.match_pairs(*args)
    if variant == "control":
        got = ref.match_pairs(*args, dtype=LOW[s["precision"]["match"]])
    else:
        M = cap.match_idx.shape[1]
        idx = cap.match_idx.to(device)
        cnt = torch.clamp(cap.match_count.to(device), max=M)
        got = [idx[p, :cnt[p], 0] * K + idx[p, :cnt[p], 1]
               for p in range(len(ii))]
    diff = total = 0
    for a, b in zip(got, want):
        diff += int((~torch.isin(a, b)).sum()) + int((~torch.isin(b, a)).sum())
        total += int(b.numel())
    return diff / max(total, 1)


def refit_px(cap: Capture, s: dict, variant: str, device) -> float:
    ref = _ref(s)
    g = cap.graph
    conf = g["conf"]
    pairs = []
    for i, j in zip(*pair_list(len(cap.homos), s)):
        if conf[i, j] > 0:
            pairs.append((i, j))
        elif s.get("CYLINDER", False) and conf[j, i] > 0:
            pairs.append((j, i))
    if not pairs:
        return float("inf")
    ii, jj = np.array(pairs).T
    to, fr, w = g["to_pos"][ii, jj], g["from_pos"][ii, jj], g["valid"][ii, jj]
    affine = s["TRANS"] or s.get("CYLINDER", False)
    want = ref.refit(to, fr, w, affine, device=device)
    got = (ref.refit(to, fr, w, affine, dtype=LOW[s["precision"]["ransac"]],
                     device=device)
           if variant == "control" else g["homo"][ii, jj])
    d = np.linalg.norm(ref.apply_h(got, fr) - ref.apply_h(want, fr), axis=-1)
    return float(np.where(w, d, 0).max())


def _final(cap: Capture, s: dict, variant: str) -> np.ndarray:
    """The final transforms; for the control, rounded to the precision
    below the cameras' (float32 for float64)."""
    if variant == "control":
        low = LOW[s["precision"]["cameras"]]
        return torch.as_tensor(cap.homos).to(low).double().numpy()
    return cap.homos


def _truth_errors(cap: Capture, s: dict, variant: str) -> list:
    """For each pair adjacent in the scene, the mean distance on a 9 x 7
    grid over view b (the points that land in view a) between the final
    transforms' map from b to a (the reference module's ``view_map`` where
    it has one) and the true one, in view pixels."""
    ref = _ref(s)
    homos = _final(cap, s, variant)
    w, h = cap.truth["size"]
    gx, gy = np.meshgrid(np.linspace(-0.45 * w, 0.45 * w, 9),
                         np.linspace(-0.45 * h, 0.45 * h, 7))
    grid = np.stack([gx.ravel(), gy.ravel()], 1)
    errs = []
    for a, b, T in cap.truth["adjacent"]:
        want = ref.apply_h(T, grid)
        inside = (np.abs(want[:, 0]) < w / 2) & (np.abs(want[:, 1]) < h / 2)
        if not inside.any():
            continue
        if hasattr(ref, "view_map"):
            got = ref.view_map(homos, a, b, grid[inside], (w, h), s,
                               cap.hfactor)
        else:
            got = ref.apply_h(np.linalg.inv(homos[a]) @ homos[b],
                              grid[inside])
        errs.append(float(np.linalg.norm(got - want[inside], axis=1).mean()))
    return errs


def truth_px(cap: Capture, s: dict, variant: str, device) -> float:
    return max(_truth_errors(cap, s, variant), default=float("inf"))


def truth_mean_px(cap: Capture, s: dict, variant: str, device) -> float:
    errs = _truth_errors(cap, s, variant)
    return float(np.mean(errs)) if errs else float("inf")


def _plan_and_blend(ref, views: torch.Tensor, homos: np.ndarray, s: dict,
                    hfactor, dtype=torch.float64):
    """The canvas of the views through the final transforms, where the
    reference module has no ``canvas`` of its own: ``plan`` on the views'
    size, then its ``blend``."""
    n, H, W = views.shape[:3]
    whs = np.repeat([[float(W), float(H)]], n, 0)
    pl = ref.plan(homos, whs, n >> 1,
                  "spherical" if s["ESTIMATE_CAMERA"] else "flat",
                  s["MAX_OUTPUT_SIZE"])
    return ref.blend(views, pl, s, dtype=dtype)


def canvas_bad(cap: Capture, s: dict, variant: str, device) -> float:
    ref = _ref(s)
    make = getattr(ref, "canvas", None) or (
        lambda *a, **k: _plan_and_blend(ref, *a, **k))
    views = torch.as_tensor(cap.views, device=device)
    want, want_m = make(views, cap.homos, s, cap.hfactor)
    if variant == "control":
        got, got_m = make(views, cap.homos, s, cap.hfactor,
                          dtype=LOW[s["precision"]["blend"]])
    else:
        got = torch.as_tensor(cap.canvas, device=device)
        got_m = torch.as_tensor(cap.mask, device=device)
    if got.shape != want.shape:
        return 1.0
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)
    bad = (got_m != want_m) | (got_m & want_m & (diff > 1))
    return float(bad.double().mean())


NUMBERS = {**{n: _feature_number(n) for n in FEATURE_NUMBERS},
           "match_diff": match_diff,
           "refit_px": refit_px, "truth_px": truth_px,
           "truth_mean_px": truth_mean_px, "canvas_bad": canvas_bad}


def numbers(cap: Capture, settings: dict, names, variant: str = "program",
            device="cpu") -> dict:
    """The numbers ``names`` of one captured panorama."""
    return {name: NUMBERS[name](cap, settings, variant, device)
            for name in names}


def verdict(values: dict, limits: dict) -> bool:
    """Whether every number is within its limit (a NaN is not)."""
    return all(values[k] <= limits[k] for k in limits)
