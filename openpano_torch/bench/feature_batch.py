"""Sweep of the feature batch (``OPENPANO_FEATURE_BATCH``), the counterpart
of ``tools/sweep_feature_batch.py``.

    python -m openpano_torch.bench.feature_batch [--device cpu] [B ...]

``stitcherbase.upload_and_compute_features`` (the transport's upload and
the features, as the stitcher runs them, the chroma stream on) over the
headline's 38 uint8 views of 1300x867, for each batch size B (the JAX
tool's 1, 2, 4, 8, 19, 38 by default), best of three.  The knob is read at
call time, so every B runs in this one process (the JAX tool starts a
process per B for its compile caches; nothing here is compiled per B).
Each B prints one JSON line with the JAX tool's ``batch``, the trials and
``best_s``, plus the peak device memory of the upload and features, K1's
and K2's launches in each trial (``ceil(38 / B)`` on the card), whether
the features equal the first B's bit for bit (features are per view, so
they must) and the device record.  A B that fails prints its error
instead, the sweep goes on, and the run exits 1: no size is dropped
silently.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import Config
from ..stitch.stitcher import resolve_device
from ..stitch.stitcherbase import upload_and_compute_features
from . import device_record, sync
from .headline import headline_inputs
from .profile_sift import launches

SIZES = (1, 2, 4, 8, 19, 38)


def _features_once(u8: np.ndarray, cfg: Config, dev: torch.device):
    """(features, wall s): the features synchronised inside the clock, the
    chroma stream released and joined after it."""
    sync(dev)
    t0 = time.perf_counter()
    imgs, feats = upload_and_compute_features(u8, cfg, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    imgs.start_background()
    imgs.get()
    return feats, wall


def sweep_one(u8: np.ndarray, cfg: Config, dev: torch.device, B: int,
              trials: int, ref=None) -> tuple[dict, object]:
    """One batch size under ``OPENPANO_FEATURE_BATCH=B`` (restored after):
    (its JSON line, its features)."""
    on_card = dev.type == "cuda"
    old = os.environ.get("OPENPANO_FEATURE_BATCH")
    os.environ["OPENPANO_FEATURE_BATCH"] = str(B)
    try:
        walls, counts, peak = [], [], None
        for _ in range(trials):
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            before = launches()
            feats, wall = _features_once(u8, cfg, dev)
            walls.append(wall)
            counts.append([b - a for a, b in zip(before, launches())])
            if on_card:
                peak = max(peak or 0.0,
                           torch.cuda.max_memory_allocated(dev) / 2**30)
    finally:
        if old is None:
            os.environ.pop("OPENPANO_FEATURE_BATCH", None)
        else:
            os.environ["OPENPANO_FEATURE_BATCH"] = old
    same = (None if ref is None else
            all(torch.equal(a, b) for a, b in zip(feats, ref)))
    return {"batch": B, "views": len(u8), "trials_s": walls,
            "best_s": min(walls), "peak_device_gib": peak,
            "launches": [{"orientation_histogram": k1,
                          "descriptor_histogram": k2} for k1, k2 in counts],
            "expected_launches": -(-len(u8) // B),
            "features_equal_first": same,
            "keypoints": int(feats.valid.sum())}, feats


def run(device=None, sizes=SIZES, u8: np.ndarray | None = None,
        trials: int = 3, cfg: Config | None = None) -> tuple[list, bool]:
    """(one JSON dict per batch size, every size ran); the features of
    every size are held to the first size's.  ``u8``: the headline's views
    by default; ``cfg``: the JAX tool's Config(MAX_KP_PER_IMAGE=2048)."""
    dev = resolve_device(device)
    cfg = cfg or Config(MAX_KP_PER_IMAGE=2048)
    record = device_record(dev)
    if u8 is None:
        u8 = headline_inputs()[0]
    lines, ok, ref = [], True, None
    for B in sizes:
        try:
            line, feats = sweep_one(u8, cfg, dev, int(B), trials, ref)
        except RuntimeError as e:   # CUDA errors and OOM among them
            lines.append(dict({"batch": int(B), "error": repr(e)}, **record))
            ok = False
            continue
        ref = feats if ref is None else ref
        if line["features_equal_first"] is False:
            ok = False
        if dev.type == "cuda" and any(
                c != line["expected_launches"]
                for trial in line["launches"] for c in trial.values()):
            ok = False
        lines.append(dict(line, **record))
    return lines, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m openpano_torch.bench.feature_batch")
    ap.add_argument("sizes", nargs="*", type=int, default=list(SIZES))
    ap.add_argument("--device", default=None,
                    help="run on this device (the card by default)")
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)
    lines, ok = run(device=args.device, sizes=args.sizes, trials=args.trials)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
