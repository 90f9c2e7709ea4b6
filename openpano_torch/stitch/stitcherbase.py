"""Feature extraction over an image set.

Reference: StitcherBase (stitch/stitcherbase.{hh,cc}) — a loop over images
doing load -> SIFT detect, erroring on an image with zero features
(stitcherbase.cc:9-27); counterpart of ``openpano_tpu/stitch/stitcherbase.py``.

Two grey routes, as in the JAX package, and they give different keypoints:

- uint8 input greys FIRST, as the exact channel sum ``(r+g+b)/765`` in f32,
  then resizes the grey plane to the working size (the JAX package's
  ``_grey_sum_to_f32`` feeding ``_feature_chunk``);
- float input resizes RGB to the working size and greys inside the detector
  (``jnp.mean`` over channels).

Images run through the detector in batches of ``FEATURE_BATCH``: the scale
space of one batch is the live set.  A stack in host memory uploads one batch
at a time: the stitcher keeps image sets too large for the device there
(``HostImages``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops.imgproc import resize, working_size
from ..sift.descriptor import Features
from ..sift.detector import detect_and_describe

FEATURE_BATCH = 4


def grey_u8(imgs: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, H, W] f32 mean of channels, from the exact
    integer channel sum (stitcherbase.py:164-169 there)."""
    s = imgs.to(torch.int32).sum(-1)
    return s.to(torch.float32) / (3.0 * 255.0)


class HostImages(NamedTuple):
    """A uint8 [N, H, W, 3] stack that stays in host memory: the stitcher's
    marker for the path that never uploads the whole stack (features batch
    by batch, then ``render.blend_linear_host_stream`` or
    ``multiband.blend_multiband_host_stream``) on ``device``."""
    host: np.ndarray
    device: torch.device


def compute_features(imgs, cfg: Config, dev=None) -> Features:
    """imgs: [N, H, W, 3] uint8 (grey route first) or float32 RGB in [0, 1],
    or [N, H, W] float grey, all on one device; or a host numpy stack that
    goes to ``dev`` one batch at a time (the same batches, so the same
    features bit for bit, and no [N, H, W, 3] tensor on the device).
    Returns batched Features with half-shifted original-image coordinates;
    raises when an image has no feature (stitcherbase.cc:20-21)."""
    n, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    wh_, ww_ = working_size(w, h, cfg.SIFT_WORKING_SIZE)
    parts = []
    for lo in range(0, n, FEATURE_BATCH):
        batch = imgs[lo : lo + FEATURE_BATCH]
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
        orig = torch.tensor([w, h], dtype=torch.float32, device=batch.device)
        if batch.dtype == torch.uint8:
            work = resize(grey_u8(batch), wh_, ww_)
        else:
            batch = batch.to(torch.float32)
            work = resize(batch, wh_, ww_, rgb=batch.dim() == 4)
        parts.append(detect_and_describe(
            work, orig.expand(batch.shape[0], 2), cfg))
    feats = Features(*(torch.cat(f, dim=0) for f in zip(*parts)))
    _check_counts(feats)
    return feats


def _check_counts(feats: Features):
    counts = feats.valid.sum(1).tolist()
    for i, c in enumerate(counts):
        if c == 0:
            raise RuntimeError(f"Cannot find feature in image {i}!")


def feature_shards(n: int, nd: int) -> np.ndarray:
    """[nd, L] image indices per rank, -1 for padding: the images that the
    JAX package's device g takes (``compute_features_sharded`` there).  The
    batch is padded to a mesh multiple; a batch of at most
    ``FEATURE_BATCH * nd`` splits evenly, a larger one runs in chunks of
    that size, rank g taking rows [g * FEATURE_BATCH, (g + 1) *
    FEATURE_BATCH) of each (the last chunk padded).  The JAX package fills
    the padding with copies of an image and drops their features; here no
    rank computes it."""
    total = n + (-n % nd)
    idx = np.concatenate([np.arange(n), np.full(total - n, -1)])
    chunk = FEATURE_BATCH * nd
    if total <= chunk:
        return idx.reshape(nd, -1)
    parts = []
    for lo in range(0, total, chunk):
        c = idx[lo : lo + chunk]
        c = np.concatenate([c, np.full(chunk - len(c), -1)])
        parts.append(c.reshape(nd, FEATURE_BATCH))
    return np.concatenate(parts, 1)


def compute_features_sharded(imgs, cfg: Config, mesh) -> Features:
    """Data-parallel features over the ranks of ``mesh`` (the JAX package's
    ``compute_features_sharded``): rank g runs :func:`compute_features` on
    the images ``feature_shards`` gives it, uploading only those from a
    host stack; the fixed-cap Features of every rank are all-gathered into
    image order, so every rank returns all of them.  ``imgs`` as for
    :func:`compute_features` (a host numpy stack, or a tensor on this
    rank's device).  Raises "Cannot find feature" after the gather, on
    every rank together."""
    from ..parallel.mesh import all_gather, mesh_device

    n = imgs.shape[0]
    shards = feature_shards(n, mesh.size())
    L = shards.shape[1]
    own = shards[mesh.get_local_rank()]
    ids = own[own >= 0]
    dev = mesh_device(mesh)
    K = cfg.MAX_KP_PER_IMAGE
    local = Features(
        pos=torch.zeros(L, K, 2, dtype=torch.float32, device=dev),
        desc=torch.zeros(L, K, 128, dtype=torch.float32, device=dev),
        valid=torch.zeros(L, K, dtype=torch.bool, device=dev))
    if len(ids):
        sub = imgs[ids] if isinstance(imgs, np.ndarray) else imgs[
            torch.as_tensor(ids, device=imgs.device)]
        mine = compute_features(sub, cfg, dev)
        for a, b in zip(local, mine):
            a[: len(ids)] = b
    slot = np.empty(n, np.int64)                   # image -> gathered row
    for g, row in enumerate(shards):
        for k, i in enumerate(row[row >= 0]):
            slot[i] = g * L + k
    rows = torch.as_tensor(slot, device=dev)
    feats = Features(*(all_gather(mesh, a, "features")[rows] for a in local))
    _check_counts(feats)
    return feats
