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

Images run through the detector in batches of ``feature_batch()`` views
(``OPENPANO_FEATURE_BATCH``, read at each call; 4 by default, the port's
measured choice: the JAX package's default of 1 came from a TPU sweep and
does not carry over): the scale space of one batch is the live set.
Features are per view, so every batch size gives the same features bit for
bit; K1 and K2 launch once per batch.  A stack in host memory uploads one batch
at a time: the stitcher keeps image sets too large for the device there
(``HostImages``).

The transport (``upload_and_compute_features``), the JAX package's route for
a uint8 host stack: the host splits each view into its rounded grey plane
and a 2-bit channel-sum residual, which upload through the wire codec in
chunks of ``OPENPANO_GREY_CHUNK`` views (8 by default) and feed the
detector as the exact channel sum; the two chroma planes (red and blue less
grey, mod 256) stream in a background thread (``DeferredImages``), joined
just before the blend.  Every step is exact in integers, so the features
and the blend's f32 stack are those of a plain upload bit for bit.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops.imgproc import resize, working_size
from ..sift.descriptor import Features
from ..sift.detector import detect_and_describe
from ..utils.timer import span

FEATURE_BATCH = 4   # the default of ``feature_batch()``


def feature_batch() -> int:
    """Views per detector batch: ``OPENPANO_FEATURE_BATCH``, read at call
    time so that one process can sweep it; ``FEATURE_BATCH`` (4) unset.
    A value below 1 raises."""
    b = int(os.environ.get("OPENPANO_FEATURE_BATCH", str(FEATURE_BATCH)))
    if b < 1:
        raise ValueError(f"OPENPANO_FEATURE_BATCH={b}: must be at least 1")
    return b


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

    def start_background(self):
        """Nothing streams: the call site is that of ``DeferredImages``."""


def _batch_features(grey_or_imgs: torch.Tensor, cfg: Config, w: int,
                    h: int) -> Features:
    """The features of one batch: u8 RGB greys first (``grey_u8``), a f32
    [B, H, W] grey plane goes as it is, f32 RGB greys in the detector."""
    wh_, ww_ = working_size(w, h, cfg.SIFT_WORKING_SIZE)
    batch = grey_or_imgs
    with span("features.resize"):
        orig = torch.tensor([w, h], dtype=torch.float32, device=batch.device)
        if batch.dtype == torch.uint8:
            work = resize(grey_u8(batch), wh_, ww_)
        else:
            batch = batch.to(torch.float32)
            work = resize(batch, wh_, ww_, rgb=batch.dim() == 4)
    return detect_and_describe(work, orig.expand(batch.shape[0], 2), cfg)


def compute_features(imgs, cfg: Config, dev=None) -> Features:
    """imgs: [N, H, W, 3] uint8 (grey route first) or float32 RGB in [0, 1],
    or [N, H, W] float grey, all on one device; or a host numpy stack that
    goes to ``dev`` one batch at a time (the same batches, so the same
    features bit for bit, and no [N, H, W, 3] tensor on the device).
    Returns batched Features with half-shifted original-image coordinates;
    raises when an image has no feature (stitcherbase.cc:20-21)."""
    n, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    B = feature_batch()
    parts = []
    for lo in range(0, n, B):
        batch = imgs[lo : lo + B]
        if isinstance(batch, np.ndarray):
            with span("features.upload"):
                batch = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
        parts.append(_batch_features(batch, cfg, w, h))
    feats = Features(*(torch.cat(f, dim=0) for f in zip(*parts)))
    _check_counts(feats)
    return feats


def _check_counts(feats: Features):
    with span("features.check"):
        counts = feats.valid.sum(1).tolist()
    for i, c in enumerate(counts):
        if c == 0:
            raise RuntimeError(f"Cannot find feature in image {i}!")


def feature_shards(n: int, nd: int) -> np.ndarray:
    """[nd, L] image indices per rank, -1 for padding: the images that the
    JAX package's device g takes (``compute_features_sharded`` there).  The
    batch is padded to a mesh multiple; with B = ``feature_batch()``, a
    batch of at most ``B * nd`` splits evenly, a larger one runs in chunks
    of that size, rank g taking rows [g * B, (g + 1) * B) of each (the last
    chunk padded).  The JAX package fills
    the padding with copies of an image and drops their features; here no
    rank computes it."""
    total = n + (-n % nd)
    idx = np.concatenate([np.arange(n), np.full(total - n, -1)])
    B = feature_batch()
    chunk = B * nd
    if total <= chunk:
        return idx.reshape(nd, -1)
    parts = []
    for lo in range(0, total, chunk):
        c = idx[lo : lo + chunk]
        c = np.concatenate([c, np.full(chunk - len(c), -1)])
        parts.append(c.reshape(nd, B))
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


def _grey_sum_to_f32(grey_u8: torch.Tensor, res_u8: torch.Tensor, n: int,
                     h: int, w: int) -> torch.Tensor:
    """Exact channel-sum grey: [N*H, W] u8 grey and {0,1,2} residual ->
    [N, H, W] f32 mean of channels (r + g + b == 3 * grey + res - 1, in
    integers), the value ``grey_u8`` gives on the RGB stack."""
    s = 3 * grey_u8.to(torch.int32) + res_u8.to(torch.int32) - 1
    return (s.to(torch.float32) / (3.0 * 255.0)).reshape(n, h, w)


def _planar_rows_to_f32(rows_u8: torch.Tensor, n: int, h: int,
                        w: int) -> torch.Tensor:
    """[3*N*H, W] u8 channel-planar rows -> [N, H, W, 3] f32 in [0, 1]."""
    planar = rows_u8.reshape(3, n, h, w)
    return planar.permute(1, 2, 3, 0).to(torch.float32) / 255.0


def _chroma_rows_to_f32(grey_u8: torch.Tensor, res_u8: torch.Tensor,
                        chroma_rows: torch.Tensor, n: int, h: int,
                        w: int) -> torch.Tensor:
    """Exact RGB from the grey and residual planes (on the device since the
    features) and the two chroma planes ([2*N*H, W] u8, red less grey rows
    then blue less grey, mod 256): r = (grey + cr) mod 256, b = (grey + cb)
    mod 256, g = (r + g + b) - r - b.  Integers throughout, so the result
    equals the plain upload's u8 / 255 bit for bit."""
    g32 = grey_u8.to(torch.int32)
    s = 3 * g32 + res_u8.to(torch.int32) - 1
    cr = chroma_rows[: n * h].to(torch.int32)
    cb = chroma_rows[n * h :].to(torch.int32)
    r = (g32 + cr) & 0xFF
    b = (g32 + cb) & 0xFF
    g = s - r - b
    rgb = torch.stack([r, g, b], dim=0).to(torch.float32) / 255.0
    return rgb.reshape(3, n, h, w).permute(1, 2, 3, 0)


class DeferredImages:
    """An f32 [N, H, W, 3] image stack whose upload may still be running:
    the chroma planes stream in a ``BackgroundUpload`` thread (encoded
    since upload time, sent once ``start_background`` releases them) and
    ``get()`` joins it and rebuilds the stack on the device.  If the
    wrapper is dropped before ``get()``, its finalizer abandons the
    thread."""

    def __init__(self, bg, n: int, h: int, w: int, device: torch.device,
                 dev_grey: torch.Tensor | None = None,
                 dev_res: torch.Tensor | None = None):
        self._bg = bg
        self.shape = (n, h, w, 3)
        self.dtype = torch.float32
        self.device = device
        self._grey = dev_grey
        self._res = dev_res
        self._imgs = None
        weakref.finalize(self, bg.abandon)

    def start_background(self):
        """Let the chroma stream onto the link (the stitcher calls it once
        the features are on the host)."""
        if self._bg is not None:
            self._bg.release_wire()

    def get(self) -> torch.Tensor:
        if self._imgs is None:
            rows = self._bg.result()
            n, h, w, _ = self.shape
            if self._grey is not None:
                self._imgs = _chroma_rows_to_f32(self._grey, self._res, rows,
                                                 n, h, w)
            else:
                self._imgs = _planar_rows_to_f32(rows, n, h, w)
            self._bg = None
            self._grey = self._res = None
        return self._imgs


def grey_chunk() -> int:
    """Views per grey upload chunk: ``OPENPANO_GREY_CHUNK``, 8 by default."""
    return max(int(os.environ.get("OPENPANO_GREY_CHUNK", "8")), 1)


def _grey_features(grey8: np.ndarray, res: np.ndarray, cfg: Config,
                   dev: torch.device):
    """Upload the grey and residual planes in chunks of ``grey_chunk()``
    views and run the detector over them in batches of ``feature_batch()``.
    Returns ([(grey rows, residual rows)] per chunk on ``dev``, Features);
    raises when an image has no feature."""
    from ..io import wirecodec

    n, h, w = grey8.shape
    CH, B = grey_chunk(), feature_batch()
    grey_parts, feat_parts, pending = [], [], []
    for lo in range(0, n, CH):
        hi = min(lo + CH, n)
        with span("features.upload"):
            dg = wirecodec.upload_u8_rows(grey8[lo:hi].reshape(-1, w), dev)
            dr = wirecodec.upload_2bit_rows(res[lo:hi].reshape(-1, w), dev)
            grey_parts.append((dg, dr))
            pending.extend(_grey_sum_to_f32(dg, dr, hi - lo, h, w).unbind(0))
        while len(pending) >= B or (hi == n and pending):
            batch = torch.stack(pending[:B])
            del pending[:B]
            feat_parts.append(_batch_features(batch, cfg, w, h))
    feats = Features(*(torch.cat(f, dim=0) for f in zip(*feat_parts)))
    _check_counts(feats)
    return grey_parts, feats


def upload_and_compute_features(host_u8: np.ndarray, cfg: Config,
                                rgb_stream: bool = True, device=None):
    """The transport's upload and the features (the JAX package's
    ``upload_and_compute_features``; module docstring).

    host_u8: [N, H, W, 3] uint8 in host memory.  The grey and residual
    planes upload in chunks of ``grey_chunk()`` views (4-bit codec and
    2-bit planes) and become the exact f32 grey; the detector runs on them
    in the batches of ``feature_batch()`` views that :func:`compute_features`
    takes, so the features equal its features bit for bit.  With
    ``rgb_stream`` the chroma planes are encoded in a ``BackgroundUpload``
    thread (2-bit codec) whose copies wait for ``start_background``;
    without it nothing more is uploaded and the stack stays in host memory
    (``HostImages``, the path of stacks past the device budget).  ``device``:
    the card unless another is named.

    Returns (DeferredImages | HostImages, Features)."""
    from ..io import wirecodec
    from .. import native
    from .stitcher import resolve_device

    dev = resolve_device(device)
    n, h, w = host_u8.shape[0], host_u8.shape[1], host_u8.shape[2]
    t0 = time.perf_counter()
    with span("features.encode"):
        grey8, res = native.wire_grey_res_u8(host_u8)  # [N, H, W] u8 each
    wirecodec.count(encode_s=time.perf_counter() - t0)
    g8_rows = grey8.reshape(n * h, w)

    def _chroma():
        t0 = time.perf_counter()
        cr = (host_u8[..., 0].reshape(n * h, w).astype(np.int16)
              - g8_rows) & 0xFF
        cb = (host_u8[..., 2].reshape(n * h, w).astype(np.int16)
              - g8_rows) & 0xFF
        out = np.concatenate([cr, cb], axis=0).astype(np.uint8)
        wirecodec.count(encode_s=time.perf_counter() - t0)
        return out

    if rgb_stream:
        bg = wirecodec.BackgroundUpload(_chroma, gate_wire=True, bits=2,
                                        device=dev)
    try:
        grey_parts, feats = _grey_features(grey8, res, cfg, dev)
    except BaseException:
        if rgb_stream:
            bg.abandon()
        raise
    if not rgb_stream:
        return HostImages(host_u8, dev), feats
    dev_grey = torch.cat([g for g, _ in grey_parts], dim=0)
    dev_res = torch.cat([r for _, r in grey_parts], dim=0)
    return DeferredImages(bg, n, h, w, dev, dev_grey, dev_res), feats
