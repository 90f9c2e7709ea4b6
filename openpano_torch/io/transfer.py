"""Device <-> host copies of the transport.

Counterpart of ``openpano_tpu/io/transfer.py``.  ``fetch`` moves a device
tensor to a host ndarray of the same shape and dtype in one copy; the
row-delta pair ``fetch_u8_delta`` / ``device_put_u8_delta`` codes u8 rows
as their left differences mod 256 on one side and undoes it on the other.

On the card the copy lands in a pinned host buffer asynchronously, and an
event waits for it; on the CPU there is no copy to wait for.
:class:`HostCopy` is that asynchronous copy for one tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native

_DEFAULT_CHUNKS = 16


class HostCopy:
    """An asynchronous copy of ``t`` to host memory, started at
    construction on the current stream: into a pinned buffer with an event
    behind it on the card, a plain reference on the CPU.  ``wait()``
    returns the host ndarray once the copy has landed."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        self._host = self._event = None
        return out


def _delta_rows(u8_2d: torch.Tensor) -> torch.Tensor:
    """Row-wise horizontal delta (mod 256) of a [R, C] uint8 plane."""
    x = u8_2d.to(torch.int32)
    d = torch.cat([x[:, :1], (x[:, 1:] - x[:, :-1]) & 0xFF], dim=1)
    return d.to(torch.uint8)


def _undelta_rows(u8_2d: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_delta_rows` (prefix sum mod 256 along rows)."""
    x = u8_2d.to(torch.int32)
    return (torch.cumsum(x, dim=1, dtype=torch.int32) & 0xFF).to(torch.uint8)


def _delta_rows_shape(shape) -> tuple[int, int]:
    """Delta runs along image rows: [..., H, W, C] -> (.*H, W*C) planes."""
    if len(shape) >= 3:
        return int(np.prod(shape[:-2])), int(shape[-2] * shape[-1])
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    return 1, int(np.prod(shape))


def fetch_u8_delta(arr: torch.Tensor, chunks: int = _DEFAULT_CHUNKS
                   ) -> np.ndarray:
    """Device -> host copy of a uint8 tensor by row-delta coding: the delta
    plane is made on the device and undone on the host (``native.
    delta_decode_rows``); deltas run along image rows (the last two
    axes)."""
    shape = tuple(arr.shape)
    d = _delta_rows(arr.reshape(_delta_rows_shape(shape)))
    return native.delta_decode_rows(fetch(d, chunks)).reshape(shape)


def device_put_u8_delta(arr: np.ndarray, device=None) -> torch.Tensor:
    """Host -> device upload of uint8 data by row-delta coding (the deltas
    made on the host by ``native.delta_encode_rows``, the prefix sum on the
    device).  Returns a tensor of the same shape on ``device`` (the card
    unless another is named)."""
    from ..stitch.stitcher import resolve_device

    shape = arr.shape
    d = native.delta_encode_rows(np.asarray(arr).reshape(
        _delta_rows_shape(shape)))
    dev = torch.from_numpy(d).to(resolve_device(device))
    return _undelta_rows(dev).reshape(shape)


def fetch(arr, chunks: int = _DEFAULT_CHUNKS) -> np.ndarray:
    """Device -> host copy of ``arr`` (a host ndarray comes back as it is):
    one :class:`HostCopy`.  Returns a host ndarray of the same shape and
    dtype.  ``chunks`` keeps the JAX package's signature and is unused: the
    JAX package splits the copy for its element-bound TPU link, and no
    measurement on the card shows a gain from splitting."""
    if isinstance(arr, np.ndarray):
        return arr
    host = HostCopy(arr).wait()
    return host if arr.device.type == "cuda" else host.copy()
