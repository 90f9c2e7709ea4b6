"""The lossless 4-bit / 2-bit wire codec: host C encoder and device decoder
for uploads, device encoder and host C decoder for downloads.

Counterpart of ``openpano_tpu/io/wirecodec.py``, built there for a slow
host link to the accelerator; the format and the results are the same:

- a [rows, cols] u8 plane codes as left-neighbour deltas mod 256 along each
  row; deltas in [-8, 7] pack two to a byte, row r with row r + ceil(R/2)
  (2-bit: [-2, 1], four to a byte, quarter-row pairing), so the device
  unpack is a concatenation;
- out-of-range deltas ride a sparse exception stream, gap-coded to u16
  (with 0xFFFF escapes for gaps of 65535 or more) plus a u8 value.

Uploads (``upload_u8_rows``, ``upload_2bit_rows``, ``BackgroundUpload``)
encode on the host (``native.wire_pack4`` / ``wire_pack2``) and decode on
the device (``_decode4``: unpack, scatter the exceptions, row prefix sum mod
256).  Downloads (``CodedFetch``) encode on the device
(``encode_plane_device``: one int32 wire buffer with the packed plane, an
inline exception prefix and the count, plus the sorted exception buffer),
copy asynchronously to pinned host memory, and decode on the host in C
(``native.wire_unpack``).  The device side is plain torch, as it is XLA
code there.  On the CPU the same code runs with plain copies: no pinned
memory, no streams.

``STATS`` counts what the codec moved, for the chip run's report: the bytes
on the link each way and the bytes of the planes they carried (of the bytes
up, ``bg_up_bytes`` went in a ``BackgroundUpload``), and the seconds of host
encode and decode (from every thread).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .transfer import HostCopy, fetch

_ESC = 0xFFFF  # gap escape: advance 65535, write nothing

STATS: dict[str, float] = {}
_stats_lock = threading.Lock()


def reset_stats():
    with _stats_lock:
        STATS.update(up_bytes=0, up_plain_bytes=0, bg_up_bytes=0,
                     down_bytes=0, down_plain_bytes=0, encode_s=0.0,
                     decode_s=0.0)


def count(**amounts):
    """Add ``amounts`` to ``STATS``."""
    with _stats_lock:
        for k, v in amounts.items():
            STATS[k] += v


reset_stats()


@dataclass(frozen=True)
class WireStream:
    """Host-side encoded plane ([rows, cols] u8)."""

    packed: np.ndarray  # [ceil(rows/2), cols] u8 (4-bit) / ceil(rows/4) (2-bit)
    gaps: np.ndarray  # [K] u16 (0xFFFF = escape)
    vals: np.ndarray  # [K] u8 (delta byte; 0 for escapes)
    rows: int
    cols: int
    bits: int = 4

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.gaps.nbytes + self.vals.nbytes


def _gap_code(idx: np.ndarray, val: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted absolute indices -> u16 gap stream with 0xFFFF escapes."""
    if idx.size == 0:
        return np.zeros(0, np.uint16), np.zeros(0, np.uint8)
    D = np.diff(idx, prepend=np.int64(-1))  # >= 1
    m = (D - 1) // 65535  # escapes before each real entry
    g = (D - 1) - m * 65535  # residual gap, <= 65534
    total = int(idx.size + m.sum())
    gaps = np.full(total, _ESC, np.uint16)
    vals = np.zeros(total, np.uint8)
    pos = np.cumsum(m + 1) - 1
    gaps[pos] = g.astype(np.uint16)
    vals[pos] = val
    return gaps, vals


def encode_plane(plane: np.ndarray, bits: int = 4) -> WireStream | None:
    """Encode a [rows, cols] u8 plane (``bits=2``: the quarter-row variant
    for planes of tiny deltas).  None when the content is too noisy for the
    bit budget: the caller moves the plane raw."""
    rows, cols = plane.shape
    t0 = time.perf_counter()
    out = (native.wire_pack4 if bits == 4 else native.wire_pack2)(plane)
    if out is not None:
        gaps, vals = _gap_code(out[1], out[2])
    count(encode_s=time.perf_counter() - t0)
    if out is None:
        return None
    packed = out[0]
    return WireStream(packed=packed, gaps=gaps, vals=vals, rows=rows,
                      cols=cols, bits=bits)


def _bucket(n: int) -> int:
    """Round K up to a power of two from 1024 (the JAX package limits its
    compiled decode shapes so; kept for the same buffers)."""
    b = 1024
    while b < n:
        b *= 2
    return b


def _decode4(packed: torch.Tensor, gaps: torch.Tensor, vals: torch.Tensor,
             rows: int, cols: int, bits: int = 4) -> torch.Tensor:
    """Device decode: packed [ceil(rows/g), cols] u8, gaps [K] (u16 values
    as int16 or wider), vals [K] u8 -> [rows, cols] u8.  Exceptions past
    the plane (the escapes) are dropped."""
    if bits == 4:
        parts = [packed & 0xF, packed >> 4]
        bias = 8
    else:
        parts = [(packed >> sh) & 3 for sh in (0, 2, 4, 6)]
        bias = 2
    delta = torch.cat(parts, dim=0)[:rows].to(torch.int32) - bias
    g = gaps.to(torch.int64) & 0xFFFF
    is_esc = g == _ESC
    pos = torch.cumsum(torch.where(is_esc, 65535, g + 1), dim=0) - 1
    size = rows * cols
    # one spare slot takes every dropped write
    write_idx = torch.where(is_esc | (pos >= size), size, pos)
    sval = ((vals.to(torch.int32) + 128) % 256) - 128
    flat = torch.cat([delta.reshape(-1), delta.new_zeros(1)])
    flat = flat.scatter(0, write_idx, sval)[:size]
    out = torch.cumsum(flat.reshape(rows, cols), dim=1,
                       dtype=torch.int32) & 0xFF
    return out.to(torch.uint8)


def _pad_exceptions(stream: WireStream) -> tuple[np.ndarray, np.ndarray]:
    k = _bucket(max(1, stream.gaps.size))
    gaps = np.full(k, _ESC, np.uint16)
    vals = np.zeros(k, np.uint8)
    gaps[: stream.gaps.size] = stream.gaps
    vals[: stream.vals.size] = stream.vals
    return gaps, vals


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` (u16 moves as int16 bits)."""
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _device(device) -> torch.device:
    """``device`` resolved (the card unless another is named), a card with
    its index, as streams and ``set_device`` need it."""
    from ..stitch.stitcher import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload_plane(stream: WireStream, device=None) -> torch.Tensor:
    """Upload and decode an encoded plane -> u8 [rows, cols] on ``device``
    (the card unless another is named)."""
    dev = _device(device)
    gaps, vals = _pad_exceptions(stream)
    count(up_bytes=stream.packed.nbytes + gaps.nbytes + vals.nbytes,
          up_plain_bytes=stream.rows * stream.cols)
    return _decode4(_put(stream.packed, dev), _put(gaps, dev),
                    _put(vals, dev), stream.rows, stream.cols, stream.bits)


def upload_u8_rows(plane: np.ndarray, device=None) -> torch.Tensor:
    """Upload a [rows, cols] u8 plane through the 4-bit codec, or raw when
    the content defeats its budget."""
    stream = encode_plane(plane)
    if stream is None:
        count(up_bytes=plane.nbytes, up_plain_bytes=plane.nbytes)
        return _put(plane, _device(device))
    return upload_plane(stream, device)


def pack2_rows(plane: np.ndarray) -> np.ndarray:
    """Pack a [rows, cols] plane of 2-bit values ({0,1,2,3}) four to a byte,
    quarter-row pairing (row r with r+Q, r+2Q, r+3Q; Q = ceil(rows/4)), so
    the device unpack is a concatenation.  Missing rows pad with 1 (the
    bias value for residual 0)."""
    rows, cols = plane.shape
    q = (rows + 3) // 4
    if q * 4 != rows:
        pad = np.ones((q * 4 - rows, cols), np.uint8)
        plane = np.concatenate([plane, pad], axis=0)
    return (
        plane[:q]
        | (plane[q : 2 * q] << 2)
        | (plane[2 * q : 3 * q] << 4)
        | (plane[3 * q :] << 6)
    ).astype(np.uint8)


def _unpack2(packed: torch.Tensor, rows: int) -> torch.Tensor:
    parts = [(packed >> s) & 3 for s in (0, 2, 4, 6)]
    return torch.cat(parts, dim=0)[:rows]


def upload_2bit_rows(plane: np.ndarray, device=None) -> torch.Tensor:
    """Upload a [rows, cols] plane of 2-bit values at 0.25 bytes an element;
    returns u8 [rows, cols] on ``device``."""
    packed = pack2_rows(plane)
    count(up_bytes=packed.nbytes, up_plain_bytes=plane.size)
    return _unpack2(_put(packed, _device(device)), plane.shape[0])


class BackgroundUpload:
    """An upload (encode, chunked host-to-device copies) run in a daemon
    thread, so that the transfer of an input needed late (the full-resolution
    chroma, needed only by the blend) overlaps the earlier stages.  The
    chunks are ``CHUNK_BYTES`` each; on the card each goes from a pinned
    buffer on the thread's own stream, and the thread waits for it to land
    before it sends the next, so the main thread's small copies interleave.
    The decode runs in :meth:`result` on the caller's stream, after it waits
    for the thread's last copy.  An error in the thread re-raises in
    :meth:`result`.

    The reference's LAZY_READ IO / compute overlap (stitcherbase.cc:14-19,
    imageref.hh:22)."""

    CHUNK_BYTES = 4 << 20

    def __init__(self, plane, gate_wire: bool = False, bits: int = 4,
                 device=None):
        """``plane``: a [rows, cols] u8 array, or a callable with no
        argument returning one (the host preparation then runs in the
        thread too).  ``bits``: the codec variant.  ``gate_wire=True`` holds
        the copies (not the encode) until :meth:`release_wire`."""
        self._plane = plane
        self._bits = bits
        self._device = _device(device)
        self._result = None
        self._error: BaseException | None = None
        self._abandoned = False
        self._wire_gate = threading.Event()
        if not gate_wire:
            self._wire_gate.set()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def release_wire(self):
        """Let the chunked copies start (no-op if already released)."""
        self._wire_gate.set()

    def abandon(self):
        """Drop the upload: wake a gated thread and have it end without
        copying.  A holder that may be dropped before :meth:`result`
        registers this as its finalizer, so a gated thread never parks
        forever holding its encoded stream."""
        self._abandoned = True
        self._wire_gate.set()

    def _run(self):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                self._stream = torch.cuda.Stream(self._device)
            plane = self._plane() if callable(self._plane) else self._plane
            stream = encode_plane(plane, bits=self._bits)
            self._wire_gate.wait()
            if self._abandoned:
                self._error = RuntimeError("BackgroundUpload abandoned")
                return
            if stream is None:
                count(up_bytes=plane.nbytes, up_plain_bytes=plane.nbytes,
                      bg_up_bytes=plane.nbytes)
                self._result = ("raw", self._chunked_put(plane), plane.shape)
                return
            gaps, vals = _pad_exceptions(stream)
            wire = stream.packed.nbytes + gaps.nbytes + vals.nbytes
            count(up_bytes=wire, up_plain_bytes=stream.rows * stream.cols,
                  bg_up_bytes=wire)
            parts = self._chunked_put(stream.packed)
            dg, dv = self._chunked_put(gaps)[0], self._chunked_put(vals)[0]
            self._result = ("packed", parts, dg, dv, stream.rows,
                            stream.cols, stream.bits)
        except BaseException as e:  # re-raised by result()
            self._error = e
        finally:
            self._plane = None

    def _chunked_put(self, arr: np.ndarray) -> list[torch.Tensor]:
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        if arr.ndim == 1:
            arr = arr[None]
        rows_per = max(1, self.CHUNK_BYTES // max(1, arr.shape[1]))
        parts = []
        for lo in range(0, arr.shape[0], rows_per):
            src = torch.from_numpy(np.ascontiguousarray(arr[lo:lo + rows_per]))
            if self._device.type == "cuda":
                pinned = src.pin_memory()
                with torch.cuda.stream(self._stream):
                    part = pinned.to(self._device, non_blocking=True)
                # the chunk lands (and its pinned source is free) before
                # the next is sent
                self._stream.synchronize()
            else:
                part = src.clone()
            parts.append(part)
        return parts

    def result(self) -> torch.Tensor:
        """Join and return the decoded u8 [rows, cols] tensor."""
        self._wire_gate.set()  # never deadlock on an unreleased gate
        self._thread.join()
        if self._error is not None:
            raise self._error
        r, self._result = self._result, None  # the caller holds the data
        parts = r[1] + (list(r[2:4]) if r[0] == "packed" else [])
        if self._device.type == "cuda":
            # the thread's copies are done (it synchronised its stream);
            # tell the allocator that the caller's stream now uses them
            cur = torch.cuda.current_stream(self._device)
            cur.wait_stream(self._stream)
            for p in parts:
                p.record_stream(cur)
        if r[0] == "raw":
            return torch.cat(r[1], dim=0).reshape(r[2])
        _, chunks, dg, dv, rows, cols, bits = r
        packed = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        return _decode4(packed, dg[0], dv[0], rows, cols, bits)


# ---- download direction: device encode, host C decode ----

# planes larger than this cannot pack (idx << 8 | val) into a positive
# int32; CodedFetch cuts them into row chunks
_MAX_PLANE = 1 << 23


def encode_plane_device(plane: torch.Tensor, cap: int, bits: int = 4,
                        inline_exc: int = 0):
    """Encode a [R, C] u8 plane on its device (R * C < 2**23) into one int32
    wire buffer and a sorted exception buffer.

    Returns (wire int32, exc int32 [cap]): ``wire`` is the packed plane's
    bytes viewed as int32, then the first ``inline_exc`` exception entries,
    then the exception count; ``exc[k] = (flat_idx << 8) | delta_byte`` for
    the k-th exception in flat order (compacted by a sort).  n > inline_exc
    needs a second copy from ``exc``; n > cap means even that is cut short,
    and the caller moves the plane raw.  Every integer is int32, the count
    included: a wider count would change the wire's layout."""
    bias, lim, group = (8, 16, 2) if bits == 4 else (2, 4, 4)
    R, C = plane.shape
    x = plane.to(torch.int32)
    d = torch.cat([x[:, :1], (x[:, 1:] - x[:, :-1]) & 0xFF], dim=1)
    s = (d + bias) & 0xFF
    exc = s >= lim
    nib = torch.where(exc, bias, s)
    gl = (R + group - 1) // group
    if gl * group != R:
        nib = torch.cat([nib, nib.new_full((gl * group - R, C), bias)])
    packed = nib[:gl]
    for k in range(1, group):
        packed = packed | (nib[k * gl:(k + 1) * gl] << (k * (8 // group)))
    flat = exc.reshape(-1)
    n = flat.sum(dtype=torch.int32)
    iota = torch.arange(flat.numel(), dtype=torch.int32, device=plane.device)
    key = torch.where(flat, (iota << 8) | (d.reshape(-1) & 0xFF),
                      2**31 - 1).to(torch.int32)
    exc_buf = torch.sort(key).values[:cap]
    pflat = packed.to(torch.uint8).reshape(-1)
    pad = (-pflat.numel()) % 4
    if pad:
        pflat = torch.cat([pflat, pflat.new_zeros(pad)])
    wire = pflat.view(torch.int32)
    tail = [exc_buf[:inline_exc], n[None]] if inline_exc else [n[None]]
    return torch.cat([wire] + tail), exc_buf


def _exc_bucket(n: int) -> int:
    """Round the exception count up to a power of two from 4096."""
    b = 4096
    while b < n:
        b *= 2
    return b


class _CodedPlaneFetch:
    """One plane's asynchronous coded download (R * C < 2**23)."""

    def __init__(self, plane: torch.Tensor, cap: int, bits: int):
        self._plane = plane
        R, C = plane.shape
        self._rows, self._cols = int(R), int(C)
        # a slice cannot exceed the key buffer, so cap and the inline
        # prefix clamp to the element count (else the wire layout shifts
        # on tiny planes)
        self._cap = min(int(cap), int(plane.numel()))
        self._bits = bits
        # inline exceptions: 2% of the elements
        self._inline = min(self._cap, max(8192, int(plane.numel()) // 48))
        wire, self._exc = encode_plane_device(
            plane, cap=self._cap, bits=bits, inline_exc=self._inline)
        self._copy = HostCopy(wire)

    def wait(self) -> np.ndarray:
        wire = self._copy.wait()
        n = int(wire[-1])
        size = self._rows * self._cols
        count(down_bytes=wire.nbytes, down_plain_bytes=size)
        if n > self._cap:  # the content defeated the nibble budget
            out = fetch(self._plane)
            count(down_bytes=size)
            self._plane = self._exc = None
            return out
        if n <= self._inline:
            exc = wire[-1 - self._inline: -1][:n]
        else:  # exceptions past the inline prefix: a second copy
            k = min(_exc_bucket(n), self._cap)
            exc = self._exc[:k].cpu().numpy()[:n]
            count(down_bytes=exc.nbytes)
        packed = np.ascontiguousarray(
            wire[: wire.size - 1 - self._inline]).view(np.uint8)
        group = 2 if self._bits == 4 else 4
        gl = (self._rows + group - 1) // group
        packed = packed[: gl * self._cols].reshape(gl, self._cols)
        idx = (exc >> 8).astype(np.int64)
        val = (exc & 0xFF).astype(np.uint8)
        self._plane = self._exc = None
        t0 = time.perf_counter()
        out = native.wire_unpack(packed, self._rows, self._cols, idx, val,
                                 bits=self._bits)
        count(decode_s=time.perf_counter() - t0)
        return out


class CodedFetch:
    """Asynchronous device -> host download of a u8 [R, C] plane through the
    download codec: the device packs 4-bit row deltas and a sorted
    exception stream (``encode_plane_device``), one asynchronous copy
    carries the packed plane, the inline exceptions and the count, and
    ``wait()`` decodes in threaded C (``native.wire_unpack``).  Planes of
    2**23 elements or more go in row chunks, so that exception indices fit
    the int32 packing; a chunk too noisy for the cap moves raw."""

    def __init__(self, plane: torch.Tensor, cap: int | None = None,
                 bits: int = 4):
        R, C = int(plane.shape[0]), int(plane.shape[1])
        rows_per = max(1, min(R, _MAX_PLANE // max(C, 1)))
        self._parts = []
        for lo in range(0, R, rows_per):
            chunk = plane[lo: lo + rows_per]
            ccap = cap if cap is not None else max(
                4096, int(chunk.shape[0] * C) // 12)
            self._parts.append(_CodedPlaneFetch(chunk, cap=ccap, bits=bits))

    def wait(self) -> np.ndarray:
        out = [p.wait() for p in self._parts]
        self._parts = []
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)
