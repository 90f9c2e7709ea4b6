"""The transport's host codecs: ctypes entry points of ``native/wire_codec.c``
and ``native/delta_code.c``, with their plain numpy versions.

Counterpart of the wire and delta entry points of ``openpano_tpu/native.py``
(same names, arguments and results).  The C libraries are built at first use
by ``_build.wire_library`` / ``_build.delta_library``; a failed build raises.
The plain versions (``*_plain``) compute the same results in numpy and exist
so that the tests can hold the C against them; no entry point falls back to
them.
"""

from __future__ import annotations

import os

import numpy as np

from . import _build


def _nthreads() -> int:
    return min(16, os.cpu_count() or 1)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def delta_encode_rows(src: np.ndarray) -> np.ndarray:
    """Row-wise horizontal delta (mod 256) of a 2-D uint8 plane."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    rows, cols = src.shape
    dst = np.empty_like(src)
    _build.delta_library().delta_encode_rows(_ptr(src), _ptr(dst), rows, cols,
                                             _nthreads())
    return dst


def delta_decode_rows(src: np.ndarray) -> np.ndarray:
    """Inverse of :func:`delta_encode_rows` (prefix sum mod 256 along
    rows)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    rows, cols = src.shape
    dst = np.empty_like(src)
    _build.delta_library().delta_decode_rows(_ptr(src), _ptr(dst), rows, cols,
                                             _nthreads())
    return dst


def delta_encode_rows_plain(src: np.ndarray) -> np.ndarray:
    x = np.asarray(src, np.uint8).astype(np.int16)
    return np.concatenate([x[:, :1], (x[:, 1:] - x[:, :-1]) & 0xFF],
                          axis=1).astype(np.uint8)


def delta_decode_rows_plain(src: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(src, np.uint8).astype(np.int64),
                     axis=1).astype(np.uint8)


def wire_pack4(plane: np.ndarray, exc_frac: float = 0.12):
    """4-bit nibble-delta pack of a [rows, cols] u8 plane.

    Returns (packed [ceil(rows/2), cols] u8, exc_idx int64 [K] sorted,
    exc_val u8 [K]), or None when the exceptions overflow ``exc_frac`` of the
    elements (each C thread holds an equal share of that budget): the caller
    then moves the plane raw."""
    return _wire_pack(plane, exc_frac, bits=4)


def wire_pack2(plane: np.ndarray, exc_frac: float = 0.12):
    """2-bit variant of :func:`wire_pack4`: deltas in [-2, 1], four per byte,
    quarter-row pairing; for planes whose deltas are tiny (chroma against
    grey)."""
    return _wire_pack(plane, exc_frac, bits=2)


def _wire_pack(plane: np.ndarray, exc_frac: float, bits: int):
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    rows, cols = plane.shape
    group = 2 if bits == 4 else 4
    packed = np.empty(((rows + group - 1) // group, cols), np.uint8)
    cap = max(1024, int(plane.size * exc_frac))
    idx = np.empty(cap, np.int64)
    val = np.empty(cap, np.uint8)
    lib = _build.wire_library()
    fn = lib.wire_pack4 if bits == 4 else lib.wire_pack2
    n = fn(_ptr(plane), _ptr(packed), rows, cols, _ptr(idx), _ptr(val), cap,
           _nthreads())
    if n < 0:
        return None
    idx, val = idx[:n], val[:n]
    order = np.argsort(idx, kind="stable")
    return packed, idx[order], val[order]


def wire_pack_plain(plane: np.ndarray, bits: int = 4,
                    exc_frac: float = 0.12):
    """The plain version of :func:`wire_pack4` / :func:`wire_pack2` (the JAX
    package's ``_wire_pack4_py`` / ``_wire_pack2_py`` with their overflow
    rule: None past ``exc_frac`` of the elements in all)."""
    plane = np.asarray(plane, np.uint8)
    rows, cols = plane.shape
    bias, lim, group = (8, 16, 2) if bits == 4 else (2, 4, 4)
    x = plane.astype(np.int16)
    d = x.copy()
    d[:, 1:] = x[:, 1:] - x[:, :-1]
    d8 = (d & 0xFF).astype(np.uint8)
    s = (d8.astype(np.int16) + bias) & 0xFF
    ok = s < lim
    nib = np.where(ok, s, bias).astype(np.uint8)
    gl = (rows + group - 1) // group
    if gl * group != rows:
        nib = np.concatenate(
            [nib, np.full((gl * group - rows, cols), bias, np.uint8)], axis=0)
    packed = nib[:gl].copy()
    for k in range(1, group):
        packed |= nib[k * gl:(k + 1) * gl] << (k * (8 // group))
    idx = np.flatnonzero(~ok.reshape(-1)).astype(np.int64)
    if idx.size > plane.size * exc_frac:
        return None
    return packed.astype(np.uint8), idx, d8.reshape(-1)[idx]


def wire_grey_u8(rgb: np.ndarray) -> np.ndarray:
    """Rounded channel-mean grey of a u8 RGB array [..., 3] -> [...] u8
    (reference semantics: lib/imgproc.cc:237-249)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    shape = rgb.shape[:-1]
    grey = np.empty(int(np.prod(shape)), np.uint8)
    _build.wire_library().wire_grey_u8(_ptr(rgb), _ptr(grey), grey.size,
                                       _nthreads())
    return grey.reshape(shape)


def wire_grey_res_u8(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Grey (rounded channel mean) and the channel-sum residual biased to
    {0, 1, 2}: r + g + b == 3 * grey + res - 1 exactly, so the device
    rebuilds the exact channel sum from one u8 plane and one 2-bit plane."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    shape = rgb.shape[:-1]
    n = int(np.prod(shape))
    grey = np.empty(n, np.uint8)
    res = np.empty(n, np.uint8)
    _build.wire_library().wire_grey_res_u8(_ptr(rgb), _ptr(grey), _ptr(res),
                                           n, _nthreads())
    return grey.reshape(shape), res.reshape(shape)


def wire_grey_res_plain(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`wire_grey_res_u8` (its grey is
    :func:`wire_grey_u8`'s)."""
    rgb = np.asarray(rgb, np.uint8)
    s = rgb.reshape(-1, 3).astype(np.int32).sum(axis=1)
    grey = (2 * s + 3) // 6
    res = (s - 3 * grey + 1).astype(np.uint8)
    shape = rgb.shape[:-1]
    return grey.astype(np.uint8).reshape(shape), res.reshape(shape)


def wire_unpack(packed: np.ndarray, rows: int, cols: int,
                exc_idx: np.ndarray, exc_val: np.ndarray,
                bits: int = 4) -> np.ndarray:
    """Decode a device-packed delta plane (the download direction,
    ``io.wirecodec.encode_plane_device``) to [rows, cols] u8 pixels: unpack,
    apply the exceptions, prefix-sum rows mod 256."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    exc_idx = np.ascontiguousarray(exc_idx, dtype=np.int64)
    exc_val = np.ascontiguousarray(exc_val, dtype=np.uint8)
    out = np.empty((rows, cols), np.uint8)
    _build.wire_library().wire_unpack(
        _ptr(packed), rows, cols, _ptr(exc_idx), _ptr(exc_val), exc_idx.size,
        _ptr(out), bits, _nthreads())
    return out


def wire_unpack_plain(packed: np.ndarray, rows: int, cols: int,
                      exc_idx: np.ndarray, exc_val: np.ndarray,
                      bits: int = 4) -> np.ndarray:
    packed = np.asarray(packed, np.uint8)
    bias = 8 if bits == 4 else 2
    if bits == 4:
        nib = np.concatenate([packed & 0xF, packed >> 4], axis=0)
    else:
        nib = np.concatenate([(packed >> s) & 3 for s in (0, 2, 4, 6)],
                             axis=0)
    flat = ((nib[:rows].astype(np.int64) - bias) & 0xFF).reshape(-1)
    flat[np.asarray(exc_idx, np.int64)] = exc_val
    return (np.cumsum(flat.reshape(rows, cols), axis=1) & 0xFF).astype(
        np.uint8)
