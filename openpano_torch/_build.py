"""Build and load the package's native code at first use.

Two kinds of library, both with a plain C interface loaded through ctypes:

- CUDA kernels, ``csrc/<name>.cu``, compiled by ``nvcc`` for Hopper
  (``sm_90a``).  There is no fallback: a caller that needs a kernel on the
  card gets it or an error.
- Host code, compiled by the host C compiler: at the repository root the
  crop DP (``native/crop_largest_rect.c``), the PNG codec
  (``native/png_codec.c``, linked with zlib), and the threaded transport
  codecs (``native/wire_codec.c``, the 4-bit / 2-bit wire codec, and
  ``native/delta_code.c``, row deltas; both linked with pthreads); in the
  package the bundle adjustment's per-iteration problem
  (``csrc/ba_pairs.c``, one thread, linked with libm).  A host library
  that does not build raises: nothing falls back to Python.

Loading is serialised by a lock: the transport's background upload thread
may load the wire codec while the main thread loads another library.
Libraries land in ``openpano_torch/_build/`` (git-ignored), named by a hash
of their source and flags, so an edited source is rebuilt and a stale one is
never loaded.  A build writes a temporary file and renames it into place;
the compiler's output lands beside it (``<library>.log``: for a CUDA source,
ptxas's registers, shared memory and spills per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
CSRC = _PKG / "csrc"
NATIVE = _PKG.parent / "native"
CROP_SRC = NATIVE / "crop_largest_rect.c"
PNG_SRC = NATIVE / "png_codec.c"
WIRE_SRC = NATIVE / "wire_codec.c"
DELTA_SRC = NATIVE / "delta_code.c"
BA_PAIRS_SRC = CSRC / "ba_pairs.c"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()


def _target(src: Path, flags: tuple[str, ...]) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{h[:16]}.so"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels of openpano_torch are built from source at first use")
    return found


def _compile(cmd: list[str], out: Path, what: str) -> Path:
    """Run one compiler command into a temporary file, then rename it to
    ``out``; raise with the compiler's log if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out


def build_cuda(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path."""
    src = CSRC / f"{name}.cu"
    out = _target(src, NVCC_FLAGS)
    if out.exists():
        return out
    return _compile([nvcc_path(), *NVCC_FLAGS, str(src)], out,
                    f"csrc/{name}.cu")


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build_cuda(name)))
        return _loaded[name]


def _host_library(src: Path, libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """``src`` built with the host C compiler (and linked with ``libs``)
    into a shared library, loaded."""
    flags = CC_FLAGS + libs
    out = _target(src, flags)
    if not out.exists():
        cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
        if cc is None:
            raise RuntimeError(f"no C compiler found for {src.name}")
        _compile([cc, *CC_FLAGS, str(src), *libs], out, str(src))
    return ctypes.CDLL(str(out))


def crop_library() -> ctypes.CDLL:
    """``native/crop_largest_rect.c``, built with the host C compiler."""
    with _lock:
        if "crop" not in _loaded:
            lib = _host_library(CROP_SRC)
            lib.largest_valid_rect.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.largest_valid_rect.restype = None
            _loaded["crop"] = lib
        return _loaded["crop"]


def png_library() -> ctypes.CDLL:
    """``native/png_codec.c`` (zlib-backed PNG decode and encode), built
    with the host C compiler."""
    with _lock:
        if "png" not in _loaded:
            lib = _host_library(PNG_SRC, ("-lz",))
            lib.png_decode_rgb8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.png_decode_rgb8.restype = ctypes.c_void_p
            lib.png_encode_rgb8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.png_encode_rgb8.restype = ctypes.c_void_p
            lib.pano_free.argtypes = [ctypes.c_void_p]
            lib.pano_free.restype = None
            _loaded["png"] = lib
        return _loaded["png"]


def wire_library() -> ctypes.CDLL:
    """``native/wire_codec.c`` (the threaded 4-bit / 2-bit wire codec, the
    grey + residual split and the download decoder), built with the host C
    compiler."""
    with _lock:
        if "wire" not in _loaded:
            lib = _host_library(WIRE_SRC, ("-lpthread",))
            pack = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int]
            for fn in (lib.wire_pack4, lib.wire_pack2):
                fn.argtypes = pack
                fn.restype = ctypes.c_int64
            lib.wire_grey_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int]
            lib.wire_grey_u8.restype = None
            lib.wire_grey_res_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int]
            lib.wire_grey_res_u8.restype = None
            lib.wire_unpack.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.wire_unpack.restype = None
            _loaded["wire"] = lib
        return _loaded["wire"]


def delta_library() -> ctypes.CDLL:
    """``native/delta_code.c`` (threaded row deltas mod 256 and their
    prefix sums), built with the host C compiler."""
    with _lock:
        if "delta" not in _loaded:
            lib = _host_library(DELTA_SRC, ("-lpthread",))
            for fn in (lib.delta_encode_rows, lib.delta_decode_rows):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
                fn.restype = None
            _loaded["delta"] = lib
        return _loaded["delta"]


def ba_pairs_library() -> ctypes.CDLL:
    """``csrc/ba_pairs.c`` (the pair-major LM's residuals and normal
    equations), built with the host C compiler."""
    with _lock:
        if "ba_pairs" not in _loaded:
            _loaded["ba_pairs"] = _host_library(BA_PAIRS_SRC, ("-lm",))
        return _loaded["ba_pairs"]
