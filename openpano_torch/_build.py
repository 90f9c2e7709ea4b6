"""Build and load the package's native code at first use.

Two kinds of library, both with a plain C interface loaded through ctypes:

- CUDA kernels, ``csrc/<name>.cu``, compiled by ``nvcc`` for Hopper
  (``sm_90a``).  There is no fallback: a caller that needs a kernel on the
  card gets it or an error.
- Host code at the repository root, compiled by the host C compiler: the
  crop DP (``native/crop_largest_rect.c``) and the PNG codec
  (``native/png_codec.c``, linked with zlib).

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
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
CSRC = _PKG / "csrc"
NATIVE = _PKG.parent / "native"
CROP_SRC = NATIVE / "crop_largest_rect.c"
PNG_SRC = NATIVE / "png_codec.c"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


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
    if "crop" not in _loaded:
        lib = _host_library(CROP_SRC)
        lib.largest_valid_rect.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.largest_valid_rect.restype = None
        _loaded["crop"] = lib
    return _loaded["crop"]


def png_library() -> ctypes.CDLL:
    """``native/png_codec.c`` (zlib-backed PNG decode and encode), built
    with the host C compiler."""
    if "png" not in _loaded:
        lib = _host_library(PNG_SRC, ("-lz",))
        lib.png_decode_rgb8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
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
