"""The pair-major LM's per-iteration problem on the host, in C.

``csrc/ba_pairs.c``, built at first use by ``_build.ba_pairs_library`` with
the host C compiler, computes what the torch chain of ``bundle_adjuster``
computes for CPU tensors: the weighted residuals (``_pairs_residuals``), the
per-slot normal-equation blocks (``_rows_H_dH``, ``_project``,
``_pairs_ne_blocks``) and their slot-order assembly into JtJ / Jtb
(``assemble_scatter``), in one call each instead of some 400 small
operators an iteration.  ``bundle_adjuster.ba_optimize_pairs`` takes this
route for CPU tensors and the torch chain for any other device; a failed
build raises.  ``calls`` counts the calls into the C routine.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

calls = 0

_P, _N = ctypes.c_void_p, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    """The library, loaded and its argument types set once."""
    lib = _build.ba_pairs_library()
    lib.ba_pairs_residuals.argtypes = [_P, _N, _P, _P, _P, _P, _P, _N, _N, _P]
    lib.ba_pairs_residuals.restype = ctypes.c_int
    lib.ba_pairs_normal_equations.argtypes = ([_P, _N, _P, _P, _P, _P, _N, _N]
                                              + [_P] * 6)
    lib.ba_pairs_normal_equations.restype = ctypes.c_int
    return lib


def _f64(t: torch.Tensor, numel: int | None = None) -> torch.Tensor:
    """``t`` as a contiguous float64 CPU tensor of ``numel`` elements, or a
    ValueError: the C routine reads it by pointer."""
    if t.device.type != "cpu" or t.dtype != torch.float64:
        raise ValueError(f"a {t.dtype} tensor on {t.device}: the host LM "
                         f"takes float64 CPU tensors")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{t.numel()} values where the problem has {numel}")
    return t.contiguous()


def _done(err: int):
    global calls
    if err == -1:
        raise IndexError("a pair slot's camera index is out of range")
    if err != 0:
        raise MemoryError("ba_pairs: out of host memory")
    calls += 1


class HostPairs:
    """A pair-major problem with the swap resolved (``bundle_adjuster.
    _pairs_eff``'s five tensors), laid out once for the C routine, and the
    freeze mask ``upd`` [n_cam, 6] (0 = frozen parameter).

    Each output is a buffer of the problem's own, allocated once and
    overwritten by the next call that writes it (the LM reads each before
    its next call), so an iteration allocates nothing."""

    def __init__(self, pt_to, pt_from, wm, F, Tc, upd, n_cam: int):
        self.wm = _f64(wm)
        self.P, self.M = self.wm.shape
        self.n_cam = n_cam
        self.pt_to = _f64(pt_to, self.P * self.M * 2)
        self.pt_from = _f64(pt_from, self.P * self.M * 2)
        self.upd = _f64(upd, 6 * n_cam)
        self.F = F.to("cpu", torch.int64).contiguous()
        self.Tc = Tc.to("cpu", torch.int64).contiguous()
        if self.F.shape != (self.P,) or self.Tc.shape != (self.P,):
            raise ValueError("one from and one to camera a pair slot")
        f64 = dict(dtype=torch.float64)
        self._resid = torch.empty(self.P, self.M, 2, **f64)
        self._JtJ = torch.empty(6 * n_cam, 6 * n_cam, **f64)
        self._Jtb = torch.empty(6 * n_cam, **f64)
        self._Bp = self._bp = None

    def residuals(self, params: torch.Tensor):
        """Weighted residuals [P, M, 2] at the camera rows ``params`` ([n,
        6] or flat) and the weights [P, M], as ``_pairs_residuals``."""
        params = _f64(params, 6 * self.n_cam)
        resid = self._resid
        _done(_lib().ba_pairs_residuals(
            params.data_ptr(), self.n_cam, self.pt_to.data_ptr(),
            self.pt_from.data_ptr(), self.wm.data_ptr(), self.F.data_ptr(),
            self.Tc.data_ptr(), self.P, self.M, resid.data_ptr()))
        return resid, self.wm

    def _normal(self, params, resid, Bp, bp, JtJ, Jtb):
        params = _f64(params, 6 * self.n_cam)
        resid = _f64(resid, self.P * self.M * 2)
        ptr = lambda t: None if t is None else t.data_ptr()
        _done(_lib().ba_pairs_normal_equations(
            params.data_ptr(), self.n_cam, self.pt_to.data_ptr(),
            self.wm.data_ptr(), self.F.data_ptr(), self.Tc.data_ptr(), self.P,
            self.M, resid.data_ptr(), self.upd.data_ptr(), ptr(Bp), ptr(bp),
            ptr(JtJ), ptr(Jtb)))

    def normal_equations(self, params: torch.Tensor, resid: torch.Tensor):
        """JtJ [6n, 6n], Jtb [6n], as ``_pairs_normal_equations``."""
        self._normal(params, resid, None, None, self._JtJ, self._Jtb)
        return self._JtJ, self._Jtb

    def blocks(self, params: torch.Tensor, resid: torch.Tensor):
        """Bp [P, 12, 12], bp [P, 12] and the slots' from and to cameras,
        as ``_pairs_ne_blocks``."""
        if self._Bp is None:
            self._Bp = torch.empty(self.P, 12, 12, dtype=torch.float64)
            self._bp = torch.empty(self.P, 12, dtype=torch.float64)
        self._normal(params, resid, self._Bp, self._bp, None, None)
        return self._Bp, self._bp, self.F, self.Tc
