"""Numeric guard mode: the reference's m_assert/print_debug analog.

Reference: lib/debugutils.hh:41-52 (``m_assert`` aborts with file:line when
a debug-build invariant fails); counterpart of ``openpano_tpu/utils/debug.py``.
Both layers are on when ``OPENPANO_CHECK_NUMERICS=1`` and off by default,
since each check reads device values back to the host:

1. Stage-boundary guards: after each pipeline stage the stitcher calls
   :func:`assert_finite` on the stage's outputs; a NaN/Inf raises
   :class:`NumericsError` naming the stage, the array, the count of bad
   elements and the first bad index.
2. In-loop checks of the LM bundle adjustment (``camera/bundle_adjuster.py``):
   each iteration checks its residuals, normal equations, step, trial
   parameters and cost, so the first NaN/Inf is named where it appears
   instead of surfacing as a poisoned camera solution.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class NumericsError(AssertionError):
    """A pipeline stage produced NaN/Inf under OPENPANO_CHECK_NUMERICS."""


def numeric_checks_enabled() -> bool:
    return os.environ.get("OPENPANO_CHECK_NUMERICS", "") == "1"


def assert_finite(stage: str, **named_arrays) -> None:
    """Host-side finite check of stage outputs (no-op unless enabled).

    Each array (numpy or torch) is read back to the host, a synchronisation
    point, and the first offending one raises NumericsError.  Integer,
    boolean and ``None`` entries are skipped."""
    if not numeric_checks_enabled():
        return
    for name, arr in named_arrays.items():
        if arr is None:
            continue
        if torch.is_tensor(arr):
            if not arr.is_floating_point():
                continue
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr)
        if not np.issubdtype(a.dtype, np.floating):
            continue
        bad = ~np.isfinite(a)
        if bad.any():
            idx = np.argwhere(bad)[0]
            raise NumericsError(
                f"[{stage}] '{name}' has {int(bad.sum())} non-finite "
                f"values (first at index {tuple(int(i) for i in idx)}, "
                f"shape {a.shape})"
            )
