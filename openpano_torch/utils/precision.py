"""Full-f32 scope for products whose results feed thresholds.

On the card a float32 convolution goes through cuDNN in TF32 by default,
and a matrix product does whenever ``allow_tf32`` has been turned on.  TF32
keeps about three decimal digits, far coarser than the DoG, ratio-test and
RANSAC thresholds downstream, so the blur, the 2-NN distances, the DLT
normal equations and the plain descriptor histogram run inside
:func:`full_f32`.  It sets both switches off for the scope and restores
them after; on the CPU they change nothing.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
