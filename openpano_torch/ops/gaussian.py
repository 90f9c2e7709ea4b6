"""Separable Gaussian blur with the reference's kernel construction.

Kernel window: ``kw = ceil(0.3*(sigma/2-1)+0.8)*GAUSS_WINDOW_FACTOR``,
forced odd, truncated-normalized (reference: feature/gaussian.cc:17-40);
border handling is edge replication (gaussian.hh:52-60).  Two 1-D
convolutions, the column pass first: edge replication makes the order
observable near the borders.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import gauss_window_radius
from ..utils.precision import full_f32


@functools.lru_cache(maxsize=64)
def gauss_kernel(sigma: float, window_factor: int) -> np.ndarray:
    """1-D normalized Gaussian taps, length 2*center+1."""
    center = gauss_window_radius(sigma, window_factor)
    i = np.arange(-center, center + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, sigma: float, window_factor: int = 6) -> torch.Tensor:
    """Separable Gaussian blur of single-channel images [..., H, W] with
    edge-replicated borders.  Leading dims are batched."""
    taps = torch.from_numpy(gauss_kernel(float(sigma), int(window_factor)))
    taps = taps.to(img.device).view(1, 1, -1)
    c = taps.shape[-1] // 2

    def conv_last(x):  # convolve along the last axis
        lead, n = x.shape[:-1], x.shape[-1]
        edge = torch.arange(-c, n + c, device=x.device).clamp_(0, n - 1)
        xp = x.reshape(-1, 1, n).index_select(2, edge)  # edge replication
        return F.conv1d(xp, taps).reshape(*lead, n)

    # cuDNN would run this f32 convolution in TF32 by default
    with full_f32():
        out = conv_last(img.transpose(-1, -2).contiguous()).transpose(-1, -2)
        return conv_last(out.contiguous())
