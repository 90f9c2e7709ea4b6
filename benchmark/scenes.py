"""Procedural scenes and view sets on the device, from the seed.

A frozen torch rewrite of the port's ``synth.procedural_scene_large``,
``render_views`` and ``strip_views``: the same texture recipe (value noise
under two posterized cell fields, so that SIFT finds corners at the cell
junctions), drawn from a ``torch.Generator`` on the device in a few large
calls.  It imports nothing of the port.

A traffic file names a generator ``kind``; ``generators/<kind>.py`` holds
it and is found by that name.  A generator module defines

- ``build(params, seed, device) -> state``: what every view set of one run
  shares (the texture);
- ``view_set(state, params, seed, index) -> (views, truth)``: the u8 views
  ``[N, H, W, 3]`` on the device of panorama ``index``, and the truth, a
  dict whose ``"adjacent"`` lists ``(a, b, T)``: views ``a`` and ``b``
  overlap, and the 3x3 ``T`` maps half-shifted pixel coordinates of view
  ``b`` (pixel index minus half the size) into view ``a``.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def generator(kind: str):
    """The generator module ``generators/<kind>.py``."""
    path = os.path.join(HERE, "generators", f"{kind}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no generator {kind!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"_bench_gen_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for the run's ``seed`` (any whole number;
    reduced mod 2**63) and a sub-stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2**63))
    return g


def host_rng(seed: int, index: int) -> np.random.Generator:
    """The host generator of panorama ``index`` of a run: its few scalar
    draws (start, jitter, order)."""
    return np.random.default_rng([int(seed) % (2**64), int(index)])


def _lerp_up(grid: torch.Tensor, h: int, w: int, wrap: bool) -> torch.Tensor:
    """``grid`` [gh, gw, ...] upsampled to [h, w, ...] by the value-noise
    lerp; ``wrap`` makes it periodic in x (the last cell blends into the
    first), so that a cylinder has no seam."""
    gh, gw = grid.shape[0], grid.shape[1]
    dev = grid.device
    ys = torch.linspace(0, gh - 1.001, h, device=dev)
    y0 = ys.long()
    fy = (ys - y0).view(-1, 1, *([1] * (grid.dim() - 2)))
    if wrap:
        xs = torch.arange(w, device=dev, dtype=torch.float32) * (gw / w)
        x0 = xs.long()
        x1 = (x0 + 1) % gw
    else:
        xs = torch.linspace(0, gw - 1.001, w, device=dev)
        x0 = xs.long()
        x1 = x0 + 1
    fx = (xs - x0).view(1, -1, *([1] * (grid.dim() - 2)))
    top, bot = grid[y0], grid[y0 + 1]
    return ((top[:, x0] * (1 - fx) + top[:, x1] * fx) * (1 - fy)
            + (bot[:, x0] * (1 - fx) + bot[:, x1] * fx) * fy)


PALETTE_SEED = 5


def texture(h: int, w: int, g: torch.Generator, wrap: bool) -> torch.Tensor:
    """[h, w, 3] float32 texture in [0, 1] on ``g``'s device: octaves 3-7
    of value noise (0.2 of it) under two posterized fields of 32-colour
    palettes (0.8), the recipe of ``procedural_scene_large``.  The fields
    come from ``g``; the palettes are the same for every seed, since they
    set the contrast at the cell edges and so how many keypoints a view
    has: a seed moves the scene's layout, not how much work it is."""
    dev = g.device

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    noise = None
    for octave in range(3, 8):
        up = _lerp_up(u(h // 2**octave + 2, w // 2**octave + 2, 3), h, w,
                      wrap) * (0.5 ** (8 - octave))
        noise = up if noise is None else noise + up
    noise /= noise.max()

    def poster(octaves):
        cell = None
        for octave in octaves:
            up = _lerp_up(u(h // 2**octave + 2, w // 2**octave + 2), h, w,
                          wrap)
            cell = up if cell is None else cell + up
        return torch.clamp((cell * 16).long(), 0, 31)

    pg = torch.Generator(device="cpu").manual_seed(PALETTE_SEED)
    pal_a = torch.rand(32, 3, generator=pg).to(dev)
    pal_b = torch.rand(32, 3, generator=pg).to(dev) - 0.5
    ia, ib = poster((6, 7)), poster((7, 8))
    return torch.clamp(0.2 * noise + 0.8 * (pal_a[ia] + pal_b[ib] * 0.7),
                       0, 1)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] float in [0, 1] to uint8, rounded."""
    return torch.round(img * 255.0).to(torch.uint8)


def bilinear_wrap_x(tex: torch.Tensor, sy: torch.Tensor,
                    sx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``tex`` [Hs, Ws, 3] at (sy, sx), periodic in x
    and clamped in y."""
    hs, ws = tex.shape[0], tex.shape[1]
    x0f = torch.floor(sx)
    y0 = torch.clamp(torch.floor(sy), 0, hs - 2).long()
    fx = (sx - x0f)[..., None]
    fy = torch.clamp(sy - y0, 0, 1)[..., None]
    x0 = torch.remainder(x0f.long(), ws)
    x1 = torch.remainder(x0 + 1, ws)
    top = tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx
    bot = tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x1] * fx
    return top * (1 - fy) + bot * fy
