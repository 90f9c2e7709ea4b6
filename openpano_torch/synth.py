"""Synthetic scenes and views for tests and the chip smoke run (numpy only).

A copy of the numpy-only generators of ``openpano_tpu.synth``, kept here so
that the port never imports the JAX package (importing any module of it
starts JAX).  Same functions, same seeds, same pixels.  ``strip_views`` adds
the translated-strip set that TRANS mode stitches, cut from
``procedural_scene_large`` so that no photo is needed.  ``photo_scene``
reads the reference's result photo ``CMU0-all.jpg`` from the JAX package's
default path, ``DEFAULT_PHOTO``; it raises when the photo is not there.
"""

from __future__ import annotations

import os

import numpy as np

# the JAX package's default photo for photo_scene, as it names it
DEFAULT_PHOTO = "/root/reference/results/CMU0-all.jpg"


def procedural_scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Feature-rich procedural texture in [0,1]: multi-octave value noise
    plus random high-contrast shapes (corners galore for SIFT)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for octave in range(2, 7):
        gh, gw = h // 2 ** octave + 2, w // 2 ** octave + 2
        grid = rng.uniform(size=(gh, gw, 3)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        up = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += up * (0.5 ** (7 - octave))
    img /= img.max()
    # high-contrast rectangles and discs, dense enough that every camera
    # view contains hundreds of corners
    yy, xx = np.mgrid[0:h, 0:w]
    n_shapes = max(400, h * w // 1500)
    for _ in range(n_shapes):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        s = rng.integers(3, max(5, min(h, w) // 16))
        col = rng.uniform(0, 1, 3).astype(np.float32)
        if rng.random() < 0.5:
            m = (np.abs(yy - cy) < s) & (np.abs(xx - cx) < s * rng.uniform(0.3, 2))
        else:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < s ** 2
        img[m] = img[m] * 0.25 + col * 0.75
    return np.clip(img, 0, 1)


def photo_scene(path: str | None = None) -> np.ndarray:
    """A reference result photo as texture (realistic statistics), float32
    RGB in [0, 1]; ``path`` defaults to ``DEFAULT_PHOTO``."""
    from .io.image import read_img

    if path is None:
        path = DEFAULT_PHOTO
    img = np.asarray(read_img(path))
    img = np.where(img < 0, 0.0, img)  # strip NO sentinels from cropped edges
    return img.astype(np.float32)


def render_views(
    scene: np.ndarray,
    n_views: int,
    out_w: int = 640,
    out_h: int = 480,
    hfov_deg: float = 35.0,
    overlap: float = 0.45,
    v_span: float = 0.9,
    seed: int = 0,
    jitter: float = 0.0,
):
    """Render n_views images of a cylindrical scene with a yaw-rotating camera.

    scene: [Hs, Ws, 3] texture wrapped on a cylinder.
    Returns (views [n, out_h, out_w, 3] float32, truth dict) where truth has
    `focal_px`, `yaws` (radians), and `hfov` — enough to validate estimated
    cameras and pairwise homographies (H_gt = K R_rel K^-1).
    """
    rng = np.random.default_rng(seed)
    hs, ws = scene.shape[:2]
    hfov = np.radians(hfov_deg)
    f = (out_w / 2) / np.tan(hfov / 2)           # focal in pixels
    step = hfov * (1 - overlap)
    yaws = (np.arange(n_views) - (n_views - 1) / 2) * step
    if jitter:
        yaws = yaws + rng.normal(scale=jitter * step, size=n_views)
    total_angle = hfov + step * (n_views - 1) + 0.2
    # vertical half-extent of the cylinder texture in h-units (y/hypot units)
    vfov_half = np.tan(np.arctan((out_h / 2) / f)) * 1.15 / v_span

    u = np.arange(out_w) - (out_w - 1) / 2.0
    v = np.arange(out_h) - (out_h - 1) / 2.0
    uu, vv = np.meshgrid(u, v)

    views = np.empty((n_views, out_h, out_w, 3), np.float32)
    for k, yaw in enumerate(yaws):
        xr = np.cos(yaw) * uu + np.sin(yaw) * f
        zr = -np.sin(yaw) * uu + np.cos(yaw) * f
        ang = np.arctan2(xr, zr)
        hgt = vv / np.hypot(xr, zr)
        sx = (ang / total_angle + 0.5) * (ws - 1)
        sy = (hgt / (2 * vfov_half) + 0.5) * (hs - 1)
        x0 = np.clip(np.floor(sx).astype(int), 0, ws - 2)
        y0 = np.clip(np.floor(sy).astype(int), 0, hs - 2)
        fx = np.clip(sx - x0, 0, 1)[..., None]
        fy = np.clip(sy - y0, 0, 1)[..., None]
        img = (
            scene[y0, x0] * (1 - fy) * (1 - fx)
            + scene[y0, x0 + 1] * (1 - fy) * fx
            + scene[y0 + 1, x0] * fy * (1 - fx)
            + scene[y0 + 1, x0 + 1] * fy * fx
        )
        views[k] = img
    truth = {"focal_px": f, "yaws": yaws, "hfov": hfov}
    return views, truth


def gt_pair_homography(truth: dict, i: int, j: int, out_w: int, out_h: int) -> np.ndarray:
    """Ground-truth homography mapping half-shifted coords of view j into
    view i: H = K R_i^T R_j K^-1 for pure yaw rotations."""
    f = truth["focal_px"]
    K = np.array([[f, 0, 0], [0, f, 0], [0, 0, 1.0]])
    dyaw = truth["yaws"][j] - truth["yaws"][i]
    R = np.array([
        [np.cos(dyaw), 0, np.sin(dyaw)],
        [0, 1, 0],
        [-np.sin(dyaw), 0, np.cos(dyaw)],
    ])
    H = K @ R @ np.linalg.inv(K)
    return H / H[2, 2]


def _bilinear_rows(grid: np.ndarray, h: int, w: int, rows: slice):
    """Rows ``rows`` of ``grid`` ([gh, gw] or [gh, gw, 3]) upsampled to
    h x w by the value-noise lerp, float32."""
    gh, gw = grid.shape[:2]
    ys = np.linspace(0, gh - 1.001, h)[rows]
    xs = np.linspace(0, gw - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    tail = (1,) * (grid.ndim - 2)
    fy = (ys - y0).reshape(-1, 1, *tail).astype(np.float32)
    fx = (xs - x0).reshape(1, -1, *tail).astype(np.float32)
    return (
        grid[y0][:, x0] * (1 - fy) * (1 - fx)
        + grid[y0][:, x0 + 1] * (1 - fy) * fx
        + grid[y0 + 1][:, x0] * fy * (1 - fx)
        + grid[y0 + 1][:, x0 + 1] * fy * fx
    )


def _large_noise_grids(h: int, w: int, rng) -> list[np.ndarray]:
    return [rng.uniform(size=(h // 2 ** o + 2, w // 2 ** o + 2, 3)).astype(
        np.float32) for o in range(3, 8)]


def scene_large_noise(h: int, w: int, seed: int = 0,
                      rows: slice = slice(None)) -> np.ndarray:
    """Rows ``rows`` of ``procedural_scene_large``'s value noise, before
    its division by the whole noise's maximum."""
    grids = _large_noise_grids(h, w, np.random.default_rng(seed))
    img = None
    for octave, grid in zip(range(3, 8), grids):
        up = _bilinear_rows(grid, h, w, rows) * (0.5 ** (8 - octave))
        img = up if img is None else img + up
    return img


def scene_large_compose(noise: np.ndarray, h: int, w: int, seed: int = 0,
                        rows: slice = slice(None)) -> np.ndarray:
    """Rows ``rows`` of ``procedural_scene_large`` from the same rows of its
    value noise already divided by the whole noise's maximum."""
    rng = np.random.default_rng(seed)
    _large_noise_grids(h, w, rng)          # the draws before the palettes

    # posterized cell fields: hard high-contrast edges at every cell
    # boundary (corners at triple points; 16-64 px cells survive the SIFT
    # working resize).  TWO independent posterize fields combine into
    # ~1000 distinct junction colorings — one 32-color field alone makes
    # the cell junctions so self-similar that the matcher's ratio test
    # rejects nearly everything (measured: 29 raw 2-NN matches on a
    # 37%-overlap pair with 1024 keypoints each).
    def _poster(octaves, seed_off):
        r2 = np.random.default_rng(seed + seed_off)
        cell = None
        for octave in octaves:
            gh, gw = h // 2 ** octave + 2, w // 2 ** octave + 2
            grid = r2.uniform(size=(gh, gw)).astype(np.float32)
            up = _bilinear_rows(grid, h, w, rows)
            cell = up if cell is None else cell + up
        return cell

    # cell octaves start at 5 (32 px): octave-4 cells made the texture SO
    # corner-dense that the per-octave candidate caps saturated in scan
    # order and every view kept only top-of-image keypoints (a 1024-cap
    # view had 0% of its keypoints in the bottom overlap strip) — the
    # same order-biased truncation the reference's capacity caps exhibit
    pal_a = rng.uniform(0.0, 1.0, size=(32, 3)).astype(np.float32)
    pal_b = rng.uniform(-0.5, 0.5, size=(32, 3)).astype(np.float32)
    ia = np.clip((_poster((6, 7), 1000) * 16).astype(np.int32), 0, 31)
    ib = np.clip((_poster((7, 8), 2000) * 16).astype(np.int32), 0, 31)
    return np.clip(0.2 * noise + 0.8 * (pal_a[ia] + pal_b[ib] * 0.7), 0, 1)


def procedural_scene_large(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Corner-rich texture that scales to equirect-panorama sizes
    (procedural_scene's per-shape full-canvas masks are O(shapes * h * w)
    — hopeless at 500 Mpx).  Fully vectorized: multi-octave value noise
    for low-frequency content + a POSTERIZED independent noise field
    (random 24-color palette, hard edges at every cell boundary — corner
    features at triple points for SIFT), float32 in [0,1].  Every pixel
    depends on its row's draws only, and on the noise's maximum: row
    blocks can be made apart (``scene_large_noise``,
    ``scene_large_compose``) and give the same pixels."""
    img = scene_large_noise(h, w, seed)
    img /= img.max()
    return scene_large_compose(img, h, w, seed)


def strip_views(n: int, w: int, h: int, overlap: float = 0.4,
                seed: int = 0, offsets: bool = False):
    """n translated [h, w] crops of one wide procedural texture, stepping
    ``w * (1 - overlap)`` px to the right with a few px of jitter per view
    (a scanned strip / UAV pass: the TRANS-mode imaging model).

    The texture is ``procedural_scene_large`` at most ``max(4w, 2048)``
    columns wide, tiled horizontally as far as the strip needs; one period
    is wider than a view, so no view overlaps a repeat of itself.
    Returns float32 [n, h, w, 3] in [0, 1]; with ``offsets=True`` also the
    [n, 2] (x, y) texture position of each view's top-left pixel, the
    ground truth a stitch must recover."""
    step = int(w * (1 - overlap))
    need_w = w + step * (n - 1) + 32
    scene_w = min(need_w, max(4 * w, 2048))
    scene = procedural_scene_large(h + 64, scene_w, seed)
    strip = np.tile(scene, (1, -(-need_w // scene_w), 1))
    rng = np.random.default_rng(seed)
    views = np.empty((n, h, w, 3), np.float32)
    xy = np.empty((n, 2), np.int64)
    for k in range(n):
        x0 = 16 + k * step + int(rng.integers(-8, 9))
        y0 = 32 + int(rng.integers(-6, 7))
        views[k] = strip[y0 : y0 + h, x0 : x0 + w]
        xy[k] = x0, y0
    return (views, xy) if offsets else views


def serpentine_rotations(cols: int, rows: int, yaw_step: float,
                         pitch_step: float):
    """Rotation matrices for a yaw x pitch grid visited in serpentine order
    (consecutive entries always overlap: the ordered-input ring the
    stitcher's linear matching assumes).  R = R_yaw @ R_pitch (pitch in the
    camera's frame).  Returns ([n, 3, 3], [(row, col)] in visiting
    order)."""
    Rs = []
    order = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        for c in cs:
            order.append((r, c))
            yaw = c * yaw_step
            pitch = (r - (rows - 1) / 2) * pitch_step
            cy, sy = np.cos(yaw), np.sin(yaw)
            cp, sp = np.cos(pitch), np.sin(pitch)
            Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
            Rs.append(Ry @ Rx)
    return np.stack(Rs), order


def render_views_sphere(scene_eq: np.ndarray, rotations: np.ndarray,
                        out_w: int, out_h: int, f: float,
                        dtype=np.uint8) -> np.ndarray:
    """Views of an equirectangular scene under arbitrary camera rotations
    (the general rotational panorama; ground-truth pair homography H_ij =
    K R_i^T R_j K^-1).

    scene_eq: [He, We, 3] float32 in [0, 1], theta in [-pi, pi) over We,
    phi over [-phi_max, phi_max] rows.  Returns [n, out_h, out_w, 3]."""
    he, we = scene_eq.shape[:2]
    n = rotations.shape[0]
    u = np.arange(out_w) - (out_w - 1) / 2.0
    v = np.arange(out_h) - (out_h - 1) / 2.0
    uu, vv = np.meshgrid(u, v)
    rays = np.stack([uu, vv, np.full_like(uu, f)], axis=-1)  # [H, W, 3]
    phi_max = np.pi * he / we  # square pixels: phi rows at theta's rad/px
    out = np.empty((n, out_h, out_w, 3), dtype)
    for k in range(n):
        d = rays @ rotations[k].T
        theta = np.arctan2(d[..., 0], d[..., 2])
        phi = np.arctan2(d[..., 1], np.hypot(d[..., 0], d[..., 2]))
        sx = (theta / (2 * np.pi) + 0.5) * we          # wraps
        sy = (phi / (2 * phi_max) + 0.5) * (he - 1)
        x0 = np.floor(sx).astype(np.int64)
        y0 = np.clip(np.floor(sy).astype(np.int64), 0, he - 2)
        fx = (sx - x0)[..., None]
        fy = np.clip(sy - y0, 0, 1)[..., None]
        xa = x0 % we
        xb = (x0 + 1) % we
        img = (
            scene_eq[y0, xa] * (1 - fy) * (1 - fx)
            + scene_eq[y0, xb] * (1 - fy) * fx
            + scene_eq[y0 + 1, xa] * fy * (1 - fx)
            + scene_eq[y0 + 1, xb] * fy * fx
        )
        if dtype == np.uint8:
            out[k] = np.round(img * 255.0)
        else:
            out[k] = img
    return out


def gt_rot_pair_homography(f: float, R_i: np.ndarray, R_j: np.ndarray):
    """H mapping half-shifted coords of view j into view i for general
    rotations: H = K R_i^T R_j K^-1."""
    K = np.array([[f, 0, 0], [0, f, 0], [0, 0, 1.0]])
    H = K @ R_i.T @ R_j @ np.linalg.inv(K)
    return H / H[2, 2]


# ---------------------------------------------------------------------------
# gigapixel-scale data in row / view blocks over worker processes
# ---------------------------------------------------------------------------

_ROW_BLOCK = 256
_VIEW_BLOCK = 4


def _noise_block(h, w, seed, r0, r1, noise_path):
    mm = np.load(noise_path, mmap_mode="r+")
    mm[r0:r1] = scene_large_noise(h, w, seed, slice(r0, r1))
    peak = mm[r0:r1].max()
    mm.flush()
    return peak


def _compose_block(h, w, seed, r0, r1, noise_path, peak, out_path):
    noise = np.load(noise_path, mmap_mode="r")[r0:r1] / peak
    rows = scene_large_compose(noise, h, w, seed, slice(r0, r1))
    out = np.load(out_path, mmap_mode="r+")
    out[r0:r1] = (rows if out.dtype == np.float32
                  else np.round(rows * 255).astype(np.uint8))
    out.flush()


def _render_block(scene_path, rotations, out_w, out_h, f, k0, out_path):
    scene = np.load(scene_path, mmap_mode="r")
    out = np.load(out_path, mmap_mode="r+")
    out[k0:k0 + len(rotations)] = render_views_sphere(scene, rotations, out_w,
                                                      out_h, f)
    out.flush()


def _pool(workers: int):
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(workers)


def procedural_scene_large_to(path: str, h: int, w: int, seed: int = 0,
                              dtype=np.float32, workers: int = 1):
    """Write ``procedural_scene_large(h, w, seed)`` to the .npy file
    ``path``, as float32 or (``dtype=np.uint8``) as
    ``np.round(scene * 255)``, built in blocks of rows over ``workers``
    spawned processes; the pixels are those of the one-call function.  The
    unnormalized noise passes through a scratch file beside ``path``."""
    noise_path = f"{path}.noise.npy"
    np.lib.format.open_memmap(noise_path, "w+", np.float32, (h, w, 3))
    np.lib.format.open_memmap(path, "w+", dtype, (h, w, 3))
    blocks = [(r, min(r + _ROW_BLOCK, h)) for r in range(0, h, _ROW_BLOCK)]
    try:
        with _pool(workers) as pool:
            peak = max(pool.starmap(_noise_block, [
                (h, w, seed, r0, r1, noise_path) for r0, r1 in blocks]))
            pool.starmap(_compose_block, [
                (h, w, seed, r0, r1, noise_path, peak, path)
                for r0, r1 in blocks])
    finally:
        os.remove(noise_path)


def render_views_sphere_to(path: str, scene_path: str, rotations: np.ndarray,
                           out_w: int, out_h: int, f: float,
                           workers: int = 1):
    """Write ``render_views_sphere`` of the .npy scene at ``scene_path`` (u8
    views) to the .npy file ``path``, in blocks of views over ``workers``
    spawned processes; the pixels are those of the one-call function."""
    n = rotations.shape[0]
    np.lib.format.open_memmap(path, "w+", np.uint8, (n, out_h, out_w, 3))
    with _pool(workers) as pool:
        pool.starmap(_render_block, [
            (scene_path, rotations[k:k + _VIEW_BLOCK], out_w, out_h, f, k,
             path) for k in range(0, n, _VIEW_BLOCK)])
