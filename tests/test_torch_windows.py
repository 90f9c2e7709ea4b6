"""Port parity: the two window-histogram kernels' plain versions against the
JAX package's ``orientation_histogram`` / ``descriptor_histogram``.

Same numpy inputs through both; the gate is the one the kernels are held
to on the card, max|a-b| / max|b| < 1e-4 (f32 accumulation order only).
The JAX side runs its plain XLA path and, once per kernel, the Pallas
kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu.ops.windows as jwin
from openpano_torch.ops import windows as twin

TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _case(seed, S=5, H=60, W=90, K=64, R=8, B=None):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    mag = rng.uniform(0, 1, lead + (S, H, W)).astype(np.float32)
    ort = rng.uniform(0, 2 * np.pi, lead + (S, H, W)).astype(np.float32)
    kp = dict(
        s=rng.integers(0, S, lead + (K,)).astype(np.int32),
        # includes border keypoints: the interior mask must cut their windows
        y=rng.integers(0, H, lead + (K,)).astype(np.int32),
        x=rng.integers(0, W, lead + (K,)).astype(np.int32),
        rad=rng.integers(1, R + 1, lead + (K,)).astype(np.float32),
        invden=rng.uniform(0.005, 0.1, lead + (K,)).astype(np.float32),
        hw=rng.uniform(1.5, 5.0, lead + (K,)).astype(np.float32),
        dirv=rng.uniform(0, 2 * np.pi, lead + (K,)).astype(np.float32),
        # per-keypoint octave bounds no larger than the stacked plane
        wh=np.stack([rng.integers(W // 2, W + 1, lead + (K,)),
                     rng.integers(H // 2, H + 1, lead + (K,))], -1
                    ).astype(np.float32),
        valid=rng.uniform(size=lead + (K,)) < 0.8,
    )
    return mag, ort, kp


def _ori_jax(mag, ort, kp, R):
    WR = jwin.slab_rows(R)
    f = lambda m, o, s, y, x, r, i, wh, v: jwin.orientation_histogram(
        m, o, s, y, x, r, i, WR, wh=wh, valid=v)
    if mag.ndim == 4:
        f = jax.vmap(f)
    return np.asarray(jax.jit(f)(
        *map(jnp.asarray, (mag, ort, kp["s"], kp["y"], kp["x"], kp["rad"],
                           kp["invden"], kp["wh"], kp["valid"]))))


def _ori_torch(mag, ort, kp, R):
    t = torch.from_numpy
    return twin.orientation_histogram(
        t(mag), t(ort), t(kp["s"]), t(kp["y"]), t(kp["x"]), t(kp["rad"]),
        t(kp["invden"]), R, wh=t(kp["wh"]), valid=t(kp["valid"])).numpy()


def _desc_jax(mag, ort, kp, R):
    WR = jwin.slab_rows(R)
    f = lambda m, o, s, y, x, r, hw, d, wh, v: jwin.descriptor_histogram(
        m, o, s, y, x, r, hw, d, WR, wh=wh, valid=v)
    if mag.ndim == 4:
        f = jax.vmap(f)
    return np.asarray(jax.jit(f)(
        *map(jnp.asarray, (mag, ort, kp["s"], kp["y"], kp["x"], kp["rad"],
                           kp["hw"], kp["dirv"], kp["wh"], kp["valid"]))))


def _desc_torch(mag, ort, kp, R):
    t = torch.from_numpy
    return twin.descriptor_histogram(
        t(mag), t(ort), t(kp["s"]), t(kp["y"]), t(kp["x"]), t(kp["rad"]),
        t(kp["hw"]), t(kp["dirv"]), R, wh=t(kp["wh"]),
        valid=t(kp["valid"])).numpy()


@pytest.mark.parametrize("seed,R", [(0, 8), (1, 5), (2, 12)])
def test_orientation_plain_matches_jax(seed, R):
    mag, ort, kp = _case(seed, R=R)
    got, want = _ori_torch(mag, ort, kp, R), _ori_jax(mag, ort, kp, R)
    assert got.shape == want.shape == (64, 36)
    assert _rel(got, want) < TOL
    assert (got[~kp["valid"]] == 0).all()


@pytest.mark.parametrize("seed,R", [(3, 19), (4, 10)])
def test_descriptor_plain_matches_jax(seed, R):
    mag, ort, kp = _case(seed, R=R)
    kp["rad"] = np.random.default_rng(seed).integers(
        1, R + 1, kp["rad"].shape).astype(np.float32)
    got, want = _desc_torch(mag, ort, kp, R), _desc_jax(mag, ort, kp, R)
    assert got.shape == want.shape == (64, 128)
    assert _rel(got, want) < TOL
    assert (got[~kp["valid"]] == 0).all()


def test_batch_folds_like_vmap():
    mag, ort, kp = _case(5, B=2, K=24, R=8)
    assert _rel(_ori_torch(mag, ort, kp, 8), _ori_jax(mag, ort, kp, 8)) < TOL
    kp["rad"] = np.minimum(kp["rad"] * 2, 16)
    assert _rel(_desc_torch(mag, ort, kp, 16),
                _desc_jax(mag, ort, kp, 16)) < TOL


@pytest.mark.parametrize("which", ["ori", "desc"])
def test_plain_matches_pallas_interpret(which):
    """The Pallas kernels themselves (interpret mode) against the port."""
    mag, ort, kp = _case(6, K=16, R=8)
    jwin.INTERPRET = True
    try:
        if which == "ori":
            want = _ori_jax(mag, ort, kp, 8)
            got = _ori_torch(mag, ort, kp, 8)
        else:
            want = _desc_jax(mag, ort, kp, 8)
            got = _desc_torch(mag, ort, kp, 8)
    finally:
        jwin.INTERPRET = False
    assert _rel(got, want) < TOL


def test_slab_rule_matches_jax():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 500, 200).astype(np.int32)
    x = rng.integers(0, 700, 200).astype(np.int32)
    for R in (4, 8, 19, 40):
        assert twin.slab_rows(R) == jwin.slab_rows(R)
        WR = twin.slab_rows(R)
        jr0, jc0 = jwin.window_starts(jnp.asarray(y), jnp.asarray(x), 500,
                                      700, WR)
        tr0, tc0 = twin.window_starts(torch.from_numpy(y),
                                      torch.from_numpy(x), 500, 700, WR)
        np.testing.assert_array_equal(np.asarray(jr0), tr0.numpy())
        np.testing.assert_array_equal(np.asarray(jc0), tc0.numpy())
        # the direct window read equals the slab while +-R rows and +-63
        # lanes fit in it (the bound the kernels assert)
        r0, c0 = tr0.numpy(), tc0.numpy()
        assert (r0 <= np.maximum(y - R, 0)).all()
        assert (np.minimum(y + R, 499) <= r0 + WR - 1).all()
        assert (c0 <= np.maximum(x - 63, 0)).all()


def test_window_radius_bound_enforced():
    mag, ort, kp = _case(8, K=4)
    with pytest.raises(ValueError):
        _ori_torch(mag, ort, kp, twin.MAX_WINDOW_RADIUS + 1)
    with pytest.raises(ValueError):
        _desc_torch(mag, ort, kp, twin.MAX_WINDOW_RADIUS + 1)


def test_cpu_route_counts_no_launch():
    """A CPU tensor takes the plain version and never touches the kernel
    counter (launches are counted only where a kernel launches)."""
    before = (twin.orientation_histogram.launches,
              twin.descriptor_histogram.launches)
    mag, ort, kp = _case(9, K=8)
    _ori_torch(mag, ort, kp, 8)
    _desc_torch(mag, ort, kp, 8)
    assert (twin.orientation_histogram.launches,
            twin.descriptor_histogram.launches) == before


def _corner_terms(wgt, ybin, xbin, hbin):
    """The rule the card's K2 adds by, in numpy f32: per pixel only the
    corners floor(.) and floor(.) + 1 of ybin and xbin inside [0, 3] and of
    hbin mod 8 (circular), each term wgt * hy * hx * ho with the dense
    hats' expressions.  [P, 4, 4, 8], zero at every other corner."""
    f32 = np.float32
    hat = lambda d: np.maximum(f32(0), f32(1) - np.abs(d))
    out = np.zeros((len(wgt), 4, 4, 8), f32)
    for i, (w, yb, xb, hb) in enumerate(zip(wgt, ybin, xbin, hbin)):
        y0, x0, o0 = (int(np.floor(v)) for v in (yb, xb, hb))
        for by in {y0, y0 + 1} & {0, 1, 2, 3}:
            for bx in {x0, x0 + 1} & {0, 1, 2, 3}:
                for bo in {o0 % 8, (o0 + 1) % 8}:
                    d = np.abs(hb - f32(bo))
                    out[i, by, bx, bo] = (w * hat(yb - f32(by))
                                          * hat(xb - f32(bx))
                                          * hat(np.minimum(d, f32(8) - d)))
    return out


def _edge_bins():
    """Bin coordinates of the crafted edge case: keypoint direction 0 and
    bin widths 2 and 4, so that ybin, xbin = offset / width + 1.5 land
    exactly on -1 and 3 (and every integer between), computed with the
    plain version's f32 ops; orientations on multiples of 2*pi/8, at 2*pi
    (hbin 8, the wrap to bin 0) and one ulp under it."""
    d = torch.arange(-19, 20, dtype=torch.float32)
    fy, fx = (g.reshape(-1) for g in torch.meshgrid(d, d, indexing="ij"))
    co, si = torch.cos(torch.zeros(())), torch.sin(torch.zeros(()))
    two_pi = torch.tensor(2 * np.pi, dtype=torch.float32)
    ort = torch.cat([torch.arange(9) * (two_pi / 8),
                     torch.nextafter(two_pi, torch.zeros(()))[None]])
    ybin, xbin, hbin = [], [], []
    for hw in (2.0, 4.0):
        yb = (-fx * si + fy * co) / hw + twin.DESC_W4 / 2 - 0.5
        xb = (fx * co + fy * si) / hw + twin.DESC_W4 / 2 - 0.5
        keep = (yb >= -1) & (yb <= 3) & (xb >= -1) & (xb <= 3)
        ybin.append(yb[keep])
        xbin.append(xb[keep])
        o = ort[torch.arange(int(keep.sum())) % len(ort)]
        hbin.append(o * (twin.DESC_NB / (2.0 * np.pi)))
    return torch.cat(ybin), torch.cat(xbin), torch.cat(hbin)


@pytest.mark.parametrize("case", ["edges", "random"])
def test_descriptor_corner_rule_equals_dense_hats(case):
    """K2 on the card adds only the two corners per axis that can carry
    weight (circular in orientation, spatial corners past the edges
    dropped).  That rule's terms equal the dense hats of the plain version
    term by term, bit for bit, on the bin edges and on random bins."""
    if case == "edges":
        ybin, xbin, hbin = _edge_bins()
        assert {-1.0, 3.0} <= set(ybin.tolist()) & set(xbin.tolist())
        h = set(hbin.tolist())
        assert 0.0 in h and max(h) >= 8.0 and any(7.99 < v < 8.0 for v in h)
    else:
        rng = np.random.default_rng(12)
        n = 3000
        near = rng.integers(-1, 4, n) + rng.choice([-1, 0, 1], n) * 2e-7
        ybin = torch.from_numpy(np.where(
            rng.uniform(size=n) < 0.3, near, rng.uniform(-1, 3, n)
        ).clip(-1, 3).astype(np.float32))
        xbin = torch.from_numpy(rng.uniform(-1, 3, n).astype(np.float32))
        hbin = torch.from_numpy(np.where(
            rng.uniform(size=n) < 0.3, rng.integers(0, 9, n) * 1.0 - 4e-7,
            rng.uniform(0, 8, n)).clip(0, 8).astype(np.float32))
    wgt = torch.from_numpy(np.random.default_rng(13).uniform(
        0.1, 2, len(ybin)).astype(np.float32))
    A, B, Co = twin.desc_hats(ybin, xbin, hbin)
    dense = (wgt[:, None, None, None] * A[:, :, None, None]
             * B[:, None, :, None] * Co[:, None, None, :])
    sparse = _corner_terms(*(v.numpy() for v in (wgt, ybin, xbin, hbin)))
    np.testing.assert_array_equal(sparse, dense.numpy())
    assert ((sparse > 0).sum((1, 2, 3)) <= 8).all()
