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
