"""Port parity for the point-major bundle adjustment, on the CPU.

The cases of ``tests/test_camera.py``'s ``TestBundleAdjuster`` (a perturbed
3-camera yaw pano, and the identity camera's frozen rotation) go through
``pairs_to_points`` and ``ba_optimize`` of both packages: the optimized
cameras agree within 1e-6 (relative, focal; absolute, everything else) and
satisfy the JAX tests' own gates.  ``pairs_to_points``'s layout equals the
JAX one field for field; the pieces (``_effective`` with swapped pairs,
``_segment_blocks``, the analytic ``_eff_jacobian`` against a finite
difference of ``_point_residual``, the normal equations) agree with JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.camera import bundle_adjuster as jba
from openpano_torch.camera import bundle_adjuster as tba
from openpano_torch.camera.rotation import rodrigues

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synth_pairs(rng, n=3, f=700.0, noise=0.0, M=64):
    """tests/test_camera.py's synth_rotation_pano, pairs (i, i+1) only:
    (to_pos [P, M, 2] in image i, from_pos in image i+1, valid, f)."""
    yaws = (np.arange(n) - n // 2) * 0.15
    Rs = [rodrigues(torch.tensor([rng.normal() * 0.02, y,
                                  rng.normal() * 0.02])).numpy()
          for y in yaws]
    K = np.diag([f, f, 1.0])
    to_pos, from_pos = [], []
    for i in range(n - 1):
        H = K @ Rs[i].T @ Rs[i + 1] @ np.linalg.inv(K)      # i+1 -> i
        H = H / H[2, 2]
        pts_j = rng.uniform(-250, 250, size=(M, 2))
        p = np.concatenate([pts_j, np.ones((M, 1))], 1) @ H.T
        to_pos.append(p[:, :2] / p[:, 2:3] + rng.normal(size=(M, 2)) * noise)
        from_pos.append(pts_j)
    return np.stack(to_pos), np.stack(from_pos), np.ones((n - 1, M), bool), f


def both_problems(to_pos, from_pos, valid, active=None):
    """The same problem in both packages: BA 'from' is image i (the stored
    to_pos), BA 'to' image i+1, as tests/test_camera.py builds it."""
    P = valid.shape[0]
    ii, jj = np.arange(P), np.arange(1, P + 1)
    active = np.ones(P) if active is None else active
    t = tba.pairs_to_points(ii, jj, torch.from_numpy(from_pos),
                            torch.from_numpy(to_pos), torch.from_numpy(valid),
                            torch.from_numpy(active))
    j = jba.pairs_to_points(jnp.asarray(ii), jnp.asarray(jj),
                            jnp.asarray(from_pos), jnp.asarray(to_pos),
                            jnp.asarray(valid), jnp.asarray(active))
    return t, j


def assert_cams_close(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TOL)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=TOL)


def test_pairs_to_points_layout_equals_jax():
    to_pos, from_pos, valid, _ = synth_pairs(np.random.default_rng(0))
    valid[1, 5:9] = False
    t, j = both_problems(to_pos, from_pos, valid, np.array([1.0, 0.0]))
    for name in tba.BAProblem._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_ba_reduces_error_with_bad_init():
    rng = np.random.default_rng(42)
    to_pos, from_pos, valid, f = synth_pairs(rng, noise=0.3)
    t, j = both_problems(to_pos, from_pos, valid)
    params = np.zeros((3, 6))
    params[:, 0] = f * 1.1                     # perturbed focal
    for i, y in enumerate([-0.15, 0.0, 0.15]):
        params[i, 3:6] = [0, y * 1.15, 0]      # perturbed rotations
    got = tba.ba_optimize(torch.from_numpy(params), t, 1, 3, 5.0).numpy()
    want = np.asarray(jba.ba_optimize(jnp.asarray(params), j, jnp.asarray(1),
                                      3, 5.0))
    assert_cams_close(got, want)
    assert abs(got[0, 0] - f) < abs(params[0, 0] - f)
    r = tba._residuals(torch.from_numpy(got), t)
    assert float(tba._rms_points(r, t)) < 2.0
    np.testing.assert_allclose(
        float(tba._rms_points(r, t)),
        float(jba._rms(jba._residuals(jnp.asarray(want), j), j)), rtol=TOL)


def test_identity_rotation_frozen():
    rng = np.random.default_rng(42)
    to_pos, from_pos, valid, f = synth_pairs(rng)
    t, j = both_problems(to_pos, from_pos, valid)
    params = np.zeros((3, 6))
    params[:, 0] = f
    params[0, 3:6] = [0, -0.14, 0]
    params[2, 3:6] = [0, 0.14, 0]
    got = tba.ba_optimize(torch.from_numpy(params), t, 1, 3, 5.0).numpy()
    want = np.asarray(jba.ba_optimize(jnp.asarray(params), j, jnp.asarray(1),
                                      3, 5.0))
    np.testing.assert_array_equal(got[1, 3:6], params[1, 3:6])
    assert_cams_close(got, want)


def test_pieces_equal_jax_with_swapped_pairs():
    """_effective with one pair swapped and one inactive, the residuals, the
    segment sums and the normal equations; the analytic Jacobian against a
    central difference of _point_residual."""
    rng = np.random.default_rng(7)
    to_pos, from_pos, valid, f = synth_pairs(rng, n=4, noise=0.5, M=16)
    valid[2, 3] = False
    t, j = both_problems(to_pos, from_pos, valid, np.array([1.0, 1.0, 0.0]))
    t = t._replace(swapped=torch.tensor([False, True, False]))
    j = j._replace(swapped=jnp.asarray([False, True, False]))
    te, je = tba._effective(t), jba._effective(j)
    for name in tba._EffProblem._fields:
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    params = np.zeros((4, 6))
    params[:, 0] = f * rng.uniform(0.95, 1.05, 4)
    params[:, 1:3] = rng.normal(size=(4, 2))
    params[:, 3:6] = rng.normal(size=(4, 3)) * 0.1
    tp, jp = torch.from_numpy(params), jnp.asarray(params)
    r = tba._eff_residuals(tp, te)
    np.testing.assert_allclose(r.numpy(), np.asarray(
        jba._eff_residuals(jp, je)), rtol=1e-9, atol=1e-9)
    x = torch.from_numpy(rng.normal(size=(te.w.shape[0], 3, 2)))
    np.testing.assert_allclose(
        tba._segment_blocks(x, te.starts, te.ends).numpy(),
        np.asarray(jba._segment_blocks(jnp.asarray(x.numpy()), je.starts,
                                       je.ends)), rtol=1e-12, atol=1e-12)
    JtJ, Jtb = tba._eff_normal_equations(tp, r, te, 4)
    jJtJ, jJtb = jba._eff_normal_equations(jp, jnp.asarray(r.numpy()), je, 4)
    scale = float(np.abs(np.asarray(jJtJ)).max())
    np.testing.assert_allclose(JtJ.numpy(), np.asarray(jJtJ),
                               atol=1e-9 * scale)
    np.testing.assert_allclose(Jtb.numpy(), np.asarray(jJtb),
                               atol=1e-9 * float(np.abs(np.asarray(jJtb)).max()))
    # one point's Jacobian row against central differences
    J = tba._eff_jacobian(tp, te)
    k = 20
    cam12 = torch.cat([tp[te.cam_from[k]], tp[te.cam_to[k]]])
    num = torch.zeros(2, 12, dtype=torch.float64)
    for c in range(12):
        h = 1e-6 * max(1.0, abs(float(cam12[c])))
        e = torch.zeros(12, dtype=torch.float64)
        e[c] = h
        num[:, c] = (tba._point_residual(cam12 + e, te.pt_to[k], te.pt_from[k])
                     - tba._point_residual(cam12 - e, te.pt_to[k],
                                           te.pt_from[k])) / (2 * h)
    np.testing.assert_allclose(J[k].numpy(), num.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bad_damping_raises():
    to_pos, from_pos, valid, f = synth_pairs(np.random.default_rng(1))
    t, _ = both_problems(to_pos, from_pos, valid)
    with pytest.raises(ValueError, match="positive"):
        tba.ba_optimize(torch.zeros(3, 6, dtype=torch.float64), t, 1, 3, 0.0)
