"""Port parity for the camera stack and the window-slab kernel (K3).

The same numpy-seeded inputs go through the JAX package's functions and the
port's, on the CPU:
- rotations (Rodrigues, its derivative, the inverse), small-angle branches
  included: abs 1e-12;
- the focal estimates and ``straighten``: equal;
- the spanning-tree walk: equal root and edges, and the disconnected error;
- the pair-major normal equations on a fixed problem: rel 1e-10;
- one LM pass (``ba_optimize_pairs``): equal iteration count, parameters
  within rel 1e-8;
- the banded solver and its assembly: 1e-10;
- the whole estimator on a synthetic rotation panorama: equal total LM
  iterations, focal rel 1e-6, R abs 1e-6, ``ba_rms_px`` within 1e-6;
- K3's plain version against ``gather_window_slabs`` (the XLA path and the
  Pallas kernel in interpret mode), batched too: bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
import openpano_tpu.ops.windows as jwin
from openpano_tpu.camera import banded as jband
from openpano_tpu.camera import bundle_adjuster as jba
from openpano_tpu.camera import camera as jcam
from openpano_tpu.camera import estimator as jest
from openpano_tpu.camera import rotation as jrot
from openpano_tpu.config import Config as JConfig
from openpano_torch.camera import banded as tband
from openpano_torch.camera import bundle_adjuster as tba
from openpano_torch.camera import camera as tcam
from openpano_torch.camera import estimator as t_est
from openpano_torch.camera import rotation as trot
from openpano_torch.compat import config_from_fields
from openpano_torch.ops import windows as twin

T = torch.from_numpy


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _axis_angles(seed, n=64):
    """Rotation vectors at every scale, small-angle branch included."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    scale = np.concatenate([np.full(n // 4, 1e-9), np.full(n // 4, 1e-6),
                            np.full(n // 4, 0.5), np.full(n - 3 * (n // 4), 2.5)])
    v = v * scale[:, None]
    v[0] = 0.0
    return v


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_rodrigues_and_derivative_match_jax(seed):
    v = _axis_angles(seed)
    R_j = np.asarray(jrot.rodrigues(jnp.asarray(v)))
    R_t = trot.rodrigues(T(v)).numpy()
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-12)
    dR_j = np.asarray(jrot.drodrigues(jnp.asarray(v), jnp.asarray(R_j)))
    dR_t = trot.drodrigues(T(v), T(R_j)).numpy()
    assert dR_t.shape == dR_j.shape == (64, 3, 3, 3)
    np.testing.assert_allclose(dR_t, dR_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_rotation_to_angle_matches_jax(seed):
    """Angles where arccos is well conditioned (at theta near 0 or pi an ulp
    of the trace moves theta by ~1e-8 in either package), and the exact
    small-angle branch (|r| < 1e-7 gives 0)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.concatenate([rng.uniform(0.05, 3.0, 48), np.full(16, 2e-9)])
    v = axis * theta[:, None]
    # nearly orthonormal input: the SVD re-orthogonalization matters
    R = np.asarray(jrot.rodrigues(jnp.asarray(v)))
    R = R + np.random.default_rng(seed).normal(size=R.shape) * 1e-9
    got = trot.rotation_to_angle(T(R)).numpy()
    want = np.asarray(jrot.rotation_to_angle(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_host_rodrigues_copies_match_jax():
    for v in _axis_angles(4, 16):
        np.testing.assert_array_equal(t_est._np_rod(v), jest._np_rod(v))
        R = jest._np_rod(v)
        np.testing.assert_array_equal(t_est._np_unrod(R), jest._np_unrod(R))


# ---------------------------------------------------------------------------
# focal estimates, straighten, the tree walk
# ---------------------------------------------------------------------------


def _rot_np(v):
    return jest._np_rod(np.asarray(v, np.float64))


def synth_rotation_pano(rng, n=5, f=700.0, noise=0.0, M=64):
    """Cameras yawing with a little pitch and roll; matches are reprojected
    grid points (the set of tests/test_camera.py, built with numpy)."""
    yaws = (np.arange(n) - n // 2) * 0.15
    Rs = [_rot_np([rng.normal() * 0.02, y, rng.normal() * 0.02]) for y in yaws]
    K = tcam.intrinsic(f, 0, 0)
    homos = np.zeros((n, n, 3, 3))
    conf = np.zeros((n, n))
    to_pos = np.zeros((n, n, M, 2))
    from_pos = np.zeros((n, n, M, 2))
    valid = np.zeros((n, n, M), bool)
    for i in range(n):
        for j in range(n):
            if abs(i - j) != 1:
                continue
            H = K @ Rs[i].T @ Rs[j] @ np.linalg.inv(K)  # j -> i
            homos[i, j] = H / H[2, 2]
            conf[i, j] = 0.5
            pts_j = rng.uniform(-250, 250, size=(M, 2))
            p = np.concatenate([pts_j, np.ones((M, 1))], 1) @ homos[i, j].T
            to_pos[i, j] = p[:, :2] / p[:, 2:3] + rng.normal(size=(M, 2)) * noise
            from_pos[i, j] = pts_j
            valid[i, j] = True
    return conf, homos, to_pos, from_pos, valid, f, Rs


def _garbage_focal_set(rng, n=20, f=1786.0):
    """Pairs whose homographies come from a true focal (a third) and from a
    scattered wrong one (the rest): the robust estimate's case."""
    conf = np.zeros((n, n))
    homos = np.zeros((n, n, 3, 3))
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            if k >= 60:
                break
            conf[i, j] = conf[j, i] = 1.0
            fk = f if k % 3 == 0 else rng.uniform(250, 900)
            K = tcam.intrinsic(fk, 0, 0)
            H = K @ _rot_np(rng.normal(size=3) * 0.3) @ np.linalg.inv(K)
            homos[i, j] = H / H[2, 2]
            k += 1
    return conf, homos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_focal_estimates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    conf, homos, *_ = synth_rotation_pano(rng, n=6, noise=0.3)
    for i in range(6):
        for j in range(6):
            assert tcam.focal_from_homography(homos[i, j]) == \
                jcam.focal_from_homography(homos[i, j])
    assert tcam.estimate_focal(conf, homos) == jcam.estimate_focal(conf, homos)
    assert tcam.estimate_focal_robust(conf, homos) == \
        jcam.estimate_focal_robust(conf, homos)
    conf, homos = _garbage_focal_set(rng)
    assert tcam.estimate_focal(conf, homos) == jcam.estimate_focal(conf, homos)
    assert tcam.estimate_focal_robust(conf, homos) == \
        jcam.estimate_focal_robust(conf, homos)
    assert tcam.estimate_focal(np.zeros((4, 4)), np.zeros((4, 4, 3, 3))) == -1.0


def test_straighten_equals_jax():
    tilt = _rot_np([0.2, 0.0, 0.1])
    R = np.stack([_rot_np([0.0, y, 0.0]) @ tilt
                  for y in np.linspace(-0.5, 0.5, 7)])
    kw = dict(focal=np.full(7, 500.0), ppx=np.zeros(7), ppy=np.zeros(7))
    got = tcam.straighten(tcam.CameraSet(R=R, **kw))
    want = jcam.straighten(jcam.CameraSet(R=R, **kw))
    np.testing.assert_array_equal(got.R, want.R)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spanning_tree_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 9
    conf = np.triu(rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.5), 1)
    conf[np.arange(n - 1), np.arange(1, n)] = 0.3     # connected
    conf[2, 5] = conf[0, 1] = 0.3                      # ties
    conf = conf + conf.T
    assert t_est.traverse_spanning_tree(conf) == \
        jest.traverse_spanning_tree(conf)


def test_spanning_tree_disconnected_raises_like_jax():
    conf = np.zeros((4, 4))
    conf[0, 1] = conf[1, 0] = 0.9
    conf[2, 3] = conf[3, 2] = 0.5
    with pytest.raises(RuntimeError) as jerr:
        jest.traverse_spanning_tree(conf)
    with pytest.raises(RuntimeError) as terr:
        t_est.traverse_spanning_tree(conf)
    assert str(terr.value) == str(jerr.value)
    assert "not connected" in str(terr.value)


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------


def _pair_problem(seed, n=5, M=32):
    """A pair-major problem over the chain (i, i+1) plus the wrap pair, one
    slot per pair, padding rows and one inactive slot; perturbed start."""
    rng = np.random.default_rng(seed)
    conf, homos, to_pos, from_pos, valid, f, _ = synth_rotation_pano(
        rng, n=n, noise=0.3, M=M)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    P = len(pairs) + 1
    pt_to = np.zeros((P, M, 2))
    pt_from = np.zeros((P, M, 2))
    w = np.zeros((P, M))
    cam_to = np.zeros(P, np.int64)
    cam_from = np.zeros(P, np.int64)
    for p, (a, b) in enumerate(pairs):
        if (a, b) == (0, n - 1):          # the wrap pair: make-up matches
            pts = rng.uniform(-200, 200, size=(M, 2))
            pt_to[p], pt_from[p] = pts, pts + rng.normal(size=(M, 2))
        else:
            pt_to[p], pt_from[p] = to_pos[a, b], from_pos[a, b]
        w[p, : M - 3 * p] = 1.0          # padding rows
        cam_to[p], cam_from[p] = a, b
    swapped = np.arange(P) % 2 == 1
    pair_w = np.ones(P)
    pair_w[-1] = 0.0                     # inactive slot
    params = np.zeros((n, 6))
    params[:, 0] = f * 1.1
    params[:, 3:6] = rng.normal(size=(n, 3)) * 0.05
    params[:, 4] += (np.arange(n) - n // 2) * 0.15
    arrays = dict(pt_to=pt_to, pt_from=pt_from, w=w, cam_to=cam_to,
                  cam_from=cam_from, swapped=swapped, pair_w=pair_w)
    jprob = jba.BAPairProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tprob = tba.BAPairProblem(**{k: T(v) for k, v in arrays.items()})
    return params, jprob, tprob, n


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_equations_match_jax(seed):
    params, jprob, tprob, n = _pair_problem(seed)
    upd = np.ones((n, 6))
    upd[n // 2, 3:] = 0.0
    rj, _ = jba._pairs_residuals(jnp.asarray(params), jprob)
    rt, _ = tba._pairs_residuals(T(params), tprob)
    assert _rel(rt.numpy(), rj) < 1e-10
    Bj, bj, Fj, Tj = jba._pairs_ne_blocks(jnp.asarray(params), rj, jprob,
                                          jnp.asarray(upd))
    Bt, bt, Ft, Tt = tba._pairs_ne_blocks(T(params), T(np.asarray(rj)), tprob,
                                          T(upd))
    np.testing.assert_array_equal(Ft.numpy(), Fj)
    np.testing.assert_array_equal(Tt.numpy(), Tj)
    assert _rel(Bt.numpy(), Bj) < 1e-10
    assert _rel(bt.numpy(), bj) < 1e-10
    JtJ_j, Jtb_j = jba._pairs_normal_equations(jnp.asarray(params), rj, jprob,
                                               n, jnp.asarray(upd))
    JtJ_t, Jtb_t = tba._pairs_normal_equations(T(params), T(np.asarray(rj)),
                                               tprob, n, T(upd))
    assert _rel(JtJ_t.numpy(), JtJ_j) < 1e-10
    assert _rel(Jtb_t.numpy(), Jtb_j) < 1e-10


def test_scaled_cholesky_solve_matches_jax():
    rng = np.random.default_rng(5)
    J = rng.normal(size=(400, 96))
    scales = 10.0 ** rng.uniform(-2, 5, 96)
    A = (J.T @ J) * scales[:, None] * scales[None, :] + np.eye(96) * 10.0
    b = rng.normal(size=96) * scales
    got = tba.solve_sym_scaled_chol(T(A), T(b)).numpy()
    want = np.asarray(jba.solve_sym_scaled_chol(jnp.asarray(A), jnp.asarray(b)))
    assert _rel(got, want) < 1e-10
    # not SPD: NaN, as jnp.linalg.cholesky gives, and nothing raises
    bad = tba.solve_sym_scaled_chol(T(-A), T(b)).numpy()
    assert np.isnan(bad).all()


@pytest.mark.parametrize("adaptive,banded,rel_tol", [
    (True, False, 0.0), (False, False, 0.0), (True, True, 0.0),
    (True, False, 0.02)])
def test_lm_pass_matches_jax(adaptive, banded, rel_tol):
    params, jprob, tprob, n = _pair_problem(3)
    kw = dict(adaptive=adaptive, max_iter=40, patience=5, rel_tol=rel_tol,
              banded=banded)
    pj, itj = jba.ba_optimize_pairs(jnp.asarray(params), jprob,
                                    jnp.asarray(n // 2), n, 5.0,
                                    return_iters=True, **kw)
    pt, itt = tba.ba_optimize_pairs(T(params), tprob, n // 2, n, 5.0, **kw)
    assert itt == int(itj)
    assert itt > 3
    assert _rel(pt.numpy(), pj) < 1e-8
    # the identity camera's rotation never moves
    np.testing.assert_array_equal(pt.numpy()[n // 2, 3:], params[n // 2, 3:])


def _banded_system(seed, n=7):
    """Chain pairs in both orientations plus the wrap pair."""
    rng = np.random.default_rng(seed)
    F = np.concatenate([np.arange(n - 1), [n - 1], np.arange(1, n)])
    Tc = np.concatenate([np.arange(1, n), [0], np.arange(n - 1)])
    Jb = rng.normal(size=(len(F), 40, 12))
    Bp = np.einsum("pti,ptj->pij", Jb, Jb)
    bp = rng.normal(size=(len(F), 12))
    return Bp, bp, F.astype(np.int64), Tc.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_assembly_and_solve_match_jax(seed):
    n = 7
    Bp, bp, F, Tc = _banded_system(seed, n)
    assert tband.is_chain_structure(F, Tc, n) == \
        jband.is_chain_structure(F, Tc, n) is True
    got = tband.assemble_banded(T(Bp), T(bp), T(F), T(Tc), n)
    want = jband.assemble_banded(jnp.asarray(Bp), jnp.asarray(bp),
                                 jnp.asarray(F), jnp.asarray(Tc), n)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-10
    D, U, C, rhs = (np.asarray(w) for w in want)
    D = D + np.eye(6)[None] * 50.0
    xs_t = tband.solve_block_cyclic(T(D), T(U), T(C), T(rhs)).numpy()
    xs_j = np.asarray(jband.solve_block_cyclic(*map(jnp.asarray, (D, U, C, rhs))))
    assert _rel(xs_t, xs_j) < 1e-10
    xs_t = tband.solve_block_cyclic(T(D), T(U), None, T(rhs)).numpy()
    xs_j = np.asarray(jband.solve_block_cyclic(jnp.asarray(D), jnp.asarray(U),
                                               None, jnp.asarray(rhs)))
    assert _rel(xs_t, xs_j) < 1e-10


# ---------------------------------------------------------------------------
# the whole estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multipass,straighten", [(1, False), (1, True),
                                                  (2, True), (0, True)])
def test_estimate_cameras_matches_jax(multipass, straighten):
    rng = np.random.default_rng(42)
    conf, homos, to_pos, from_pos, valid, f, _ = synth_rotation_pano(
        rng, n=5, noise=0.2)
    whs = np.repeat([[640.0, 480.0]], 5, 0)
    jcfg = JConfig(STRAIGHTEN=straighten, MULTIPASS_BA=multipass)
    tcfg = config_from_fields(dataclasses.asdict(jcfg))
    js, ts = {}, {}
    want = jest.estimate_cameras(conf, homos, to_pos, from_pos, valid, whs,
                                 jcfg, stats=js)
    got = t_est.estimate_cameras(conf, homos, to_pos, from_pos, valid, whs,
                                 tcfg, stats=ts, device="cpu")
    assert ts["lm_iters"] == js["lm_iters"] > 0
    assert (ts["ba_points"], ts["ba_pairs"]) == (js["ba_points"], js["ba_pairs"])
    assert abs(ts["ba_rms_px"] - js["ba_rms_px"]) < 1e-6
    assert _rel(got.focal, want.focal) < 1e-6
    np.testing.assert_allclose(got.R, want.R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.focal, f, rtol=0.05)


# ---------------------------------------------------------------------------
# K3: the window-slab gather
# ---------------------------------------------------------------------------


def _slab_case(seed, S=3, H=100, W=300, K=40, B=None):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    a = rng.uniform(size=lead + (S, H, W)).astype(np.float32)
    b = rng.uniform(size=lead + (S, H, W)).astype(np.float32)
    s = rng.integers(-1, S + 1, lead + (K,)).astype(np.int32)  # out of range too
    y = rng.integers(-4, H + 4, lead + (K,)).astype(np.int32)
    x = rng.integers(-4, W + 4, lead + (K,)).astype(np.int32)
    # every border
    y.reshape(-1, K)[:, :4] = [0, H - 1, 0, H - 1]
    x.reshape(-1, K)[:, :4] = [0, 0, W - 1, W - 1]
    return a, b, s, y, x


@pytest.mark.parametrize("S,H,W,WR", [(3, 100, 300, 32), (2, 20, 64, 24),
                                      (4, 61, 397, 56), (1, 203, 130, 8)])
def test_gather_window_slabs_plain_equals_jax(S, H, W, WR):
    a, b, s, y, x = _slab_case(S + H, S=S, H=H, W=W)
    ja, jb = jwin.gather_window_slabs(*map(jnp.asarray, (a, b, s, y, x)), WR)
    ta, tb = twin.gather_window_slabs(*map(T, (a, b, s, y, x)), WR)
    assert ta.shape == (40, WR, 256)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_gather_window_slabs_equals_pallas_interpret():
    a, b, s, y, x = _slab_case(9, S=3, H=61, W=397, K=24)
    WR = 32
    jwin.INTERPRET = True
    try:
        ja, jb = jax.jit(lambda *v: jwin.gather_window_slabs(*v, WR=WR))(
            *map(jnp.asarray, (a, b, s, y, x)))
    finally:
        jwin.INTERPRET = False
    ta, tb = twin.gather_window_slabs(*map(T, (a, b, s, y, x)), WR)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("interpret", [False, True])
def test_gather_window_slabs_batch_folds_like_vmap(interpret):
    a, b, s, y, x = _slab_case(11, S=3, H=50, W=140, K=16, B=3)
    s = np.clip(s, 0, 2)        # out of range would cross into another batch
    WR = 24
    f = jax.vmap(lambda p, q, s, y, x: jwin.gather_window_slabs(
        p, q, s, y, x, WR=WR))
    jwin.INTERPRET = interpret
    try:
        ja, jb = jax.jit(f)(*map(jnp.asarray, (a, b, s, y, x)))
    finally:
        jwin.INTERPRET = False
    before = twin.gather_window_slabs.launches
    ta, tb = twin.gather_window_slabs(*map(T, (a, b, s, y, x)), WR)
    assert twin.gather_window_slabs.launches == before   # CPU: plain version
    assert ta.shape == (3, 16, WR, 256)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_gather_window_slabs_refuses_bad_rows():
    a, b, s, y, x = map(T, _slab_case(1, K=4))
    for WR in (0, 12, 30):
        with pytest.raises(ValueError, match="multiple of 8"):
            twin.gather_window_slabs(a, b, s, y, x, WR)


def test_scatter_assembly_adds_in_slot_order():
    """The accumulating index_put_ that assembles JtJ and Jtb against the
    blocks added one slot after another, on the CPU: the same bits."""
    params, _, tprob, n = _pair_problem(4)
    r, _ = tba._pairs_residuals(T(params), tprob)
    Bp, bp, F, Tc = tba._pairs_ne_blocks(T(params), r, tprob)
    offs = torch.arange(6)
    rows = torch.cat([F[:, None] * 6 + offs, Tc[:, None] * 6 + offs], 1)
    JtJ, Jtb = tba.assemble_scatter(Bp, bp, rows, n * 6)
    want_A = torch.zeros(n * 6, n * 6, dtype=torch.float64)
    want_b = torch.zeros(n * 6, dtype=torch.float64)
    for p in range(rows.shape[0]):
        for i in range(12):
            want_b[rows[p, i]] += bp[p, i]
            for j in range(12):
                want_A[rows[p, i], rows[p, j]] += Bp[p, i, j]
    assert torch.equal(JtJ, want_A) and torch.equal(Jtb, want_b)
