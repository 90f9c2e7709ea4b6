"""The host LM's C routine (``camera/ba_pairs.py``, ``csrc/ba_pairs.c``)
against the torch chain it stands in for on CPU tensors.

``camera/bundle_adjuster.py``'s torch chain (``_pairs_residuals``,
``_pairs_ne_blocks``, ``_pairs_normal_equations``, ``assemble_scatter``)
stays the plain version, and the card's route.  On the same problems the C
routine gives:
- the residuals, the per-slot blocks Bp / bp (each slot against its own
  largest value) and the dense JtJ / Jtb within rel 1e-12, on problems with
  padding rows holding stray coordinates, inactive slots, swapped pairs,
  the frozen identity rotation, a camera at zero rotation and one in
  Rodrigues' small-angle branch;
- JtJ / Jtb equal, bit for bit, to ``assemble_scatter`` of its own blocks
  (the slot order), and the same bits on a second call;
- the depth clamp at a point with u_2 = 0;
- NaN at the torch chain's positions for a NaN point;
- ``ba_optimize_pairs`` and ``estimate_cameras``: the iterations of the
  torch chain and parameters within rel 1e-9, ``ba_pairs.calls`` one a
  call into C; under ``OPENPANO_CHECK_NUMERICS=1`` a NaN point raises the
  torch chain's ``NumericsError``, word for word.
No JAX: the JAX parity of the LM is ``tests/test_torch_camera.py``'s.
"""

import numpy as np
import pytest
import torch

from openpano_torch import Config
from openpano_torch.camera import ba_pairs
from openpano_torch.camera import bundle_adjuster as tba
from openpano_torch.camera.estimator import estimate_cameras
from openpano_torch.utils.debug import NumericsError

T = torch.from_numpy
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module: its Python loops issue many
    small ops, and the test workers share the CPU, so more threads would
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _rel_slots(a, b) -> float:
    """The largest relative gap of a slot, each against its own largest
    value; slots that are zero in ``b`` must be zero in ``a``."""
    return max(_rel(x, y) for x, y in zip(np.asarray(a), np.asarray(b)))


def _params(n, rng):
    """Cameras yawing 0.3 rad apart about focal 700 with small principal
    points; camera 0 at zero rotation, camera 1 in the small-angle
    branch (|v|^2 < 1e-14)."""
    params = np.zeros((n, 6))
    params[:, 0] = 700.0 * (1 + 0.05 * rng.normal(size=n))
    params[:, 1:3] = rng.normal(size=(n, 2)) * 3.0
    params[:, 3:6] = rng.normal(size=(n, 3)) * 0.05
    params[:, 4] += (np.arange(n) - n // 2) * 0.3
    params[0, 3:6] = 0.0
    params[1, 3:6] = rng.normal(size=3) * 1e-9
    return params


def _problem(seed, n=6, M=32):
    """A pair-major problem over every pair of cameras within two steps and
    the wrap pair, one slot each, then two inactive slots: points through
    the true cameras with 1 px of noise, fewer valid rows each slot (the
    padding rows hold stray coordinates), every third slot swapped.
    Returns (perturbed start [n, 6], problem, n)."""
    rng = np.random.default_rng(seed)
    truth = _params(n, rng)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, min(a + 3, n))]
    pairs += [(0, n - 1), (1, 2), (2, 4)]
    P = len(pairs)
    cam_to = np.array([a for a, _ in pairs], np.int64)
    cam_from = np.array([b for _, b in pairs], np.int64)
    pt_to = rng.uniform(-300, 300, size=(P, M, 2))
    Ht = tba._rows_H(T(truth), T(cam_from), T(cam_to)).numpy()
    ph = np.einsum("pij,pmj->pmi", Ht,
                   np.concatenate([pt_to, np.ones((P, M, 1))], -1))
    pt_from = ph[..., :2] / ph[..., 2:] + rng.normal(size=(P, M, 2))
    w = np.zeros((P, M))
    for p in range(P):
        w[p, : M - p] = 1.0
        pt_to[p, M - p:] = rng.uniform(-1e4, 1e4, size=(p, 2))
    swapped = np.arange(P) % 3 == 1
    pair_w = np.ones(P)
    pair_w[-2:] = 0.0
    prob = tba.BAPairProblem(
        pt_to=T(pt_to), pt_from=T(pt_from), w=T(w), cam_to=T(cam_to),
        cam_from=T(cam_from), swapped=T(swapped), pair_w=T(pair_w))
    start = truth.copy()
    start[:, 0] *= 1.03
    start[:, 3:6] += rng.normal(size=(n, 3)) * 0.01
    start[:2, 3:6] = truth[:2, 3:6]
    return start, prob, n


def _upd(n, identity):
    upd = torch.ones(n, 6, dtype=torch.float64)
    upd[identity, 3:] = 0.0
    return upd


def _host(prob, n, identity=0):
    return ba_pairs.HostPairs(*tba._pairs_eff(prob), _upd(n, identity), n)


def _outputs(params, prob, n, identity=0):
    """(residuals, Bp, bp, JtJ, Jtb) of the torch chain and of the C
    routine, both at the torch chain's residuals; the C's copied out of
    its buffers."""
    upd = _upd(n, identity)
    p = T(params)
    r, _ = tba._pairs_residuals(p, prob)
    want = (r, *tba._pairs_ne_blocks(p, r, prob, upd)[:2],
            *tba._pairs_normal_equations(p, r, prob, n, upd))
    host = _host(prob, n, identity)
    rc = host.residuals(p)[0].clone()
    Bp, bp = (t.clone() for t in host.blocks(p, r)[:2])
    JtJ, Jtb = (t.clone() for t in host.normal_equations(p, r))
    return [t.numpy() for t in want], [t.numpy() for t in (rc, Bp, bp, JtJ,
                                                            Jtb)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_torch_chain(seed):
    params, prob, n = _problem(seed)
    assert (params[0, 3:] == 0).all()
    assert (params[1, 3:] ** 2).sum() < 1e-14 < (params[2, 3:] ** 2).sum()
    (r, Bp, bp, JtJ, Jtb), (rc, Bpc, bpc, JtJc, Jtbc) = _outputs(
        params, prob, n, identity=n // 2)
    assert _rel(rc, r) < TOL
    assert _rel_slots(Bpc, Bp) < TOL
    assert _rel_slots(bpc, bp) < TOL
    assert _rel(JtJc, JtJ) < TOL
    assert _rel(Jtbc, Jtb) < TOL
    # the inactive slots add nothing; the frozen rotation has zero columns
    assert not Bpc[-2:].any() and not bpc[-2:].any()
    frozen = np.arange(6 * n) // 6 == n // 2
    frozen &= np.arange(6 * n) % 6 >= 3
    assert not JtJc[frozen].any() and not Jtbc[frozen].any()
    np.testing.assert_array_equal(rc[prob.w.numpy() == 0], 0.0)
    np.testing.assert_array_equal(rc[prob.pair_w.numpy() == 0], 0.0)


def test_dense_assembly_is_slot_order_and_repeatable():
    params, prob, n = _problem(3)
    p = T(params)
    r, _ = tba._pairs_residuals(p, prob)
    host = _host(prob, n)
    Bp, bp, F, Tc = (t.clone() for t in host.blocks(p, r))
    JtJ, Jtb = (t.clone() for t in host.normal_equations(p, r))
    offs = torch.arange(6)
    rows = torch.cat([F[:, None] * 6 + offs, Tc[:, None] * 6 + offs], 1)
    want_A, want_b = tba.assemble_scatter(Bp, bp, rows, n * 6)
    assert torch.equal(JtJ, want_A) and torch.equal(Jtb, want_b)
    again = _host(prob, n).normal_equations(p, r)
    assert torch.equal(again[0], JtJ) and torch.equal(again[1], Jtb)
    assert torch.equal(Bp, Bp.transpose(1, 2))


def test_zero_depth_point_is_clamped():
    """From camera 0 turned a quarter turn about y, to camera 1 at zero
    rotation with focal 1 and no principal point: H's last row is R_0's,
    (-1, 0, c) with c about 6e-17, so the point (c, y) has |u_2| of the
    order of 1e-33."""
    rng = np.random.default_rng(4)
    params = np.array([[600.0, 2.0, -1.0, 0.0, np.pi / 2, 0.0],
                       [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    F, Tc = torch.tensor([0, 0]), torch.tensor([1, 1])
    H = tba._rows_H(T(params), F, Tc)[0].numpy()
    assert H[2, 1] == 0.0 and abs(H[2, 0] + 1.0) < 1e-15
    M = 8
    pt_to = rng.uniform(-1, 1, size=(2, M, 2))
    pt_to[0, 3] = [-H[2, 2] / H[2, 0], 0.7]
    assert abs(H[2] @ [*pt_to[0, 3], 1.0]) <= 1e-20
    prob = tba.BAPairProblem(
        pt_to=T(pt_to), pt_from=T(rng.uniform(-300, 300, size=(2, M, 2))),
        w=torch.ones(2, M, dtype=torch.float64), cam_to=Tc, cam_from=F,
        swapped=torch.tensor([False, False]),
        pair_w=torch.ones(2, dtype=torch.float64))
    (r, Bp, bp, JtJ, Jtb), (rc, Bpc, bpc, JtJc, Jtbc) = _outputs(
        params, prob, 2)
    assert np.isfinite(rc).all() and np.abs(rc[0, 3]).max() > 1e18
    assert _rel_slots(rc, r) < TOL
    assert _rel_slots(Bpc, Bp) < TOL and _rel_slots(bpc, bp) < TOL


def test_nan_point_gives_the_same_nans():
    params, prob, n = _problem(5)
    pt_to = prob.pt_to.clone()
    pt_to[2, 5, 0] = float("nan")                    # an active row
    prob = prob._replace(pt_to=pt_to)
    want, got = _outputs(params, prob, n)
    for name, w, g in zip(("resid", "Bp", "bp", "JtJ", "Jtb"), want, got):
        nan = np.isnan(w)
        assert nan.any(), name
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=name)
        assert np.isfinite(g[~nan]).all(), name
        assert _rel(g[~nan], w[~nan]) < TOL, name


def test_refuses_what_it_cannot_read():
    params, prob, n = _problem(6)
    host = _host(prob, n)
    with pytest.raises(ValueError, match="float64"):
        host.residuals(T(params).float())
    with pytest.raises(ValueError, match="values where"):
        host.residuals(T(params[:-1]))
    bad = prob._replace(cam_from=prob.cam_from.clone().fill_(n))
    with pytest.raises(IndexError):
        _host(bad, n).residuals(T(params))


@pytest.mark.parametrize("adaptive,banded,rel_tol", [
    (True, False, 0.0), (False, False, 0.0), (True, True, 0.0),
    (True, False, 0.02)])
def test_lm_matches_torch_chain(monkeypatch, adaptive, banded, rel_tol):
    params, prob, n = _problem(7, n=5)
    if banded:       # a ring: the chain and the wrap pair only
        keep = ((prob.cam_from - prob.cam_to) == 1) | (
            (prob.cam_to == 0) & (prob.cam_from == n - 1))
        prob = tba.BAPairProblem(*(t[keep] for t in prob))
    kw = dict(adaptive=adaptive, max_iter=40, patience=5, rel_tol=rel_tol,
              banded=banded)
    before = ba_pairs.calls
    pc, itc = tba.ba_optimize_pairs(T(params), prob, n // 2, n, 5.0, **kw)
    assert ba_pairs.calls - before == 1 + 2 * itc
    monkeypatch.setattr(tba, "_host_route", lambda t: False)
    before = ba_pairs.calls
    pt, itt = tba.ba_optimize_pairs(T(params), prob, n // 2, n, 5.0, **kw)
    assert ba_pairs.calls == before
    assert itc == itt > 3
    assert _rel(pc.numpy(), pt.numpy()) < 1e-9
    np.testing.assert_array_equal(pc.numpy()[n // 2, 3:], params[n // 2, 3:])


N_CAM, VIEW_W, VIEW_H, M_MATCH = 6, 320.0, 240.0, 64


def _graph(seed=0):
    """estimate_cameras' inputs for six cameras of focal 500 yawing 0.25 rad
    apart: each pair within two steps holds its true homography and up to
    40 correspondences with 0.3 px of noise."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((N_CAM, 6))
    truth[:, 0] = 500.0
    truth[:, 4] = (np.arange(N_CAM) - N_CAM // 2) * 0.25
    n = N_CAM
    conf = np.zeros((n, n))
    homos = np.tile(np.eye(3), (n, n, 1, 1))
    to_pos = np.zeros((n, n, M_MATCH, 2))
    from_pos = np.zeros((n, n, M_MATCH, 2))
    valid = np.zeros((n, n, M_MATCH), bool)
    for i in range(n):
        for j in range(i + 1, min(i + 3, n)):
            Hij = tba._rows_H(T(truth), torch.tensor([i]),
                              torch.tensor([j]))[0].numpy()   # j -> i
            pf = rng.uniform([-VIEW_W / 2, -VIEW_H / 2],
                             [VIEW_W / 2, VIEW_H / 2], size=(120, 2))
            ph = np.concatenate([pf, np.ones((120, 1))], 1) @ Hij.T
            pt = ph[:, :2] / ph[:, 2:]
            keep = ((np.abs(pt[:, 0]) < VIEW_W / 2)
                    & (np.abs(pt[:, 1]) < VIEW_H / 2))
            pt, pf = pt[keep][:40], pf[keep][:40]
            pt = pt + rng.normal(scale=0.3, size=pt.shape)
            k = len(pt)
            assert k >= 12
            for a, b, P_a, P_b, Hab in ((i, j, pt, pf, Hij),
                                        (j, i, pf, pt, np.linalg.inv(Hij))):
                to_pos[a, b, :k], from_pos[a, b, :k] = P_a, P_b
                valid[a, b, :k] = True
                homos[a, b] = Hab / Hab[2, 2]
            conf[i, j] = conf[j, i] = k / (8.0 + 0.3 * k)
    whs = np.tile([VIEW_W, VIEW_H], (n, 1))
    return conf, homos, to_pos, from_pos, valid, whs


@pytest.mark.parametrize("multipass", [1, 2, 0])
def test_estimator_matches_torch_chain(monkeypatch, multipass):
    g = _graph()
    cfg = Config(MULTIPASS_BA=multipass)
    st_c = {}
    before = ba_pairs.calls
    cams_c = estimate_cameras(*g, cfg, stats=st_c)
    assert ba_pairs.calls - before > st_c["lm_iters"] > 0
    monkeypatch.setattr(tba, "_host_route", lambda t: False)
    st_t = {}
    cams_t = estimate_cameras(*g, cfg, stats=st_t)
    assert st_c["lm_iters"] == st_t["lm_iters"]
    assert _rel(cams_c.focal, cams_t.focal) < 1e-9
    assert np.abs(cams_c.R - cams_t.R).max() < 1e-9
    assert abs(st_c["ba_rms_px"] - st_t["ba_rms_px"]) < 1e-9
    assert st_c["ba_rms_px"] < 1.0


def test_numeric_checks_name_the_same_iteration(monkeypatch):
    """A NaN inlier of pair (1, 2) under OPENPANO_CHECK_NUMERICS=1: both
    routes raise at the same LM run and iteration, with the same count and
    first index of non-finite residuals."""
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    g = _graph()
    g[2][1, 2, 4, 0] = np.nan
    assert g[4][1, 2, 4]
    with pytest.raises(NumericsError, match=r"\[ba_lm\[\d+\] iteration \d+\] "
                                            r"'residuals'") as got:
        estimate_cameras(*g, Config())
    monkeypatch.setattr(tba, "_host_route", lambda t: False)
    with pytest.raises(NumericsError) as want:
        estimate_cameras(*g, Config())
    assert str(got.value) == str(want.value)
