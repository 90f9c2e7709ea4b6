"""Levenberg-Marquardt bundle adjustment over camera parameters.

Reference: stitch/incremental_bundle_adjuster.{hh,cc}; counterpart of
``openpano_tpu/camera/bundle_adjuster.py``: the pair-major problem the
camera estimator runs (``ba_optimize_pairs``), and the point-major one with
pair-contiguous segments (``BAProblem``, ``ba_optimize``,
``pairs_to_points``), whose per-pair normal-equation blocks are
cumulative-sum differences over each pair's rows.  Six parameters per camera (focal, ppx, ppy, three
Rodrigues); the residual of every match point is its pixel reprojection
error through H = K_f R_f R_t^T K_t^-1 (calcError, .cc:171-197).

The LM loop keeps the JAX package's semantics, quirks included:
- J^T r uses the residual of the most recently *evaluated* state, even after
  a rejected step, while J comes from the best accepted state
  (.cc:117-160);
- a step is accepted when the RMS drops by more than
  max(1e-3, rel_tol * best);
- it stops after ``patience`` consecutive rejections or ``max_iter`` steps;
- split damping: lambda on rotations, lambda/10 on intrinsics
  (.cc:240-248), adapted (/3 on accept, x4 on reject, clipped to
  [1e-4, 1e8]) when ``adaptive``;
- the identity camera's rotation is frozen as zeroed Jacobian COLUMNS
  (the reference never adds them to J, .cc:144-148), not by a mask after
  the solve.

Everything is float64.  The loop is a Python loop (``lax.while_loop``
there); it reads the error back each step to decide, which on the card is
one small synchronisation per iteration.  For CPU tensors each iteration's
residuals and normal equations come from one C call each (``ba_pairs``,
``csrc/ba_pairs.c``); for card tensors from the torch chain below
(``_rows_H_dH``, ``_project``, ``_pairs_ne_blocks``, ``assemble_scatter``,
``_pairs_residuals``), which the tests hold the C routine to.  With
``OPENPANO_CHECK_NUMERICS=1`` each iteration also checks its residuals,
normal equations, step, trial parameters and cost (the JAX package runs its
loop under ``checkify``'s float checks) and raises ``NumericsError`` at the
first non-finite one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.debug import NumericsError, assert_finite, \
    numeric_checks_enabled
from ..utils.timer import span
from .ba_pairs import HostPairs
from .rotation import drodrigues, rodrigues

LM_MAX_ITER = 100       # incremental_bundle_adjuster.cc:24
NR_NON_DECREASE = 5     # .cc:159


class BAPairProblem(NamedTuple):
    """Pair-major BA inputs: uniform [P, M] point slabs per pair slot;
    padding rows carry w = 0."""

    pt_to: torch.Tensor    # [P, M, 2] half-shifted coords, stored orientation
    pt_from: torch.Tensor  # [P, M, 2]
    w: torch.Tensor        # [P, M] point weight (0 = padding)
    cam_to: torch.Tensor   # [P] stored 'to' camera index
    cam_from: torch.Tensor  # [P]
    swapped: torch.Tensor  # [P] bool — flip the pair's direction
    pair_w: torch.Tensor   # [P] activation weight (0 = inactive pair)


def _pairs_eff(prob: BAPairProblem):
    """(pt_to, pt_from, wm, rows_from, rows_to) with the swap resolved."""
    sw = prob.swapped[:, None, None]
    pt_to = torch.where(sw, prob.pt_from, prob.pt_to)
    pt_from = torch.where(sw, prob.pt_to, prob.pt_from)
    rows_to = torch.where(prob.swapped, prob.cam_from, prob.cam_to)
    rows_from = torch.where(prob.swapped, prob.cam_to, prob.cam_from)
    wm = prob.w * prob.pair_w[:, None]
    return pt_to, pt_from, wm, rows_from, rows_to


def _intrinsics(params: torch.Tensor):
    """K, K^-1 [n, 3, 3] and 1/f [n] of the camera rows."""
    f, px, py = params[:, 0], params[:, 1], params[:, 2]
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    K = torch.stack([
        torch.stack([f, z, px], -1), torch.stack([z, f, py], -1),
        torch.stack([z, z, o], -1)], -2)
    fi = 1.0 / f
    Kinv = torch.stack([
        torch.stack([fi, z, -px * fi], -1), torch.stack([z, fi, -py * fi], -1),
        torch.stack([z, z, o], -1)], -2)
    return K, Kinv, fi


def _rows_H(params: torch.Tensor, F: torch.Tensor,
            Tc: torch.Tensor) -> torch.Tensor:
    """Per-pair H = K_f R_f R_t^T K_t^-1, [P, 3, 3]."""
    R = rodrigues(params[:, 3:6])
    K, Kinv, _ = _intrinsics(params)
    A = K[F] @ R[F]
    Bq = R[Tc].transpose(-1, -2) @ Kinv[Tc]
    return A @ Bq


def _rows_H_dH(params: torch.Tensor, F: torch.Tensor, Tc: torch.Tensor):
    """H [P, 3, 3] and dH/dtheta [P, 12, 3, 3] for the 12 parameters of each
    pair's (from, to) cameras, all analytic (the chain pieces at
    incremental_bundle_adjuster.cc:84-95 and dRdvi at .cc:52-81)."""
    v = params[:, 3:6]
    R = rodrigues(v)
    dR = drodrigues(v, R)                                # [n, 3, 3, 3(i)]
    K, Kinv, fi = _intrinsics(params)
    px, py = params[:, 1], params[:, 2]
    z = torch.zeros_like(fi)
    fi2 = fi * fi
    dKinv_df = torch.stack([
        torch.stack([-fi2, z, px * fi2], -1),
        torch.stack([z, -fi2, py * fi2], -1),
        torch.stack([z, z, z], -1)], -2)                 # [n, 3, 3]

    KF, RF, dRF = K[F], R[F], dR[F]
    RtT = R[Tc].transpose(-1, -2)
    KinvT = Kinv[Tc]
    A = KF @ RF
    Bq = RtT @ KinvT
    H = A @ Bq
    RB = RF @ Bq

    zero = torch.zeros_like(RB)
    # dK_f/df = diag(1, 1, 0): keep the first two rows of RB
    d_f = RB.clone()
    d_f[..., 2, :] = 0.0
    # dK_f/dppx = e1 e3^T, dK_f/dppy = e2 e3^T: move RB's third row
    d_px = zero.clone()
    d_px[..., 0, :] = RB[..., 2, :]
    d_py = zero.clone()
    d_py[..., 1, :] = RB[..., 2, :]
    d_vf = torch.einsum("pij,pjlk,plm->pkim", KF, dRF, Bq)   # [P, 3(k), 3, 3]
    ARt = A @ RtT
    d_ft = ARt @ dKinv_df[Tc]
    fiT = fi[Tc]
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=params.dtype,
                      device=params.device)[None, None, :]
    d_pxt = -(ARt[..., :, 0] * fiT[:, None])[..., :, None] * e3
    d_pyt = -(ARt[..., :, 1] * fiT[:, None])[..., :, None] * e3
    # dR_t^T/dv_k = (dR_t/dv_k)^T
    d_vt = torch.einsum("pij,pljk,plm->pkim", A, dR[Tc], KinvT)

    dH = torch.cat([
        d_f[:, None], d_px[:, None], d_py[:, None], d_vf,
        d_ft[:, None], d_pxt[:, None], d_pyt[:, None], d_vt,
    ], dim=1)                                            # [P, 12, 3, 3]
    return H, dH


def _project(H: torch.Tensor, pt_to: torch.Tensor):
    """Homogeneous points [P, M, 3], H·p [P, M, 3], the clamped depth and
    the depth mask."""
    ph = torch.cat([pt_to, torch.ones_like(pt_to[..., :1])], -1)
    u = torch.einsum("pij,pmj->pmi", H, ph)
    zok = torch.abs(u[..., 2]) > 1e-20
    zs = torch.where(zok, u[..., 2], 1e-20)
    return ph, u, zs, zok


def _pairs_residuals(params: torch.Tensor, prob: BAPairProblem):
    """Weighted residuals [P, M, 2] (calcError, .cc:171-197) and the
    effective weights [P, M]."""
    pt_to, pt_from, wm, F, Tc = _pairs_eff(prob)
    _, u, zs, _ = _project(_rows_H(params, F, Tc), pt_to)
    r = pt_from - u[..., :2] / zs[..., None]
    return r * wm[..., None], wm


def _pairs_ne_blocks(params, resid_w, prob: BAPairProblem, upd=None):
    """Per-pair normal-equation blocks: Bp [P, 12, 12], bp [P, 12] in
    [from(6) | to(6)] row order, plus the effective camera rows (F, Tc).

    ``upd`` ([n, 6], 0 = frozen parameter) zeroes the corresponding
    Jacobian COLUMNS, so the solve itself honours the freeze."""
    pt_to, _, wm, F, Tc = _pairs_eff(prob)
    H, dH = _rows_H_dH(params, F, Tc)
    ph, u, zs, zok = _project(H, pt_to)
    du = torch.einsum("pkij,pmj->pmki", dH, ph)          # [P, M, 12, 3]
    zi = 1.0 / zs
    zterm = torch.where(zok, zi * zi, 0.0)
    Jx = -(du[..., 0] * zi[..., None]
           - du[..., 2] * (u[..., 0] * zterm)[..., None])
    Jy = -(du[..., 1] * zi[..., None]
           - du[..., 2] * (u[..., 1] * zterm)[..., None])
    Jp = torch.stack([Jx, Jy], dim=-2) * wm[..., None, None]  # [P, M, 2, 12]
    P, M = wm.shape
    Jf = Jp.reshape(P, M * 2, 12)
    if upd is not None:
        Jf = Jf * torch.cat([upd[F], upd[Tc]], -1)[:, None, :]
    rw = resid_w.reshape(P, M * 2)
    Bp = torch.einsum("pti,ptj->pij", Jf, Jf)
    bp = torch.einsum("pti,pt->pi", Jf, rw)
    return Bp, bp, F, Tc


def assemble_scatter(Bp, bp, rows, n6: int):
    """JtJ [n6, n6], Jtb [n6] from per-slot blocks Bp [P, 12, 12] and bp
    [P, 12] at the rows [P, 12], by an accumulating index_put_.  On the CPU
    it adds in slot order; on the card it sorts the indices and sums each
    run of equal ones in a fixed order, without atomics, so two runs give
    the same bits (chip_smoke.py checks both)."""
    P = rows.shape[0]
    JtJ = torch.zeros(n6, n6, dtype=Bp.dtype, device=Bp.device)
    JtJ.index_put_((rows[:, :, None].expand(P, 12, 12),
                    rows[:, None, :].expand(P, 12, 12)), Bp, accumulate=True)
    Jtb = torch.zeros(n6, dtype=Bp.dtype, device=Bp.device).index_put_(
        (rows,), bp, accumulate=True)
    return JtJ, Jtb


def _pairs_normal_equations(params, resid_w, prob: BAPairProblem, n_cam: int,
                            upd=None):
    """JtJ [6n, 6n], Jtb [6n] from the per-pair blocks; rows of several
    pair slots meet in one camera block, so the blocks are summed."""
    Bp, bp, F, Tc = _pairs_ne_blocks(params, resid_w, prob, upd)
    offs = torch.arange(6, device=F.device)
    rows = torch.cat([F[:, None] * 6 + offs, Tc[:, None] * 6 + offs], 1)
    return assemble_scatter(Bp, bp, rows, n_cam * 6)


def solve_sym_scaled_chol(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f64 solve of the damped normal equations: Jacobi-scale to unit
    diagonal (the damped JtJ is SPD but badly scaled, focal^2 against
    rotation entries), Cholesky, two triangular solves.

    A factorization that fails (A not SPD) gives NaN, as ``jnp.linalg.
    cholesky`` does, so that the LM rejects the step by its error test;
    nothing raises and nothing waits for the device."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(A)), min=1e-30))
    As = A / d[:, None] / d
    bs = (b / d)[:, None]
    L, info = torch.linalg.cholesky_ex(As)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, bs, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0] / d


def _rms(r: torch.Tensor, wm: torch.Tensor, mesh=None,
         count_bad: bool = False, n2: float | None = None
         ) -> tuple[float, int]:
    """(sqrt(mean of squared residuals) over active points, two per point
    (.cc:199-220); with ``count_bad`` the number of non-finite residuals,
    else 0).  With ``mesh``, the sums are this rank's, added over the ranks
    in f64 first by one all-reduce, so that every rank reads the same cost
    and the same count.  Without, ``n2`` may give twice the active points,
    which the weights fix for a whole LM run: the same f64 quotient and
    root, without counting them again."""
    if mesh is None and not count_bad:
        if n2 is None:
            n2 = float((wm > 0).sum()) * 2.0
        return math.sqrt(float((r * r).sum()) / max(n2, 1.0)), 0
    sums = [(r * r).sum(), (wm > 0).sum().to(r.dtype) * 2.0]
    if count_bad:
        sums.append((~torch.isfinite(r)).sum().to(r.dtype))
    sums = torch.stack(sums)
    if mesh is not None:
        from ..parallel.mesh import all_reduce_sum

        sums = all_reduce_sum(mesh, sums, "ba")
    err = float(torch.sqrt(sums[0] / torch.clamp(sums[1], min=1.0)))
    return err, int(sums[2]) if count_bad else 0


def _reduced(mesh, *parts: torch.Tensor) -> list[torch.Tensor]:
    """``parts`` summed over the ranks by one f64 all-reduce (unchanged
    without a mesh)."""
    if mesh is None:
        return list(parts)
    from ..parallel.mesh import all_reduce_sum

    flat = all_reduce_sum(mesh, torch.cat([p.reshape(-1) for p in parts]),
                          "ba")
    return [v.reshape(p.shape)
            for v, p in zip(flat.split([p.numel() for p in parts]), parts)]


def _host_route(t: torch.Tensor) -> bool:
    """Whether the LM's residuals and normal equations run in C
    (``ba_pairs``): for CPU tensors, and nowhere else."""
    return t.device.type == "cpu"


def ba_optimize_pairs(params: torch.Tensor, prob: BAPairProblem,
                      identity_idx: int, n_cam: int, lm_lambda: float,
                      adaptive: bool = False, max_iter: int = LM_MAX_ITER,
                      patience: int = NR_NON_DECREASE, rel_tol: float = 0.0,
                      banded: bool = False, bucket: int | None = None,
                      mesh=None):
    """The LM loop (optimize(), .cc:117-168) over a pair-major problem, on
    the device of ``params`` and ``prob``.  params: [n, 6] float64 rows
    (focal, ppx, ppy, rx, ry, rz).  ``banded`` solves the normal equations
    by cyclic block Thomas elimination (chain/ring match graphs) instead of
    the dense Cholesky.  ``bucket`` (the slot count) names the run in a
    numeric-check failure.  Returns (optimized params [n, 6], iterations).

    ``mesh``: ``prob`` holds this rank's block of the pair slots; the normal
    equations (JtJ and Jtb, or the banded D, U, C and rhs) and the cost's
    two sums are added over the ranks in f64 before they are used, and the
    solve runs replicated.  So every value that picks a branch (the accept
    test, the rejection count, the damping) is the same on every rank, and
    every rank takes every branch and every collective together.  Under
    ``OPENPANO_CHECK_NUMERICS=1`` the same holds for a raise: the residuals,
    the one rank-local quantity checked, are counted in the cost's
    all-reduce; the rest (normal equations, step, trial parameters) are
    reduced or replicated already."""
    if not lm_lambda > 0:
        raise ValueError("LM damping must be positive (SPD precondition)")
    checks = numeric_checks_enabled()

    def check(**named):
        if checks:
            assert_finite(f"ba_lm[{bucket}] iteration {itr}", **named)

    def cost(resid, wm) -> float:
        err, bad = _rms(resid, wm, mesh, count_bad=checks and mesh is not None,
                        n2=n2)
        if bad:
            raise NumericsError(f"[ba_lm[{bucket}] iteration {itr}] "
                                f"'residuals' has {bad} non-finite values "
                                f"over the ranks")
        check(residuals=resid if mesh is None else None, cost=err)
        return err

    dt, dev = params.dtype, params.device
    upd = torch.ones(n_cam, 6, dtype=dt, device=dev)
    upd[identity_idx, 3:] = 0.0
    upd_flat = upd.reshape(-1)
    damp_unit = torch.where(torch.arange(n_cam * 6, device=dev) % 6 >= 3,
                            1.0, 0.1).to(dt)

    # the residuals and normal equations: in C for CPU tensors, else the
    # torch chain
    if _host_route(params):
        host = HostPairs(*_pairs_eff(prob), upd, n_cam)
        residuals = host.residuals
        blocks = host.blocks
        normal_equations = host.normal_equations
    else:
        residuals = lambda flat: _pairs_residuals(flat.reshape(n_cam, 6),
                                                  prob)
        blocks = lambda flat, r: _pairs_ne_blocks(flat.reshape(n_cam, 6), r,
                                                  prob, upd)
        normal_equations = lambda flat, r: _pairs_normal_equations(
            flat.reshape(n_cam, 6), r, prob, n_cam, upd)

    best_flat = params.reshape(-1)
    nr_nd, itr, lam = 0, 0, float(lm_lambda)
    resid, wm = residuals(best_flat)
    n2 = None if mesh is not None else float((wm > 0).sum()) * 2.0
    best_err = cost(resid, wm)
    while itr < max_iter and nr_nd <= patience:
        with span("cameras.lm_iter"):
            if banded:
                from .banded import assemble_banded, solve_block_cyclic

                Bp, bp, F, Tc = blocks(best_flat, resid)
                D, U, C, rhs = _reduced(mesh,
                                        *assemble_banded(Bp, bp, F, Tc, n_cam))
                check(normal_equations_D=D, normal_equations_U=U,
                      normal_equations_C=C, normal_equations_rhs=rhs)
                dvec = (damp_unit * lam).reshape(n_cam, 6)
                D = D + (torch.eye(6, dtype=dt, device=dev)[None]
                         * dvec[:, :, None])
                delta = solve_block_cyclic(D, U, C, rhs).reshape(-1)
            else:
                JtJ, Jtb = _reduced(mesh, *normal_equations(best_flat, resid))
                check(normal_equations_JtJ=JtJ, normal_equations_Jtb=Jtb)
                delta = solve_sym_scaled_chol(
                    JtJ + torch.diag(damp_unit * lam), Jtb)
            check(step=delta)
            # best - delta * upd, bit for bit: the product by 1 or 0 is exact
            new_flat = torch.addcmul(best_flat, delta, upd_flat, value=-1.0)
            check(trial_params=new_flat)
            resid, wm = residuals(new_flat)
            new_err = cost(resid, wm)
            improved = new_err < best_err - max(1e-3, rel_tol * best_err)
            if improved:
                best_flat, best_err, nr_nd = new_flat, new_err, 0
            else:
                nr_nd += 1
            if adaptive:
                lam = min(max(lam / 3.0 if improved else lam * 4.0, 1e-4), 1e8)
            itr += 1
    return best_flat.reshape(n_cam, 6), itr


# ---- the point-major problem (pair-contiguous segments) ----


class BAProblem(NamedTuple):
    """Point-major BA inputs with pair-contiguous segments.

    Per point (row t): pt_to / pt_from [T, 2] half-shifted coords in the
    stored orientation; pair_id [T] its pair slot; w [T] its static weight
    (0 = padding).  Per pair slot (s): starts / ends [P] its row range;
    cam_to / cam_from [P] the camera indices in the stored orientation;
    swapped [P] bool, True flips the pair's direction; pair_w [P] its
    activation weight (0 = not yet in the schedule)."""

    pt_to: torch.Tensor
    pt_from: torch.Tensor
    pair_id: torch.Tensor
    w: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    cam_to: torch.Tensor
    cam_from: torch.Tensor
    swapped: torch.Tensor
    pair_w: torch.Tensor


class _EffProblem(NamedTuple):
    """The problem with each pair's swap resolved into per-point data."""

    pt_to: torch.Tensor     # [T, 2]
    pt_from: torch.Tensor   # [T, 2]
    pair_id: torch.Tensor   # [T]
    cam_to: torch.Tensor    # [T]
    cam_from: torch.Tensor  # [T]
    w: torch.Tensor         # [T] combined weight
    starts: torch.Tensor
    ends: torch.Tensor
    rows_to: torch.Tensor   # [P] effective per-pair cameras, for JtJ rows
    rows_from: torch.Tensor


def _effective(prob: BAProblem) -> _EffProblem:
    sw = prob.swapped[prob.pair_id]
    eff_cam_to = torch.where(prob.swapped, prob.cam_from, prob.cam_to)
    eff_cam_from = torch.where(prob.swapped, prob.cam_to, prob.cam_from)
    return _EffProblem(
        pt_to=torch.where(sw[:, None], prob.pt_from, prob.pt_to),
        pt_from=torch.where(sw[:, None], prob.pt_to, prob.pt_from),
        pair_id=prob.pair_id,
        cam_to=eff_cam_to[prob.pair_id],
        cam_from=eff_cam_from[prob.pair_id],
        w=prob.w * prob.pair_w[prob.pair_id],
        starts=prob.starts,
        ends=prob.ends,
        rows_to=eff_cam_to,
        rows_from=eff_cam_from,
    )


def _K(f, ppx, ppy) -> torch.Tensor:
    z, o = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, z, ppx]), torch.stack([z, f, ppy]),
                        torch.stack([z, z, o])])


def _K_inv(f, ppx, ppy) -> torch.Tensor:
    z, o = torch.zeros_like(f), torch.ones_like(f)
    fi = 1.0 / f
    return torch.stack([torch.stack([fi, z, -ppx * fi]),
                        torch.stack([z, fi, -ppy * fi]),
                        torch.stack([z, z, o])])


def _point_residual(cam12: torch.Tensor, pt_to: torch.Tensor,
                    pt_from: torch.Tensor) -> torch.Tensor:
    """Residual [2] of one point from its two cameras' 12 parameters
    (from, then to; calcError, .cc:171-197): r = from - H(to), H = K_f R_f
    R_t^T K_t^-1."""
    cf, ct = cam12[:6], cam12[6:]
    Hf = _K(cf[0], cf[1], cf[2]) @ rodrigues(cf[3:6])
    Ht = rodrigues(ct[3:6]).T @ _K_inv(ct[0], ct[1], ct[2])
    xyz = torch.cat([pt_to, torch.ones_like(pt_to[..., :1])], -1)
    proj = (Hf @ Ht) @ xyz
    z = proj[2]
    zsafe = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
    return pt_from - proj[:2] / zsafe


def _eff_residuals(params: torch.Tensor, eff: _EffProblem) -> torch.Tensor:
    """Weighted residuals [T, 2]."""
    H = _rows_H(params, eff.rows_from, eff.rows_to)
    _, u, zs, _ = _project(H[eff.pair_id], eff.pt_to[:, None])
    r = eff.pt_from - u[:, 0, :2] / zs[:, 0, None]
    return r * eff.w[:, None]


def _residuals(params: torch.Tensor, prob: BAProblem) -> torch.Tensor:
    return _eff_residuals(params, _effective(prob))


def _rms_w(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sqrt(mean of squared residuals) over the active points, two per
    point (.cc:199-220)."""
    npts = (w > 0).sum().to(r.dtype) * 2.0
    return torch.sqrt((r * r).sum() / torch.clamp(npts, min=1.0))


def _rms_points(r: torch.Tensor, prob: BAProblem) -> torch.Tensor:
    """``_rms_w`` over a point-major problem's active points (the JAX
    package's ``_rms(r, prob)``)."""
    return _rms_w(r, prob.w * prob.pair_w[prob.pair_id])


def _segment_blocks(x: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of x [T, ...] over the contiguous segments [starts,
    ends): a cumulative sum (in x's dtype, f64 here) and two gathers of P
    rows, no scatter over T."""
    flat = x.reshape(x.shape[0], -1)
    cs = torch.cat([torch.zeros_like(flat[:1]), torch.cumsum(flat, 0)], 0)
    return (cs[ends.long()] - cs[starts.long()]).reshape(
        (starts.shape[0],) + x.shape[1:])


def _eff_jacobian(params: torch.Tensor, eff: _EffProblem) -> torch.Tensor:
    """Analytic per-point Jacobian [T, 2, 12] (from camera, then to): the
    chain rule through the projective division of the per-pair dH blocks
    (``_rows_H_dH``; calcJacobianSymbolic, .cc:306-353)."""
    H, dH = _rows_H_dH(params, eff.rows_from, eff.rows_to)
    pid = eff.pair_id
    ph, u, zs, zok = _project(H[pid], eff.pt_to[:, None])
    ph, u, zs, zok = ph[:, 0], u[:, 0], zs[:, 0], zok[:, 0]
    du = torch.einsum("tkij,tj->tki", dH[pid], ph)       # [T, 12, 3]
    zi = 1.0 / zs
    # the zsafe clamp freezes z where |z| <= 1e-20
    zterm = torch.where(zok, zi * zi, 0.0)
    Jx = -(du[..., 0] * zi[:, None]
           - du[..., 2] * (u[..., 0] * zterm)[:, None])
    Jy = -(du[..., 1] * zi[:, None]
           - du[..., 2] * (u[..., 1] * zterm)[:, None])
    return torch.stack([Jx, Jy], dim=1)


def _eff_normal_equations(params: torch.Tensor, residuals: torch.Tensor,
                          eff: _EffProblem, n_cam: int):
    """JtJ [6n, 6n] and Jtb [6n]: per-point blocks summed over each pair's
    segment (``_segment_blocks``), then the P pair blocks added at their
    cameras' rows."""
    Jp = _eff_jacobian(params, eff) * eff.w[:, None, None]
    B = torch.einsum("tki,tkj->tij", Jp, Jp)             # [T, 12, 12]
    b = torch.einsum("tki,tk->ti", Jp, residuals)        # [T, 12]
    Bp = _segment_blocks(B, eff.starts, eff.ends)
    bp = _segment_blocks(b, eff.starts, eff.ends)
    offs = torch.arange(6, device=params.device)
    rows = torch.cat([eff.rows_from[:, None] * 6 + offs,
                      eff.rows_to[:, None] * 6 + offs], 1).long()
    return assemble_scatter(Bp, bp, rows, n_cam * 6)


def _normal_equations(params, residuals, prob: BAProblem, n_cam: int):
    return _eff_normal_equations(params, residuals, _effective(prob), n_cam)


def ba_optimize(params: torch.Tensor, prob: BAProblem, identity_idx: int,
                n_cam: int, lm_lambda: float) -> torch.Tensor:
    """The LM loop (optimize(), .cc:117-168) over a point-major problem, on
    the device of ``params`` and ``prob``.  params: [n, 6] float64 rows
    (focal, ppx, ppy, rx, ry, rz); returns the optimized [n, 6].

    The JAX package's semantics: fixed split damping (lambda on rotations,
    lambda / 10 on intrinsics, .cc:240-248); the identity camera's rotation
    frozen by masking the solved step (.cc:144-148); a step accepted when
    the RMS drops by more than 1e-3; at most 100 steps, ending after more
    than 5 rejections in a row; J^T r from the residual of the most
    recently evaluated state even after a rejected step (.cc:117-160).  A
    host loop with one read-back of the cost per iteration."""
    if not lm_lambda > 0:
        raise ValueError("LM damping must be positive (SPD precondition)")
    dt, dev = params.dtype, params.device
    eff = _effective(prob)
    upd = torch.ones(n_cam, 6, dtype=dt, device=dev)
    upd[int(identity_idx), 3:] = 0.0
    upd = upd.reshape(-1)
    damp = torch.where(torch.arange(n_cam * 6, device=dev) % 6 >= 3,
                       lm_lambda, lm_lambda / 10.0).to(dt)
    best_flat = params.reshape(-1)
    resid = _eff_residuals(params, eff)
    best_err = float(_rms_w(resid, eff.w))
    nr_nd, itr = 0, 0
    while itr < LM_MAX_ITER and nr_nd <= NR_NON_DECREASE:
        JtJ, Jtb = _eff_normal_equations(best_flat.reshape(n_cam, 6), resid,
                                         eff, n_cam)
        delta = solve_sym_scaled_chol(JtJ + torch.diag(damp), Jtb)
        new_flat = best_flat - delta * upd
        resid = _eff_residuals(new_flat.reshape(n_cam, 6), eff)
        new_err = float(_rms_w(resid, eff.w))
        if new_err < best_err - 1e-3:
            best_flat, best_err, nr_nd = new_flat, new_err, 0
        else:
            nr_nd += 1
        itr += 1
    return best_flat.reshape(n_cam, 6)


def pairs_to_points(from_idx, to_idx, pts_to, pts_from, valid,
                    pair_active) -> BAProblem:
    """A pair-major [P, M] problem in the segment layout: each pair's M rows
    are its segment and the weights select (no compaction).  Tensors land
    on the device of ``pts_to``."""
    pts_to = torch.as_tensor(pts_to)
    dev, dt = pts_to.device, pts_to.dtype
    valid = torch.as_tensor(valid, device=dev)
    P, M = valid.shape
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    i32 = lambda a: torch.as_tensor(a, device=dev).to(torch.int32)
    return BAProblem(
        pt_to=pts_to.reshape(P * M, 2),
        pt_from=torch.as_tensor(pts_from, device=dev).reshape(P * M, 2),
        pair_id=torch.repeat_interleave(ar, M),
        w=valid.reshape(-1).to(dt),
        starts=ar * M,
        ends=(ar + 1) * M,
        cam_to=i32(to_idx),
        cam_from=i32(from_idx),
        swapped=torch.zeros(P, dtype=torch.bool, device=dev),
        pair_w=torch.as_tensor(pair_active, device=dev).to(dt),
    )
