"""The bundle adjustment with its pair slots sharded over the ranks.

Counterpart of ``openpano_tpu/parallel/dist_ba.py``: the camera state (6n
doubles) and the solve stay replicated; the point residuals and the normal
equations, the costly part, shard over the pair slots, and an f64
all-reduce adds the ranks' sums before every solve and every cost test
(``bundle_adjuster.ba_optimize_pairs`` with ``mesh``).
"""

from __future__ import annotations

import torch

from ..camera.bundle_adjuster import LM_MAX_ITER, NR_NON_DECREASE, \
    BAPairProblem, ba_optimize_pairs
from .mesh import shard_on


def _pad_pairs(prob: BAPairProblem, mult: int) -> BAPairProblem:
    """The pair axis padded to a multiple of ``mult`` with zero slots,
    whose ``pair_w = 0`` adds nothing to the residuals or the sums."""
    r = -prob.pair_w.shape[0] % mult
    if r == 0:
        return prob
    pad = lambda a: torch.cat([a, a.new_zeros((r,) + a.shape[1:])])
    return BAPairProblem(*(pad(a) for a in prob))


def ba_optimize_pairs_sharded(params, prob: BAPairProblem, identity_idx: int,
                              n_cam: int, lm_lambda: float, mesh,
                              adaptive: bool = False,
                              max_iter: int = LM_MAX_ITER,
                              patience: int = NR_NON_DECREASE,
                              rel_tol: float = 0.0, banded: bool = False,
                              bucket: int | None = None):
    """The LM of :func:`ba_optimize_pairs` over this rank's block of the pair
    slots (padded to a mesh multiple); every rank returns the same
    (params [n, 6], iterations)."""
    prob = _pad_pairs(prob, mesh.size())
    blk = shard_on(mesh, prob.pair_w.shape[0])
    local = BAPairProblem(*(a[blk.start : blk.stop] for a in prob))
    return ba_optimize_pairs(params, local, identity_idx, n_cam, lm_lambda,
                             adaptive=adaptive, max_iter=max_iter,
                             patience=patience, rel_tol=rel_tol,
                             banded=banded, bucket=bucket, mesh=mesh)
