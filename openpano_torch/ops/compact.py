"""Stream compaction to fixed-size index lists.

``compact_indices`` gives the indices of the first ``size`` set lanes of a
mask, ascending, zero-filled, plus the (unclipped) count — the semantics of
``openpano_tpu/ops/compact.py``, whose block-and-search formulation exists
for the TPU's sake.  Here a running count ranks the set lanes and one
scatter places them, batched over leading dims, with no host sync.

``compact_indices_capped`` keeps at most ``per_block_cap`` set lanes in
each run of ``block`` consecutive lanes before compacting (the JAX
package's capped variant, whose cap decides which DoG extrema survive);
its count is clipped to ``size``.
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, size: int):
    """mask: [..., N] bool.  Returns (idx [..., size] int64, count [...]
    int64): idx holds the first ``size`` set lanes ascending and 0 beyond
    ``count = mask.sum(-1)``, which is not clipped."""
    lead, n = mask.shape[:-1], mask.shape[-1]
    m = mask.reshape(-1, n)
    rank = torch.cumsum(m.to(torch.int64), dim=1)          # 1-based
    take = m & (rank <= size)
    slot = torch.where(take, rank - 1, size)               # size = discard
    out = torch.zeros(m.shape[0], size + 1, dtype=torch.int64,
                      device=mask.device)
    lanes = torch.arange(n, device=mask.device).expand_as(slot)
    out.scatter_(1, torch.where(take, slot, size), torch.where(take, lanes, 0))
    count = rank[:, -1] if n else torch.zeros(m.shape[0], dtype=torch.int64,
                                              device=mask.device)
    return out[:, :size].reshape(*lead, size), count.reshape(lead)


def compact_indices_capped(mask: torch.Tensor, size: int, block: int = 128,
                           per_block_cap: int = 32):
    """Like :func:`compact_indices`, keeping at most ``per_block_cap`` set
    lanes per ``block`` consecutive lanes (extras dropped and not counted);
    the count is clipped to ``size``."""
    lead, n = mask.shape[:-1], mask.shape[-1]
    nb = -(-n // block)
    m = torch.nn.functional.pad(mask.reshape(-1, n), (0, nb * block - n))
    m = m.reshape(-1, nb, block)
    local = torch.cumsum(m.to(torch.int64), dim=2)
    kept = (m & (local <= per_block_cap)).reshape(-1, nb * block)[:, :n]
    idx, count = compact_indices(kept.reshape(*lead, n), size)
    return idx, torch.clamp(count, max=size)
