"""Process-group bootstrap, the 1-D rank mesh and the few collectives of the
sharded stitch.

Counterpart of ``openpano_tpu/parallel/mesh.py``.  The JAX package drives
every device of a 1-D ``jax.sharding.Mesh`` (axis "d") from one process;
here one process runs per rank, joined by ``torch.distributed``: NCCL
between cards, gloo between CPU processes, the same code either way.  Every
rank calls the stitch with the same inputs, as the JAX package's
multi-process runs do, and every rank returns the whole canvas.  The mesh
axis shards

  - images: the feature stage (``stitcherbase.compute_features_sharded``);
  - match pairs: matching and RANSAC (``stitcher.build_pairwise_graph``);
  - BA pair slots: each rank sums its normal equations, an f64 all-reduce
    adds them (``bundle_adjuster.ba_optimize_pairs``);
  - canvas column bands: the blends, with a halo to the neighbouring rank
    (``render.blend_linear_sharded``, ``multiband.blend_multiband_sharded``).

The collectives live here and nowhere else; each adds the bytes this rank
hands it to ``BYTES`` under (collective, stage).
"""

from __future__ import annotations

import datetime
import os
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS = "d"
DEFAULT_TIMEOUT_S = 300.0

# bytes this rank handed each collective: (collective, stage) -> bytes
BYTES: dict[tuple[str, str], int] = defaultdict(int)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the ranks (no-op when the group is up).

    ``coordinator_address`` is "host:port" (init method ``tcp://``), or an
    init-method URL such as ``file:///tmp/store``; None reads torchrun's
    variables (``env://``), and then ``num_processes`` / ``process_id``
    come from there too.  The backend follows ``device`` and nothing else:
    NCCL for the card (the default; raises when there is none) and gloo for
    "cpu".  On the card the rank's device is ``LOCAL_RANK`` (0 by
    default).  ``timeout_s`` bounds every collective, so that a rank that
    raised cannot hold the others forever."""
    if dist.is_initialized():
        return
    from ..stitch.stitcher import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if coordinator_address is None:
        init_method, kw = "env://", {}
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        kw = dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(
        backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_mesh(n: int | None = None) -> DeviceMesh:
    """The 1-D mesh (axis "d") over every rank, on the card under NCCL and
    on the CPU under gloo.  ``n``, when given, must be the world size: a
    rank cannot leave the mesh of a stitch that every rank runs."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_on(mesh: DeviceMesh, n: int) -> range:
    """This rank's contiguous block of an axis of length ``n`` padded to a
    multiple of the mesh size (``P(axis)`` there): indices past ``n-1`` are
    padding."""
    per = -(-n // mesh.size())
    lo = mesh.get_local_rank() * per
    return range(lo, lo + per)


def _count(op: str, stage: str, t: torch.Tensor):
    BYTES[op, stage] += t.numel() * t.element_size()


def reset_bytes():
    BYTES.clear()


def bytes_by_stage(counts=None) -> dict[str, dict[str, int]]:
    """``counts`` (``BYTES`` by default, or a copy of it) as {stage:
    {collective: bytes}}."""
    out: dict[str, dict[str, int]] = {}
    for (op, stage), b in sorted((BYTES if counts is None
                                  else counts).items()):
        out.setdefault(stage, {})[op] = b
    return out


def all_gather(mesh: DeviceMesh, t: torch.Tensor, stage: str) -> torch.Tensor:
    """[nd * L, ...]: every rank's fixed-shape [L, ...] block, in rank
    order."""
    _count("all_gather", stage, t)
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group())
    out = torch.cat(parts, 0)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce_sum(mesh: DeviceMesh, t: torch.Tensor,
                   stage: str) -> torch.Tensor:
    """The f64 sum of ``t`` over the ranks, the same bits on every rank."""
    if t.dtype != torch.float64:
        raise TypeError(f"the reduction runs in f64, not {t.dtype}")
    _count("all_reduce", stage, t)
    t = t.contiguous()
    dist.all_reduce(t, group=mesh.get_group())
    return t


def _exchange(mesh: DeviceMesh, t: torch.Tensor, step: int, op: str,
              stage: str):
    """Send ``t`` to rank r + step and receive the same shape from rank
    r - step; None where that rank does not exist."""
    ranks = mesh.mesh.tolist()
    r, nd = mesh.get_local_rank(), len(ranks)
    t = t.contiguous()
    got = torch.empty_like(t) if 0 <= r - step < nd else None
    ops = []
    if 0 <= r + step < nd:
        _count(op, stage, t)
        ops.append(dist.P2POp(dist.isend, t, ranks[r + step]))
    if got is not None:
        ops.append(dist.P2POp(dist.irecv, got, ranks[r - step]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


def halo_right(mesh: DeviceMesh, t: torch.Tensor, stage: str):
    """Send ``t`` to the right neighbour; returns what the left one sent
    (None on the first rank)."""
    return _exchange(mesh, t, 1, "halo_right", stage)


def halo_left(mesh: DeviceMesh, t: torch.Tensor, stage: str):
    """Send ``t`` to the left neighbour; returns what the right one sent
    (None on the last rank)."""
    return _exchange(mesh, t, -1, "halo_left", stage)
