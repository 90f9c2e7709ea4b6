"""Run a function on n ranks, one process each, with a time limit.

    results = run_ranks(fn, 3, store_dir, args=(a, b), timeout_s=120)

Each rank is a process started by ``spawn`` (a fresh interpreter that
imports only ``fn``'s module and what it imports), joined to the others
through a ``file://`` store in ``store_dir`` (no port to pick, so
concurrent groups cannot collide): gloo ranks on the CPU, each on one
intra-op thread, or with ``device="cuda"`` NCCL ranks, rank r on card r.
``fn(mesh, *args)`` runs on every rank; the list of the ranks' return
values comes back in rank order.  A rank that raises, or a
group that outlives ``timeout_s``, ends every rank and raises here: no
rank waits on in a collective that another left.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback


def _rank_main(fn, rank: int, world: int, store: str, args, timeout_s: float,
               out, device: str):
    try:
        import torch

        if device == "cpu":
            torch.set_num_threads(1)
        else:
            os.environ["LOCAL_RANK"] = str(rank)
        from .mesh import init_distributed, make_mesh

        init_distributed(f"file://{store}", world, rank, device=device,
                         timeout_s=timeout_s)
        result = fn(make_mesh(), *args)
        out.put((rank, True, result))
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, store_dir: str, args=(),
              timeout_s: float = 120.0, device: str = "cpu") -> list:
    """``fn(mesh, *args)`` on ``world`` ranks (gloo on the CPU, NCCL on the
    cards with ``device="cuda"``); returns their results in rank order, or
    raises with the first failing rank's traceback or on the time limit.
    ``fn``, ``args`` and the results must pickle (``fn`` by its import
    path)."""
    if device == "cuda":
        import torch

        if world > torch.cuda.device_count():
            raise ValueError(f"{world} NCCL ranks need {world} cards; this "
                             f"machine has {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    store = os.path.join(store_dir, f"store_{world}_{os.getpid()}_"
                                    f"{time.monotonic_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, args, timeout_s, out,
                               device),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout_s} s ({sorted(results)} did)")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]
