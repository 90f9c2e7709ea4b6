"""Benchmarks of the port, the counterparts of the JAX package's bench.py
and of the tools it and the repository's records are built from.

- ``headline`` (``python -m openpano_torch.bench``): the 38-view headline
  stitch with its multiband case, its roofline and the kernel check;
- ``roofline``: the per-stage work model against the H100's peaks and the
  host link's measured rate;
- ``kernel_check``: the CUDA kernels against their plain versions on the
  card;
- ``giga`` (``python -m openpano_torch.bench.giga``): the large-canvas
  benches (a UAV strip, a rotational gigapixel grid, a 2-D survey);
- ``scaling`` (``python -m openpano_torch.bench.scaling``): the sharded
  stitch at several world sizes.

Each runs on the card unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``), and raises without a card otherwise.  Each prints one
JSON line with the keys of its JAX counterpart, plus the card's name and
power limit, peak memory and every timed run's wall.
"""

from __future__ import annotations

import os
import resource
import subprocess

import torch


def device_record(dev: torch.device) -> dict:
    """The device a run measured: the card's name and power limit as
    ``nvidia-smi`` gives them, or the CPU."""
    if dev.type != "cuda":
        return {"device": dev.type, "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    line = smi.stdout.strip().splitlines()[index]
    return {"device": torch.cuda.get_device_name(dev),
            "power_limit": line.split(",")[-1].strip()}


def host_memory() -> dict:
    """This process's peak resident set and the machine's memory, in GB."""
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return {"peak_host_rss_gb": round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
            "host_mem_total_gb": round(total / 1e9, 2)}


def sync(dev: torch.device):
    """Wait for the card, so that a clock read after it covers the device
    work; nothing on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
