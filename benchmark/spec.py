"""What ``BENCHMARK.json`` and the files beside it say about one cell.

Each configuration, traffic mix, per-layer metric, scene generator and
cell's limits is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- the configuration: the ``file`` of its ``configs`` entry;
- the traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric's reader: ``metrics/<name>.py``, whose ``read(run)``
  returns the number or None when the run holds nothing to read;
- the cell's correctness limits: ``limits/<workload>.json``.

So a later change adds a cell, a configuration or a metric by adding files
and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict        # number -> limit
    root: str = ROOT    # the checkout the files were found in

    def program(self) -> dict:
        """The port's Config fields: the configuration's, then the
        traffic's (what the user's input is, such as its order)."""
        return {**self.config["program"], **self.traffic.get("program", {})}


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: it lists the cell under
    ``workloads``, or has no such key and moves a metric the cell reports
    (an end-to-end metric without the key is every cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else _json(
        os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    limits = _json(os.path.join(here, "limits", f"{name}.json"))
    return Cell(name, w["chips"], config, traffic, e2e, per_layer, limits,
                root)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
