"""What a run reads from the repository: the cell in `BENCHMARK.json`, its
configuration, traffic and limits files, and the per-layer metric readers,
each found by its name.

- `portbench/configs/<config>.json`: the configuration as it is run.
- `portbench/traffic/<traffic>.json`: the mix the generator reads.
- `portbench/limits/<workload>.json`: the cell's correctness limits.
- `portbench/metrics/<metric>.py`: a reader `read(trace) -> float | None`.
- `portbench/drivers/<driver>.py`: the loop a traffic file names, with
  `run(cell, seed, seconds, trace, device, hooks) -> Run`.

A later cell, configuration, mix or metric is new files and new entries in
`BENCHMARK.json`; nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    root: str               # the checkout: BENCHMARK.json's directory
    name: str
    workload: dict          # the cell's entry in BENCHMARK.json
    config: dict            # its configuration file
    traffic: dict           # its traffic file
    limits: dict            # {number: limit}
    end_to_end: list        # the BENCHMARK.json entries the cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(root: str, *parts: str) -> str:
    return os.path.join(root, "portbench", *parts)


def load_cell(root: str, workload: str) -> Cell:
    """The cell named `workload` of `root`/BENCHMARK.json with its files;
    KeyError naming the known cells if there is none."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[workload]

    def reports(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return Cell(
        root=root,
        name=workload,
        workload=w,
        config=_load_json(_file(root, "configs", w["config"] + ".json")),
        traffic=_load_json(_file(root, "traffic", w["traffic"] + ".json")),
        limits=_load_json(_file(root, "limits", workload + ".json"))["limits"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )


def load_module(root: str, kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (a name may hold dots)."""
    path = _file(root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, name: str):
    return load_module(root, "metrics", name).read
