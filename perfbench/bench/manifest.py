"""Where the harness finds each part of a cell: by the names in
``BENCHMARK.json``, in files of their own under ``perfbench/``.

* ``configs/<config>.json``: the configuration (its ``params`` are the
  program's ``Params`` and the reference's settings, its
  ``correct_limits`` the limits of the comparison);
* ``traffic/<traffic>.json``: the traffic mix, read by ``bench.traffic``;
* ``metrics/<metric>.py``: one reader per per-layer quantity, a module
  with ``read(ctx) -> float | None`` (a quantity split by the end-to-end
  metric it moves, ``<metric>.<qualifier>``, shares its reader);
* ``kernels/<kernel>.json``: one hand kernel's trace name and its bytes
  and operations per launch, read by ``bench.trace``;
* ``peaks.json``: the chip's peaks.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # perfbench/
ROOT = HERE.parent                           # the checkout


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises ``KeyError`` for a
    name it does not list."""
    bench = benchmark(root)
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       + ", ".join(x["name"] for x in bench["workloads"]))
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=cfg["name"], config=_load_json(root / cfg["file"]),
        traffic_name=w["traffic"],
        traffic=_load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``; for a metric that
    has no file of its own, that of its longest dotted prefix that has
    one: ``device.idle_share.dis`` is read by ``device.idle_share.py``, a
    quantity split by the end-to-end metric its cells report."""
    name = metric
    while not (HERE / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernels() -> list:
    """Every ``kernels/*.json``, sorted by file name."""
    return [_load_json(p) for p in sorted((HERE / "kernels").glob("*.json"))]


def peaks() -> dict:
    return _load_json(HERE / "peaks.json")
