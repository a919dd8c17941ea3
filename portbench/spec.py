"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration, traffic mix and metrics; each lives in
a file of its own under this package, so a new cell, configuration,
traffic mix or per-layer metric is added by adding files."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents (its "kind" names a driver)
    limits: dict  # number name -> limit (portbench/limits/<cell>.json)
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    return Cell(
        name=name, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def quantity(metric: str) -> str:
    """The quantity a metric measures: its name up to the first dot. A
    quantity whose cells report different end-to-end metrics is split into
    metrics of their own (``decode_tok_s`` and ``decode_tok_s.offload``),
    each with its own bound, read by one driver value or one reader."""
    return metric.split(".")[0]


def driver(kind: str):
    """The traffic driver module ``portbench.traffic.<kind>``."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def reader(quantity_: str):
    """The per-layer reader ``portbench.metrics.<quantity>``: a module
    whose ``read(obs)`` returns the value, or None where the traced run
    holds nothing it reads."""
    return importlib.import_module(f"portbench.metrics.{quantity_}")
