"""The benchmark's manifest, ``BENCHMARK.json`` at the checkout's root, and the files it
names: each configuration's file, ``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
each cell's limits of ``correct``, ``limits/<workload>.json``, all found by name."""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, m: dict) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, m: dict) -> dict:
    for c in m["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def limits(workload: str) -> dict:
    """{number: limit} of the cell's check."""
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())["limits"]


def metrics_for(cell_name: str, kind: str, m: dict) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that a cell reports."""
    return [x for x in m[kind] if cell_name in x.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
