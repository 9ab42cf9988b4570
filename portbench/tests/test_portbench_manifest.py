"""The manifest keeps the benchmark's rules, and every piece it names is found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchlib import generators, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(M) == TOP_KEYS
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [x["name"] for x in M[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {x["name"] for x in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for x in M[kind]:
        keys = {"name", "unit", "better", "source"} | ({"bound"} if kind == "end_to_end"
                                                      else {"layer", "moves"})
        assert set(x) - {"workloads"} == keys, x["name"]
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert x["source"] in ("host_clock", "device_trace")
            assert 0.01 <= x["bound"] <= 0.25
        else:
            assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert _line(x["layer"]) and x["moves"] in e2e
            # the cells it is read in report the end-to-end metric it moves
            moves = next(m for m in M["end_to_end"] if m["name"] == x["moves"])
            assert set(x.get("workloads", cells)) <= set(moves.get("workloads", cells))


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        e2e = [x["name"] for x in manifest.metrics_for(w["name"], "end_to_end", M)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.metrics_for(w["name"], "per_layer", M), w["name"]


def test_configs_and_cells():
    configs = {c["name"]: c for c in M["configs"]}
    used = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and _line(c["source"]) and _line(c["why"])
        cfg = manifest.config(c["name"], M)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(configs)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_pieces_found_by_name(cell):
    w = manifest.cell(cell, M)
    cfg = manifest.config(w["config"], M)
    traffic = manifest.traffic(w["traffic"])
    assert callable(generators.load(traffic["generator"]).setup)
    assert cfg["name"] == w["config"]
    assert manifest.limits(cell)  # the cell's limits of correct
    for kind in ("end_to_end", "per_layer"):
        for metric in manifest.metrics_for(cell, kind, M):
            assert callable(manifest.reader(metric["name"]))


def test_result_line_keys():
    """The result line's keys, in order, with the checked numbers last."""
    from benchlib import runner

    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                         "memory_peak_bytes": 1},
              "checked": {"logit_gap": {"value": 0.0, "limit": 1e-3}}}
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert runner.finish(result) == 0
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
