"""Nothing that ``portbench/run.py`` runs imports JAX, jaxlib, flax or the JAX package.

The walk follows every import statement of run.py and of each module it reaches that
lives in the checkout (the harness, the reference, the metric readers, the port), and
compares each imported module's top-level name, whole, against the forbidden names: the
port's name begins with the JAX package's and must pass."""

from __future__ import annotations

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "artist_style_transfer_tpu"}


def _module_file(name: str) -> pathlib.Path | None:
    parts = name.split(".")
    for base in (BENCH, ROOT):
        for cand in (base.joinpath(*parts).with_suffix(".py"), base.joinpath(*parts, "__init__.py")):
            if cand.exists():
                return cand
    return None


def _imports(path: pathlib.Path, package: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.add(mod)
            names |= {f"{mod}.{a.name}" for a in node.names}
    return names


def walk() -> set[str]:
    """Every module name imported from run.py on, transitively through the checkout."""
    start = [BENCH / "run.py", BENCH / "readings.py", *sorted((BENCH / "metrics").glob("*.py"))]
    seen_files, names = set(), set()
    todo = [(p, "") for p in start]
    while todo:
        path, pkg = todo.pop()
        if path in seen_files:
            continue
        seen_files.add(path)
        for name in _imports(path, pkg):
            names.add(name)
            f = _module_file(name)
            if f is not None:
                todo.append((f, name if f.name == "__init__.py" else name.rpartition(".")[0]))
    return names


def test_no_jax_anywhere_run_py_reaches():
    names = walk()
    assert "artist_style_transfer_tpu_torch" in {n.split(".")[0] for n in names}
    bad = sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
    assert not bad, bad


def test_the_walk_sees_a_forbidden_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom artist_style_transfer_tpu.ops import gram\n"
                   "import artist_style_transfer_tpu_torch\n")
    tops = {n.split(".")[0] for n in _imports(src, "")}
    assert tops & FORBIDDEN == {"jax", "artist_style_transfer_tpu"}


def test_run_refuses_with_jax_loaded(monkeypatch, capsys):
    import sys
    import types

    from benchlib import runner

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert runner.forbidden_modules() == ["jaxlib"]
    assert runner.finish({"checked": {}}) == 3
    assert capsys.readouterr().out == ""
