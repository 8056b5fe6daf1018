"""Finds a cell's files by the names in ``BENCHMARK.json``.

A later change adds a configuration, a traffic mix, a per-layer metric,
a roofline or a reference by adding a file under the matching folder and
an entry in ``BENCHMARK.json``, and a weight layout by adding a file
under ``layouts/`` that names the ``block_kind`` it serves; nothing here
changes.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
_MODULES: Dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration entry under ``"cfg"``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return {**w, "cfg": cfg}
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"unknown workload {name!r}; known: {known}")


def config(entry: dict, root: Path = ROOT) -> dict:
    """The configuration file a ``configs`` entry names."""
    return load_json(root / entry["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def cell_file(cell_name: str) -> dict:
    """``cells/<cell>.json``: the cell's offered rate, found by a sweep,
    and the limits of its output check."""
    return load_json(BENCH_DIR / "cells" / f"{cell_name}.json")


def _module(path: Path) -> ModuleType:
    mod = _MODULES.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "servebench_" + path.stem.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def reference(name: str) -> ModuleType:
    """The plain model ``reference/<name>.py``."""
    return _module(BENCH_DIR / "reference" / f"{name}.py")


@functools.cache
def layouts() -> Dict[str, ModuleType]:
    """Every weight layout ``layouts/<name>.py`` by name."""
    return {p.stem: _module(p)
            for p in sorted((BENCH_DIR / "layouts").glob("*.py"))}


def layout_of(m: dict) -> ModuleType:
    """The layout of the model dims ``m`` (a configuration file's ``port``
    block): the one whose ``BLOCK_KINDS`` holds ``m["block_kind"]``. It
    gives ``leaves``, ``token_params``, ``attn_layers`` and
    ``recurrence_flops``. A block kind that no layout serves, or that two
    do, fails at once, with what each layout serves."""
    kind = m["block_kind"]
    found = [mod for mod in layouts().values() if kind in mod.BLOCK_KINDS]
    if len(found) != 1:
        served = "; ".join(f"{name}: {', '.join(mod.BLOCK_KINDS)}"
                           for name, mod in layouts().items())
        raise KeyError(f"{len(found)} layouts serve block_kind {kind!r}; "
                       f"served: {served}")
    return found[0]


def roofline(name: str) -> ModuleType:
    """The work counts ``rooflines/<name>.py`` of a kernel or a step."""
    return _module(BENCH_DIR / "rooflines" / f"{name}.py")


def peaks() -> dict:
    return load_json(BENCH_DIR / "rooflines" / "peaks.json")


def layer_metric(name: str) -> ModuleType:
    """The reader ``layer_metrics/<name>.py`` of a per-layer metric."""
    return _module(BENCH_DIR / "layer_metrics" / f"{name}.py")


def metrics_of(bench: dict, kind: str, cell_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    with no ``workloads`` key and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
