"""The manifest (``BENCHMARK.json``) and the files it names, found by name.

* a configuration: ``bench/configs/<file>`` as its ``file`` says;
* a traffic mix ``<mix>``: ``bench/traffic/<mix>.json``;
* a cell ``<cell>``'s check: ``bench/cells/<cell>.json`` (its limits and
  the readings they were set from);
* a per-layer metric ``<metric>``: ``bench/metrics/<metric>.py``, whose
  ``read(run)`` returns the value, or None where it finds nothing;
* a kind of work ``<work>``: ``bench/roofline/<work>.py``, whose
  ``work(run)`` counts it, and every ``bench/roofline/<work>.*.json``
  beside it, each a list of device-kernel names (substrings) doing that
  work.

Adding any of these is adding files and manifest entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

__all__ = ["ROOT", "BENCH", "manifest", "cell", "metric_reader",
           "work_counter", "kernel_names", "metrics_for"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, man: dict = None, root: Path = ROOT) -> dict:
    """A cell's workload entry with its configuration, mix and check
    (files under ``root``, a checkout's root)."""
    man = manifest(root) if man is None else man
    by_name = {w["name"]: w for w in man["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    bench = root / "bench"
    return {"workload": w,
            "config": _json(root / conf["file"]),
            "traffic": _json(bench / "traffic" / f"{w['traffic']}.json"),
            "check": _json(bench / "cells" / f"{name}.json")}


def _load(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    return _load(bench / "metrics" / f"{name}.py", "metric").read


def work_counter(work: str, bench: Path = BENCH):
    return _load(bench / "roofline" / f"{work}.py", "work").work


def kernel_names(work: str, bench: Path = BENCH) -> List[str]:
    names: List[str] = []
    for path in sorted((bench / "roofline").glob(f"{work}.*.json")):
        names += _json(path)
    return names


def metrics_for(section: List[Dict], cell_name: str) -> List[Dict]:
    """The metrics of a manifest section that a cell reports: those
    listing it, and those with no ``workloads`` key."""
    return [m for m in section
            if "workloads" not in m or cell_name in m["workloads"]]
