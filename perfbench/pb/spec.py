"""Finding a cell's parts by name.

``BENCHMARK.json`` names the cells, the metrics and the bounds.  A
cell's configuration is the file its entry names (its ``system`` names
``<paths[0]>/systems/<system>.py``: the program's entry it drives, its
feed, reference and check, as ``systems/__init__.py`` sets out), its
traffic ``<paths[0]>/traffic/<traffic>.json`` (read by that system's
feed), and each metric's reader ``<paths[0]>/metrics/<name>.py``.  Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a name (letters, digits, "
                         "'_', '.', '-'; at most 64)")
    return name


def benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _data(here: Path, kind: str, name: str) -> dict:
    path = here / kind / f"{check_name(name, kind)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def _module(here: Path, kind: str, name: str):
    path = here / kind / f"{check_name(name, kind)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, name: str, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs, found by name in
    ``bench`` (``BENCHMARK.json`` when ``None``)."""
    bench = bench or benchmark(root)
    here = root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())

    def mine(metric) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if mine(m) and m["moves"] in reported]
    return dict(
        name=name, workload=w, chips=w["chips"], config=cfg,
        traffic=_data(here, "traffic", w["traffic"]),
        system=_module(here, "systems", cfg["system"]),
        end_to_end=e2e, per_layer=layers,
        readers={m["name"]: _module(here, "metrics", m["name"])
                 for m in e2e + layers},
        run_seconds=bench["run_seconds"])
