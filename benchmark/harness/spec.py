"""Finding a cell's parts by name: ``BENCHMARK.json``'s entries, the
configuration file, the traffic file, the cell's own file, the per-layer
metric readers and the model families, each a file of its own under
``benchmark/``."""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FAMILIES = BENCH / "families"
# The family of a configuration file without a ``family`` key.
DEFAULT_FAMILY = "nice"


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell_file(name: str) -> dict:
    """``benchmark/cells/<cell>.json``: what belongs to one cell, the limits
    of its correctness check and, optionally, the sampler route it runs on
    (``sampler_route``; not a key of the port's configuration)."""
    with open(BENCH / "cells" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metric_reader(name: str) -> Callable:
    """The ``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    """The module ``benchmark/families/<name>.py``: what the check and the
    yardstick need of one model family (``benchmark/families/__init__.py``
    lists it). Raises ``KeyError`` naming the known families where there is
    no such file."""
    path = FAMILIES / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        known = sorted(p.stem for p in FAMILIES.glob("*.py") if p.stem != "__init__")
        raise KeyError(f"no model family {name!r} in {FAMILIES}; known: {known}")
    spec = importlib.util.spec_from_file_location(f"benchmark_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_family(conf: dict):
    """The family that a configuration file names (``family``, beside
    ``source`` and ``slam``), :data:`DEFAULT_FAMILY` where it names none."""
    return family(conf.get("family", DEFAULT_FAMILY))


def metrics_for(entries: List[dict], cell: str) -> List[dict]:
    """The entries that the cell reports: those without ``workloads`` and
    those that list it."""
    return [e for e in entries if "workloads" not in e or cell in e["workloads"]]


def with_overrides(slam: dict, sets: Dict[str, object]) -> dict:
    """A copy of a configuration's ``slam`` block with dotted keys set."""
    out = copy.deepcopy(slam)
    for dotted, value in sets.items():
        node = out
        *path, last = dotted.split(".")
        for p in path:
            node = node[p]
        if last not in node:
            raise KeyError(f"unknown configuration key {dotted!r}")
        node[last] = value
    return out


def build(cls, data: dict):
    """The port's configuration dataclass ``cls`` from a dict of its fields,
    nested dataclasses from nested dicts (fields the dict leaves out keep
    the port's defaults)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.default):
            v = build(type(f.default), v)
        elif f.name == "bound":
            v = tuple(tuple(float(x) for x in row) for row in v)
        kwargs[f.name] = v
    unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"unknown keys for {cls.__name__}: {sorted(unknown)}")
    return cls(**kwargs)
