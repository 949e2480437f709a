"""A cell of BENCHMARK.json and the data files it names.

The harness is driven by data: a cell's entry in ``BENCHMARK.json`` names a
configuration (``configs/<name>.json``) and a traffic mix
(``workloads/<name>.json``), and every metric the cell reports has its
reader in ``metrics/<name>.py``. The configuration's ``dataset.generator``
names its data generator (``generators/``), and the mix's ``route`` and
``entry`` its request kind and where requests enter the program
(``routes/``, ``entries/``), each a module found by ``load``. A later
cell, deployment or metric is added by adding such files, without editing
one that is there.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
SCRATCH = os.path.join(HERE, ".scratch")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py`` (a metric name may hold dots,
    so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "anns_bench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


KINDS = {"routes": "route", "entries": "entry", "generators": "generator",
         "client": "client"}


def load(kind: str, name: str):
    """The module of ``kind`` (``routes``, ``entries``, ``generators`` or
    ``client``) that a traffic mix's or a configuration's keys name:
    ``<kind>/<name>.py``, each character of the name outside letters,
    digits and ``_`` spelt ``_`` in the file's name."""
    stem = re.sub(r"[^A-Za-z0-9_]", "_", str(name))
    if not os.path.isfile(os.path.join(HERE, kind, stem + ".py")):
        raise ValueError(f"unknown {KINDS[kind]} {name!r}: "
                         f"no {os.path.basename(HERE)}/{kind}/{stem}.py")
    return importlib.import_module(f"{__package__}.{kind}.{stem}")


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load_cell(name: str, bench_path: str = "") -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files and readers."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return cell_from_files(name, entry["config"], entry["traffic"],
                           int(entry["chips"]), e2e, layers)


def cell_from_files(name: str, config: str, traffic: str, chips: int,
                    e2e: List[dict], layers: List[dict]) -> Cell:
    """A cell from a configuration file, a traffic file and metric entries
    (BENCHMARK.json's form)."""
    return Cell(
        name=name,
        chips=chips,
        config=_json(os.path.join(HERE, "configs", config + ".json")),
        traffic=_json(os.path.join(HERE, "workloads", traffic + ".json")),
        end_to_end=[Metric(m["name"], m["unit"], load_reader(m["name"]))
                    for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], load_reader(m["name"]))
                   for m in layers],
    )


def configure_caches() -> None:
    """Fixed directories inside the checkout for every build and kernel
    cache a library would otherwise put under the user's home or /tmp. The
    program builds its own kernels into prefhetch_tpu_torch/build/, inside
    the checkout too."""
    dirs = {
        "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
        "CUDA_CACHE_PATH": os.path.join(CACHE, "cuda"),
    }
    for key, path in dirs.items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
