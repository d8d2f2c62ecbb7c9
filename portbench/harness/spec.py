"""A cell of BENCHMARK.json and the files it is made of, found by name.

For the workload ``<cell>`` of configuration ``<config>``:

- ``configs/<config>.json``: the deployment as it is run;
- ``entries/<config>.py``: ``load(cfg, device)``, the only code that imports
  the program under test;
- ``reference/<config>.py``: ``run(inputs, cfg, prec)``, the plain reference;
- ``traffic/<traffic>.json``: the traffic mix (scene, batch, utterance
  length, pool of distinct batches);
- ``scenes/<scene>.py``: ``make(seed, index, traffic, cfg, device)``;
- ``checks/<cell>.json``: how many calls the correctness check compares
  and the limit of each number it compares;
- ``metrics/<metric>.py``: ``read(ctx)`` for each per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the portbench folder
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def utterance_s(self) -> float:
        return float(self.traffic["utterance_s"])

    @property
    def audio_s_per_call(self) -> float:
        return self.traffic["batch"] * self.utterance_s

    def entry(self):
        return module("entries", self.config["name"])

    def reference(self):
        return module("reference", self.config["name"])

    def scene(self):
        return module("scenes", self.traffic["scene"]["name"])

    def reader(self, metric: str):
        return module("metrics", metric)


def module(kind: str, name: str):
    return importlib.import_module(f"portbench.{kind}.{name}")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of BENCHMARK.json with its files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"], config=read_json(root / conf["file"]),
        traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        checks=read_json(BENCH / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
