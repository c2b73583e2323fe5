"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the configuration, the traffic mix and the metrics; each lives in a
file of its own under this folder.

* ``configs/<file>``: the configuration (``BENCHMARK.json`` names its file);
* ``traffic/<traffic>.json``: the mix (``portbench/traffic.py``);
* ``workloads/<cell>.json``: the cell's engine settings, its limits and,
  where given, ``window_out_tok_s``, the rate that sizes the window's work
  (``portbench/loop.py``);
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  end-to-end and per-layer metric, ``read(record) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def _named(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict               # the configuration file
    traffic: Dict              # the mix file
    store: Dict                # the configuration's store route (EngineConfig fields)
    engine: Dict               # the cell's engine settings (EngineConfig fields)
    limits: Dict               # the correctness limits
    end_to_end: List[Dict]     # the manifest's metric entries this cell reports
    per_layer: List[Dict]
    window_out_tok_s: Optional[float] = None   # sizes the window's work (loop.py)


def _reports(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, man: Dict = None) -> Cell:
    man = man if man is not None else manifest()
    w = _named(man["workloads"], name, "workload")
    c = _named(man["configs"], w["config"], "config")
    config = load_json(ROOT / c["file"])
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [e for e in man["end_to_end"] if _reports(e, name)]
    reported = {e["name"] for e in e2e}
    per_layer = [e for e in man["per_layer"]
                 if _reports(e, name) and e["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                store=config["store"], engine=spec["engine"], limits=spec["limits"],
                end_to_end=e2e, per_layer=per_layer,
                window_out_tok_s=spec.get("window_out_tok_s"))


def reader(kind: str, name: str) -> Callable:
    """The ``read`` function of ``<kind>/<name>.py`` (kind ``e2e`` or
    ``metrics``)."""
    path = BENCH / kind / f"{name}.py"
    module = f"portbench_{kind}_" + name.replace(".", "_")
    mod_spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
