"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name."""

import json
import re

import pytest

import pbtest  # noqa: F401  (import path)

from portbench import check, spec, sut
from portbench.model import Model

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expansion|_dim$|_rank$|"
                   r"experts_per_tok|ffn|width)")
CELLS = [w["name"] for w in MAN["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_top_level_and_size():
    assert set(MAN) == KEYS
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    # the whole check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metric_names = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in MAN["configs"]:
        assert set(e) == CONFIG_KEYS and _line(e["source"]) and _line(e["why"])
        assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
    for e in MAN["workloads"]:
        assert set(e) == CELL_KEYS and _line(e["why"])
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
    for e in MAN["per_layer"]:
        assert set(e) - {"workloads"} == LAYER_KEYS and _line(e["layer"])


def test_every_cell_takes_one_chip_and_reports_enough():
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    for name in CELLS:
        cell = spec.cell(name)
        assert cell.chips == 1
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_metrics_sources_bounds_and_readers():
    for e in MAN["end_to_end"]:
        assert set(e) - {"workloads"} == E2E_KEYS
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert (spec.BENCH / "e2e" / f"{e['name']}.py").is_file()
        assert set(e.get("workloads", CELLS)) <= set(CELLS)
    assert [e["bound"] for e in MAN["end_to_end"] if e["name"] == "setup_s"] == [0.25]
    for e in MAN["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (spec.BENCH / "metrics" / f"{e['name']}.py").is_file()
        assert e["workloads"] and set(e["workloads"]) <= set(CELLS)
        for cell in e["workloads"]:
            # the cell reports the end-to-end metric this one moves
            assert e["moves"] in {m["name"] for m in spec.cell(cell).end_to_end}
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"
    layers = {}
    for e in MAN["per_layer"]:
        layers.setdefault(e["layer"].split(" (")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_configurations(entry):
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    path = spec.ROOT / entry["file"]
    assert entry["file"].startswith("portbench/") and path.is_file()
    c = spec.load_json(path)
    assert c["name"] == entry["name"] and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]
    assert not any(WIDTH.search(k) for k in entry["reduced"])
    # the port's registry config says the same numbers
    sut.port_config(c)
    Model.from_config(c)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = spec.cell(name)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert cell.window_out_tok_s is None or cell.window_out_tok_s > 0
    assert set(cell.limits) <= set(check.READINGS)
    mix = cell.traffic
    assert mix["loop"] == "closed" and mix["clients"] <= cell.engine["max_slots"]
    assert mix["clients"] <= cell.engine["max_queue"]
    longest = mix["prompt_len"]["hi"] + mix["output_len"]["hi"]
    assert longest <= cell.engine["max_seq_len"]
    bs = cell.store["block_size"]
    assert cell.engine["max_seq_len"] % bs == 0
    # the pool holds the longest request, and fewer than every client's
    # longest: the traffic, not the worst case, fills it
    eng = cell.engine
    assert eng["max_seq_len"] // bs < eng["n_blocks"] - 1
    assert eng["n_blocks"] - 1 < mix["clients"] * eng["max_seq_len"] // bs
    assert _line(mix["source"])
