"""BENCHMARK.json against the contract the harness is written to, and
every cell, configuration, mix and metric resolved to its files by name."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, two compiles
    # of 90 s a cell, 1200 s spare, within 43,200 s at 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"]] + METRICS)
    assert all(NAME.match(n) for n in names)
    assert len(CELLS) == len(set(CELLS))
    assert len(names) - len(CELLS) == len(set(names) - set(CELLS))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
        own = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["reduced"] == own["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_pairs_are_unique_and_every_config_is_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["reduced"] == next(
        x["reduced"] for x in BENCH["configs"] if x["name"] == c.config["name"])
    assert (spec.BENCH_DIR / "harness" / "drivers"
            / f"{c.traffic['driver']}.py").is_file()
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # the metric it moves is reported in this cell
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS)
def test_metric_resolves_to_its_reader(metric):
    mod = spec.reader_module(metric)
    assert callable(mod.read)
    assert set(mod.NEEDS) <= {"plain", "host", "stack"}


def test_the_gan_configuration_keeps_flowhighs_generator():
    """Only the GAN recipe's group is changed from a source: the generator's
    widths and the mel are FlowHigh's vocoder's."""
    files = {c["name"]: json.loads((spec.ROOT / c["file"]).read_text())
             for c in BENCH["configs"]}
    gan, flow = files["bigvgan-48k-256band"], files["flowhigh-48k"]
    assert gan["reduced"] == ["gan"] and flow["reduced"] == []
    assert gan["vocoder"] == flow["vocoder"] and gan["mel"] == flow["mel"]
