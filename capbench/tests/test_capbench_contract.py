"""BENCHMARK.json against the rules it is written to, and every file a
cell, a mix or a metric needs, found by its name."""

import json
import math
import re
from pathlib import Path

import pytest

from capbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|^dim_|hidden|intermediate|latent|state|projection|head|expansion|experts_per")
B = bench.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (bench.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in B["paths"])
    assert all((bench.ROOT / p).is_dir() and not p.endswith("_torch") for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and all(1 <= len(w) <= 200 and "\t" not in w for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in B["configs"]] + CELLS + [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(name), name
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer", "moves"}
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in B["end_to_end"])
    for m in B["per_layer"]:
        assert "bound" not in m and 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_workloads_and_configs():
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in B["paths"])) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and not any(WIDTHS.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = bench.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert bench.driver(c).run
    assert c.limits and all(math.isfinite(v) for v in c.limits.values())
    for name in bench.per_layer_names(c):
        assert callable(bench.metric_reader(name))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric(cell):
    c = bench.load_cell(cell)
    e2e = bench.end_to_end_names(c)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert bench.per_layer_names(c)


@pytest.mark.parametrize("metric", [m["name"] for m in B["per_layer"]])
def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(metric):
    m = next(x for x in B["per_layer"] if x["name"] == metric)
    moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)
    assert (bench.HERE / "metrics" / f"{metric}.py").is_file()


def test_layers_of_one_name_are_spelled_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    assert len({name.lower() for name in layers}) == len(layers)


def test_files_under_paths_are_named_from_name_characters():
    for p in B["paths"]:
        for f in (bench.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or ".cache" in f.parts:
                continue
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(f.relative_to(bench.ROOT))), f


def test_configuration_files_hold_the_model_as_run():
    for c in B["configs"]:
        cfg = json.loads(Path(bench.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["num_attend_layers"] == cfg["num_decode_layers"] == cfg["num_initialize_layers"] == 2
        program = bench.program_config(cfg)
        assert program.num_ctx == cfg["num_ctx"] and program.dim_ctx == cfg["dim_ctx"]
