"""The benchmark's files: found by name, parsed, named within the allowed
characters, and a new cell picked up by adding files alone."""

import json
import re

import pytest
from conftest import BENCH, ROOT, copy_bench

from vbbench import harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_its_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmarks"]
    assert BENCHMARK["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells = len(BENCHMARK["workloads"])
    # a full check of 24 cells fits its 43200 seconds
    assert 2 + 14 * 24 * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_is_found_and_parsed(cell):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    spec, config, traffic = harness.load_cell(cell)
    assert spec["config"] == entry["config"] and spec["traffic"] == entry["traffic"]
    assert config["name"] == entry["config"]
    assert (BENCH / "traffic" / f"{traffic['kind']}.py").is_file()
    assert (BENCH / "vbbench" / "runners" / f"{spec['runner']}.py").is_file()
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert set(spec["limits"]) in ({"feat_err", "cost_err", "lat_miss"},
                                   {"ali_gap", "stats_err", "model_err"})
    assert all(v > 0 for v in spec["limits"].values())
    for metric in harness.cell_metrics(BENCHMARK, cell, False) + \
            harness.cell_metrics(BENCHMARK, cell, True):
        assert callable(harness.reader(metric["name"]))


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_every_configuration_file_names_its_source(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert config["file"].startswith("benchmarks/configs/")
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert "librispeech/s5/run.sh" in data["source"]
    assert isinstance(data["assumed"], list) and data["assumed"]
    assert data["reduced"] == config["reduced"]
    assert sum(1 for c in BENCHMARK["workloads"] if c["config"] == config["name"]) >= 1


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCHMARK["configs"]] + \
        [w["name"] for w in BENCHMARK["workloads"]] + \
        [w["config"] for w in BENCHMARK["workloads"]] + \
        [w["traffic"] for w in BENCHMARK["workloads"]] + \
        [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCHMARK["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_moved_metric_is_reported_by_the_cells_that_list_it():
    cells = [w["name"] for w in BENCHMARK["workloads"]]
    for m in BENCHMARK["per_layer"]:
        for cell in m.get("workloads", cells):
            reported = {e["name"] for e in harness.cell_metrics(BENCHMARK, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)
            assert m["name"] in {p["name"] for p in harness.cell_metrics(BENCHMARK, cell, True)}


def test_every_cell_reports_setup_and_another_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCHMARK, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCHMARK, w["name"], True)


def test_bounds_are_within_their_range():
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_metric_has_a_reader_file():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_layer_mappings_are_parsed():
    layers = trace.load_layers(BENCH / "layers")
    assert {"features", "acoustic_scoring", "lattice", "alignment", "estep"} <= set(layers)
    assert all(spec["kernels"] for spec in layers.values())
    named = {m["layer"] for m in BENCHMARK["per_layer"]}
    assert {spec["layer"] for spec in layers.values()} <= named


def test_a_new_cell_is_found_by_adding_files_alone(tmp_path):
    b = copy_bench(tmp_path)
    cell = json.loads((b / "workloads" / "tri1.lattice.json").read_text())
    traffic = json.loads((b / "traffic" / "batch128_10s.json").read_text())
    traffic["batch_utts"] = 64
    (b / "traffic" / "batch64_10s.json").write_text(json.dumps(traffic))
    (b / "workloads" / "tri1.lattice_b64.json").write_text(
        json.dumps({**cell, "traffic": "batch64_10s"}))
    spec, config, found = harness.load_cell("tri1.lattice_b64", b)
    assert found["batch_utts"] == 64 and config["name"] == "tri1-libri"
    bench = json.loads((b.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tri1.lattice_b64", "config": "tri1-libri",
                               "traffic": "batch64_10s", "chips": 1, "why": "smaller batches"})
    bench["end_to_end"][0]["workloads"].append("tri1.lattice_b64")
    names = {m["name"] for m in harness.cell_metrics(bench, "tri1.lattice_b64", False)}
    assert names == {"decode_audio_s_per_s", "setup_s"}


def test_a_new_traffic_kind_is_found_by_adding_its_file(tmp_path):
    from vbbench import traffic as TR

    (tmp_path / "bursts.py").write_text(
        "def requests(spec, feat, gen, device):\n    return [spec['size']] * 2\n")
    assert TR.kind("bursts", tmp_path).requests({"size": 3}, {}, None, None) == [3, 3]
    assert callable(TR.kind("decode_batches").requests)
    assert callable(TR.kind("train_corpus").corpus)
    with pytest.raises(ValueError):
        TR.kind("no_such_kind", tmp_path)
    with pytest.raises(ValueError):
        TR.kind("../bursts", tmp_path)


def test_a_missing_cell_or_bad_name_is_refused(tmp_path):
    with pytest.raises(harness.Refused):
        harness.load_cell("no.such_cell")
    with pytest.raises(harness.Refused):
        harness.load_cell("../BENCHMARK")


def test_paths_hold_the_benchmark_alone():
    top = {p.name for p in BENCH.iterdir()} - {"__pycache__"}
    assert top <= {"README.md", "run.py", "readings.py", "configs", "workloads", "traffic",
                   "metrics", "layers", "vbbench", "tests"}
