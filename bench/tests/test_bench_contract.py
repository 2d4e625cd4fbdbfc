"""CPU tests of the benchmark's files: ``BENCHMARK.json`` against the
rules of its format, and each cell's files found by name."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(Path(__file__).resolve().parent)]

from harness.common import cell_files, metric_reader  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text_fit(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    files = cell_files(cell)
    e2e = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert files["per_layer"]
    for m in files["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader_that_moves_its_metric(metric):
    reader = metric_reader(metric["name"])
    assert reader.MOVES == metric["moves"]
    assert callable(reader.read)
    if metric["unit"] == "%" and "roofline" in metric["name"]:
        assert metric["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = cell_files(cell)
    conf = json.loads(files["config"].read_text())
    assert conf["name"] == files["cell"]["config"]
    assert set(conf["arch"]) >= {"family", "n_layers", "d_model", "vocab",
                                 "param_dtype"}
    traffic = json.loads(files["traffic"].read_text())
    assert traffic["kind"] in ("train", "serve")
    limits = json.loads(files["limits"].read_text())
    assert limits and all(v > 0 for v in limits.values())


def test_every_config_is_used_and_paths_hold_only_the_benchmark():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_configs_keep_published_widths():
    """Nothing is cut: each configuration's ``arch`` holds the widths its
    ``published`` block gives, under the port's names."""
    pairs = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
             "num_attention_heads": "n_heads", "vocab_size": "vocab",
             "intermediate_size": "d_ff",
             "num_key_value_heads": "n_kv_heads"}
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        for hf, ours in pairs.items():
            if hf in conf["published"]:
                assert conf["arch"][ours] == conf["published"][hf], hf
        assert c["reduced"] == conf["reduced"] == []
