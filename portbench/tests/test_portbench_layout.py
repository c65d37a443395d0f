"""The harness finds every cell, configuration, traffic mix, limit and metric by
name from BENCHMARK.json, and a cell is added by adding files and an entry."""

import importlib
import json
import re
import shutil

import pytest

from portbench import generate
from portbench import model as M
from portbench import run as R

BENCH = R.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = M.load_config(cell["config"])
    mix = generate.load_mix(cell["traffic"])
    mod = importlib.import_module(f"portbench.entries.{mix['entry']}")
    assert hasattr(mod.Entry, "item") and hasattr(mod.Entry, "check")
    limits = R.load_limits(cell)
    assert limits and all(v >= 0 for v in limits.values())  # 0: an exact comparison
    assert cfg["reduced"] == next(c for c in BENCH["configs"]
                                  if c["name"] == cell["config"])["reduced"]
    for section in ("end_to_end", "per_layer"):
        assert R.metrics_for(BENCH, cell, section), (cell["name"], section)
    assert any(m["name"] != "setup_s" for m in R.metrics_for(BENCH, cell, "end_to_end"))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(R.reader(metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", []):
        cell = R.find_cell(BENCH, w)
        assert cell["name"] in [c["name"] for c in BENCH["workloads"]]
        assert any(m["name"] == metric["moves"] for m in R.metrics_for(BENCH, cell,
                                                                        "end_to_end"))


def test_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for x in BENCH[section]:
            assert set(x) - {"workloads"} == want, x
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    assert all(m["better"] in ("lower", "higher") for k in ("end_to_end", "per_layer")
               for m in BENCH[k])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_names_units_and_paths():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in BENCH[k])
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["file"].endswith(f"{c['name']}.json")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer for layer in layers)


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A copy of the harness's data with one more mix file and one more
    workloads entry: the harness builds the new cell with no code edited."""
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(R.HERE / sub, root / sub)
    mix = dict(generate.load_mix("index_mf"), calls=3, products_per_call=1)
    (root / "traffic" / "index_small.json").write_text(json.dumps(mix))
    (root / "limits" / "seam_serving.index_small.json").write_text(
        (R.HERE / "limits" / "seam_serving.index_mf.json").read_text())
    for mod in (generate, M, R):
        monkeypatch.setattr(mod, "HERE", root)
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "seam_serving.index_small", "config": "seam_serving",
         "traffic": "index_small", "chips": 1, "why": "a test cell"}])
    cell = R.find_cell(bench, "seam_serving.index_small")
    entry = R.make_entry(cell, 7, "cpu")
    assert entry.mix["calls"] == 3 and entry.cfg["video"] is True
    assert R.load_limits(cell) == R.load_limits(R.find_cell(BENCH, "seam_serving.index_mf"))
    assert [m["name"] for m in R.metrics_for(bench, cell, "end_to_end")] == [
        "peak_mem_gib", "setup_s"]
