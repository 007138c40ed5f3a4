"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a new mix, limit or metric file by name alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from vstbench import cell as cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vstbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("vstbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


def reported(workload):
    return {m["name"] for m in BENCH["end_to_end"]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(w):
    pkg = ROOT / "vstbench"
    assert (pkg / "mixes" / f"{w['traffic']}.json").is_file()
    assert (pkg / "limits" / f"{w['name']}.json").is_file()
    assert "setup_s" in reported(w["name"]) and len(reported(w["name"])) >= 2
    mine = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
    assert mine
    for m in mine:
        assert m["moves"] in reported(w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert cells.metric_reader(m["name"])({}) is None  # nothing to read: no value


def test_a_new_mix_limit_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "vstbench", tmp_path / "vstbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pkg = tmp_path / "vstbench"
    mix = json.loads((pkg / "mixes" / "stream.json").read_text())
    mix["host_frames"] = 8
    (pkg / "mixes" / "stream_short.json").write_text(json.dumps(mix))
    (pkg / "limits" / "johnson.stream_short.json").write_text('{"stylize_gap": 1e-4}')
    (pkg / "metrics" / "frames.stream.py").write_text(
        "def read(ctx):\n    return ctx.get('units')\n")
    bench["workloads"].append({"name": "johnson.stream_short", "config": "johnson",
                               "traffic": "stream_short", "chips": 1, "why": "a test"})
    c = cells.load("johnson.stream_short", 7, 1.0, False, bench, root=tmp_path)
    assert c.mix["host_frames"] == 8 and c.limits == {"stylize_gap": 1e-4}
    assert c.loop.__name__ == "vstbench.loops.stream"
    assert c.family.__name__ == "vstbench.families.johnson"
    assert cells.metric_reader("frames.stream", pkg)({"units": 3}) == 3


def test_configs_list_what_they_assume():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert (ROOT / "vstbench" / "families" / f"{cfg['family']}.py").is_file()
        assert (ROOT / "vstbench" / "reference" / f"{cfg['family']}.py").is_file()
