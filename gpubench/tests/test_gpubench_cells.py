"""BENCHMARK.json against the contract's shape, and a cell, a traffic mix
and a metric added as files and entries only."""

import json
import os
import re
import shutil

import pytest

from gpubench.harness import spec
from gpubench.tests.helpers import load_cell, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"]
    assert 1 <= b["run_seconds"] <= 51
    cfg_names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))[
            "source"] == c["source"]
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["correct-10x", "polish-10x"])
def test_committed_cells_load(cell):
    c = load_cell(cell)
    assert c.config["job"] in ("correct", "polish")
    assert {m.name for m in c.end_to_end} == {"bases_per_s", "error_pct",
                                               "setup_s"}
    committed = {w["name"] for w in bench()["workloads"]}
    assert len(c.per_layer) >= (cell in committed)


def test_a_cell_added_as_files_only(tmp_path):
    """A later change adds a traffic file, a metric reader and their
    entries; nothing of the harness is edited, and the new cell runs."""
    root = tmp_path / "checkout"
    (root / "gpubench").mkdir(parents=True)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, d), root / "gpubench" / d)
    b = bench()
    t = spec.load_json(os.path.join(spec.HERE, "traffic", "sim-clr-10x.json"))
    t = dict(t, genome_len=4000,
             check={"error_sample": 32, "reference_sample": 2})
    t["reads"] = dict(t["reads"], read_len=1200, coverage=12.0)
    (root / "gpubench" / "traffic" / "sim-clr-12x-tiny.json").write_text(
        json.dumps(t))
    (root / "gpubench" / "metrics" / "outputs_per_pass.py").write_text(
        "def read(m):\n    return m['outputs'] / max(1, m['passes'])\n")
    b["workloads"].append({"name": "correct-tiny", "config": "correct-pb",
                           "traffic": "sim-clr-12x-tiny", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "outputs_per_pass", "unit": "piles",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["correct-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("correct-tiny", root=str(root),
                          bench_dir=str(root / "gpubench"))
    assert cell.traffic["reads"]["coverage"] == 12.0
    assert "outputs_per_pass" in {m.name for m in cell.end_to_end}
    old = spec.load_cell("correct-10x", root=str(root),
                         bench_dir=str(root / "gpubench"))
    assert "outputs_per_pass" not in {m.name for m in old.end_to_end}

    cell.config = dict(cell.config,
                       flags=list(cell.config["flags"]) + ["--nproc", "2"])
    result, checks = run_tiny(cell)
    assert result["correct"], checks
    assert result["metrics"]["outputs_per_pass"]["value"] > 0
    assert set(result["metrics"]) == {"bases_per_s", "error_pct", "setup_s",
                                      "outputs_per_pass"}
