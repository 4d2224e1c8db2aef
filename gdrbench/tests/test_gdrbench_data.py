"""The harness is driven by data: a configuration, a cell and a metric
are added as files and entries, with no file that exists edited; and
BENCHMARK.json keeps to the benchmark's rules."""

from __future__ import annotations

import hashlib
import json
import shutil

from conftest import REPO
from gdrbench import harness


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_benchmark_json_keeps_the_rules():
    spec = harness.load_spec(REPO)
    assert harness.validate(spec, REPO) == []
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [c["name"] for c in spec["configs"]]
    assert all(harness.NAME.match(n) for n in names)
    assert all(harness.UNIT.match(m["unit"])
               for m in spec["end_to_end"] + spec["per_layer"])
    assert spec["end_to_end"][0]["name"] == "setup_s"


def test_pending_cells_keep_the_rules():
    """The training cells kept out of BENCHMARK.json for now are whole
    entries: added as they stand, the spec still keeps the rules."""
    spec = harness.with_pending(harness.load_spec(REPO), REPO)
    assert harness.validate(spec, REPO) == []
    assert {"train-b64", "train-b64-dp4"} <= {w["name"]
                                             for w in spec["workloads"]}
    cell = harness.cell(spec, "train-b64-dp4", REPO)
    assert cell.chips == 4 and "collective_ms.train" in [
        m["name"] for m in cell.per_layer]


def test_bad_names_and_units_are_reported():
    spec = harness.load_spec(REPO)
    spec["per_layer"][0]["name"] = "bad name"
    spec["end_to_end"][1]["unit"] = "queries per second"
    errs = harness.validate(spec, REPO)
    assert any("bad name" in e for e in errs)
    assert any("bad unit" in e for e in errs)


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "gdrbench", root / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _hashes(root / "gdrbench")

    cfg = json.loads((root / "gdrbench/configs/gdr-t5-base-f32.json")
                     .read_text())
    cfg["store"]["n_docs"] = 100_000
    (root / "gdrbench/configs/new-config.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "gdrbench/traffic/serve-b32.json").read_text())
    tr["batch"] = 8
    (root / "gdrbench/traffic/serve-b8.json").write_text(json.dumps(tr))
    (root / "gdrbench/metrics/new_metric.serve.py").write_text(
        "def read(layer):\n    return layer.get('units')\n")
    spec = harness.load_spec(root)
    spec["configs"].append({"name": "new-config", "source": "https://x.org",
                            "file": "gdrbench/configs/new-config.json",
                            "reduced": ["n_docs"], "why": "a test"})
    spec["workloads"].append({"name": "serve-b8", "config": "new-config",
                              "traffic": "serve-b8", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "serve-b32" in m["workloads"]:
            m["workloads"].append("serve-b8")
    spec["per_layer"].append({"name": "new_metric.serve", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "queries_per_s",
                              "workloads": ["serve-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    assert harness.validate(spec, root) == []
    cell = harness.cell(spec, "serve-b8", root)
    assert cell.traffic["batch"] == 8
    assert cell.config["store"]["n_docs"] == 100_000
    assert [m["name"] for m in cell.per_layer] == ["new_metric.serve"]
    assert harness.read_layer_metrics(cell, {"units": 3}, root) == {
        "new_metric.serve": {"value": 3, "unit": "n"}}
    after = _hashes(root / "gdrbench")
    assert all(after[p] == h for p, h in before.items())
