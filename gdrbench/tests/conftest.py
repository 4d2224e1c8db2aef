"""Fixtures of the benchmark's own tests: a checkout root in ``tmp_path``
holding a copy of the harness and a ``BENCHMARK.json`` with tiny cells
(the cells' configurations cut to a few layers of width 32, the pending
training cells' metrics with them), so that a whole run of each driver
fits a CPU test."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from gdrbench import harness  # noqa: E402

TINY_MODEL = dict(vocab_size=128, d_model=32, d_kv=16, d_ff=64, num_layers=2,
                  num_decoder_layers=2, num_heads=2, kary=4,
                  max_output_length=5, adaptor_layer_num=1,
                  adaptor_num_heads=2, encoder_d_model=32)
TINY_STORE = dict(n_docs=200, kary=4, leaf_cap=4, max_docs_per_cluster=4)


def _tiny(root: Path, spec: dict, cell: str, config: str, traffic: str,
          model: dict, extra: dict, traffic_extra: dict,
          chips: int = 1) -> None:
    cfg = json.loads((REPO / "gdrbench" / "configs" / f"{config}.json")
                     .read_text())
    cfg["model"].update(model)
    cfg["store"].update(TINY_STORE)
    cfg["max_input_length"] = 12
    for k, v in extra.items():
        cfg[k].update(v)
    (root / "gdrbench" / "configs" / f"{cell}.json").write_text(
        json.dumps(cfg))
    tr = json.loads((REPO / "gdrbench" / "traffic" / f"{traffic}.json")
                    .read_text())
    tr.update(lengths=[[3, 1], [6, 2], [12, 1]], **traffic_extra)
    (root / "gdrbench" / "traffic" / f"{cell}.json").write_text(json.dumps(tr))
    spec["configs"].append({"name": cell, "source": "tiny", "reduced": [],
                            "file": f"gdrbench/configs/{cell}.json",
                            "why": "a CPU test's size"})
    spec["workloads"].append({"name": cell, "config": cell, "traffic": cell,
                              "chips": chips, "why": "a CPU test's size"})


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout root with the cells ``tiny-serve`` and ``tiny-train``
    beside the benchmark's own."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "gdrbench", root / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.with_pending(harness.load_spec(REPO), REPO)
    _tiny(root, spec, "tiny-serve", "gdr-t5-base-f32", "serve-b32", TINY_MODEL,
          {"eval": dict(num_beams=8, num_return_sequences=8,
                        max_output_length=5)},
          dict(batch=3, check_requests=3, trace_requests=2,
               max_requests_per_s=20))
    _tiny(root, spec, "tiny-train", "gdr-t5-base-bf16-train", "train-b64",
          TINY_MODEL, {"train": dict(train_batch_size=4, bf16=False,
                                     max_intraclass_num=3)},
          dict(max_steps_per_s=20, trace_steps=2))
    _tiny(root, spec, "tiny-train-dp", "gdr-t5-base-bf16-train", "train-b64",
          TINY_MODEL, {"train": dict(train_batch_size=2, bf16=False,
                                     max_intraclass_num=3)},
          dict(max_steps_per_s=20, trace_steps=2), chips=4)
    names = {"serve": ["tiny-serve"], "train": ["tiny-train", "tiny-train-dp"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kinds = {w.split("-")[0] for w in m["workloads"]}
            m["workloads"] += [n for k in sorted(kinds) for n in names.get(k, [])]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def execute(root: Path, cell: str, seed: int, seconds: float = 0.3,
            trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU, the look for a card skipped."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gdrbench_run", REPO / "gdrbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.execute(cell, seed, seconds, trace, "cpu", root=root)
