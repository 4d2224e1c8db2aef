"""Whole runs of each driver at a tiny size on the CPU: the port's plain
versions against the plain reference come out correct, and each fault a
cell can have, planted under the timed path, makes ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from conftest import execute


def test_serve_run_matches_reference(tiny_root):
    r = execute(tiny_root, "tiny-serve", 2**33 + 5)
    assert r["correct"], r["checks"]
    assert r["checks"]["beam_score_err"]["value"] < 1e-5
    assert set(r["metrics"]) == {"setup_s", "retrieve_p95_ms", "queries_per_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


def test_serve_traced_run_reports_layer_metrics(tiny_root):
    r = execute(tiny_root, "tiny-serve", 11, trace=True)
    assert r["correct"], r["checks"]
    # no device here: the trace-derived metrics find nothing to read
    assert set(r["metrics"]) == {"mfu.serve"}
    assert r["device"]["window_s"] > 0 and r["breakdown"]["idle_gaps"]


def test_train_run_matches_reference(tiny_root):
    r = execute(tiny_root, "tiny-train", 2**40 + 3)
    assert r["correct"], r["checks"]
    # f32 on both sides, the same draws: equal to rounding
    assert r["info"]["loss0_rel_err"] < 1e-5
    assert r["checks"]["grad_leaf_gap"]["value"] < 1e-4
    assert set(r["metrics"]) == {"setup_s", "train_examples_per_s"}


def test_train_dp_ranks_match_reference(tiny_root):
    """Four rank processes over gloo (the cell's nccl path, rehearsed on
    the CPU): rank 0's readings against one reference step over the
    global batch with each rank's dropout draws."""
    r = execute(tiny_root, "tiny-train-dp", 2**36 + 1, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["info"]["loss0_rel_err"] < 1e-5
    assert r["checks"]["grad_leaf_gap"]["value"] < 1e-4
    assert r["attempted"] % 8 == 0 and r["attempted"] > 0


def _altered_doc(monkeypatch):
    from gdr_tpu_torch.eval import evaluator
    real = evaluator.rerank_packed

    def wrong(*a, **k):
        rr = real(*a, **k)
        rr.doc_ids[:, :, 0] = (rr.doc_ids[:, :, 0] + 1) % 200
        return rr
    monkeypatch.setattr(evaluator, "rerank_packed", wrong)


def _altered_token(monkeypatch):
    from gdr_tpu_torch.eval import evaluator
    real = evaluator.generate_cids

    def wrong(*a, **k):
        res, q, enc = real(*a, **k)
        res.sequences[:, 0, 1] = 2 + (res.sequences[:, 0, 1] - 1) % 4
        return res, q, enc
    monkeypatch.setattr(evaluator, "generate_cids", wrong)


@pytest.mark.parametrize("fault", [_altered_doc, _altered_token],
                         ids=["answer", "token"])
def test_serve_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = execute(tiny_root, "tiny-serve", 7)
    assert not r["correct"], r["checks"]


def _unchanged_state(monkeypatch):
    from gdr_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.GroupedAdamW, "update",
                        lambda self, *a, **k: False)


def _half_batch(monkeypatch):
    from gdr_tpu_torch.train import trainer
    real = trainer.make_train_step

    def halved(*a, **k):
        step = real(*a, **k)

        def half(state, batch, store, seed, noise=None):
            n = len(batch["input_ids"]) // 2
            return step(state, {key: v[:n] for key, v in batch.items()},
                        store, seed, noise)
        return half
    monkeypatch.setattr(trainer, "make_train_step", halved)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch],
                         ids=["unchanged", "half-batch"])
def test_train_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    r = execute(tiny_root, "tiny-train", 9)
    assert not r["correct"], r["checks"]


def test_train_dp_without_the_exchange_is_not_correct(tiny_root, tmp_path,
                                                     monkeypatch):
    """The gradient all-reduce left out in every rank process (planted
    through a ``sitecustomize`` on their path): each rank steps with its
    own share of the gradient."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "from gdr_tpu_torch.parallel import mesh\n"
        "mesh.Mesh.all_reduce_dp = lambda self, tensors: None\n")
    monkeypatch.setenv("PYTHONPATH", str(hook))
    r = execute(tiny_root, "tiny-train-dp", 13, seconds=1.0)
    assert not r["correct"], r["checks"]


def test_train_dp_rank_that_loads_the_jax_package_gives_no_result(
        tiny_root, tmp_path, monkeypatch):
    """A module of the JAX package loaded in one rank process alone (the
    last, planted through a ``sitecustomize`` on the ranks' path) ends
    the run without a result, naming the rank and the module."""
    from gdrbench import harness
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "import sys, types\n"
        "a = sys.argv\n"
        "if '--rank' in a and a[a.index('--rank') + 1] == '3':\n"
        "    sys.modules['gdr_tpu.planted'] = types.ModuleType('planted')\n")
    monkeypatch.setenv("PYTHONPATH", str(hook))
    with pytest.raises(harness.ForbiddenModules,
                       match=r"rank 3: \['gdr_tpu.planted'\]"):
        execute(tiny_root, "tiny-train-dp", 17, seconds=1.0)


@pytest.mark.cuda
def test_controls_fail_on_the_card():
    """The controls at the cells' own sizes (``gdrbench/control.py``):
    the reference one precision below the configuration's comes out not
    correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdrbench import control
    for cell in ("serve-b32", "serve-b1", "train-b64"):
        rows = control.readings(cell, [101], which="control")
        assert not rows[0]["correct"], rows
