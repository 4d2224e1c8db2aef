"""``gdr_tpu_torch/train/loop.py::TrainLoop`` and ``train/checkpoint.py``
on the CPU, on the small world of ``chip_smoke.py`` phase 7 (every loss
on, a tiny live doc tower from epoch 1): two epochs with eval, resume bit
for bit with dropout on, a mid-epoch preemption that runs its epoch again,
the per-epoch resume point, the deadline, the evaluator reading the
trained U, the checkpoint policy (best-k by the monitored metric, the
latest-1 resume point), and a port-trained ``params.npz`` giving the
reference package the same forward (f32, rtol 1e-5 and atol 1e-5)."""

import json
import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import _same_state, _small_train_world
from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu_torch.convert import load_tree_npz, save_params_npz
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, init_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.models.gdr import shift_right
from gdr_tpu_torch.train.checkpoint import CheckpointManager
from gdr_tpu_torch.train.loop import TrainLoop
from gdr_tpu_torch.train.trainer import TrainState
from gdr_tpu_torch.utils.preemption import PreemptionGuard


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    return _small_train_world(1, 0.1)


def _loop(world, workdir, **kw) -> TrainLoop:
    cfg, index, ts, dev, dtok, dmask = world
    tower = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
    init_doc_encoder(tower, torch.Generator().manual_seed(1))
    return TrainLoop(cfg, index, ts, dev, str(workdir), seed=3,
                     doc_tokens=dtok, doc_tok_mask=dmask, doc_encoder=tower,
                     device="cpu", **kw)


def test_two_epochs_with_eval_and_the_stage_switch(world, tmp_path):
    loop = _loop(world, tmp_path, packed_eval=True)
    store0 = loop.store.clone()
    best = loop.run(max_epochs=2)
    assert "recall1" in best and np.isfinite(best["avg_train_loss"])
    rows = [json.loads(ln) for ln in
            (tmp_path / "train.metrics.jsonl").read_text().splitlines()]
    assert [r["stage"] for r in rows if "stage" in r] == [1, 2]
    assert not torch.equal(loop.store, store0)      # stage 2 re-embedded
    assert (tmp_path / "ckpt" / "metrics.json").exists()
    assert loop.state.step == 2 * (len(world[2]) // 4)


def test_resume_is_bit_equal_with_dropout_on(world, tmp_path):
    a = _loop(world, tmp_path / "a")
    a.run(max_epochs=2)
    _loop(world, tmp_path / "b").run(max_epochs=1)
    b = _loop(world, tmp_path / "b")
    assert b.start_epoch == 1
    b.run(max_epochs=2)
    _same_state("resume", a.state, b.state)


def test_mid_epoch_preemption_runs_the_epoch_again(world, tmp_path):
    spe = len(world[2]) // 4
    _loop(world, tmp_path).run(max_epochs=1)
    c = _loop(world, tmp_path)
    guard = PreemptionGuard(signals=())
    guard.request_stop()
    c.run(max_epochs=2, guard=guard)
    assert c.state.step == spe + 1
    c2 = _loop(world, tmp_path)
    assert (c2.start_epoch, c2.state.step) == (1, spe + 1)
    c2.run(max_epochs=2)
    assert c2.state.step == 2 * spe + 1


def test_every_epoch_leaves_a_resume_point_and_the_deadline_stops(
        world, tmp_path):
    loop = _loop(world, tmp_path)
    loop.run(max_epochs=3, deadline=time.time())   # stops after epoch 0
    assert loop.state.step == len(world[2]) // 4
    assert sorted(p.name for p in (tmp_path / "ckpt_preempt").iterdir()) \
        == ["1.pt"]
    assert _loop(world, tmp_path).start_epoch == 1


def test_eval_reads_the_trained_u_table(world, tmp_path):
    loop = _loop(world, tmp_path)
    before = loop.evaluator._u_table().clone()
    loop.run(max_epochs=1)
    after = loop.evaluator._u_table()
    assert not torch.equal(after, before)
    with torch.no_grad():
        fresh = loop.model.decode_tables(loop.evaluator._max_len)
    assert torch.equal(after, fresh)


def test_port_trained_params_give_the_reference_the_same_forward(
        world, tmp_path):
    loop = _loop(world, tmp_path)
    loop.run(max_epochs=1)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, loop.state.params["generator"])
    cfg = world[0].model
    jm = JaxRetriever(JaxModelConfig(**{
        f: getattr(cfg, f) for f in JaxModelConfig.__dataclass_fields__}))
    params = jax.tree_util.tree_map(np.asarray, load_tree_npz(path))
    model = loop.model.float()
    ids, mask = world[2].input_ids[:3], world[2].attn_mask[:3]
    labels = world[2].labels[:3]
    lm = world[2].label_mask[:3]
    dec = shift_right(torch.as_tensor(labels))
    want = jm.apply(params, ids, mask, dec.numpy(), lm, sliced_head=True)
    got = model(torch.as_tensor(ids), torch.as_tensor(mask), dec,
                torch.as_tensor(lm), sliced_head=True)
    for k in want:
        w = np.asarray(want[k])
        ok = np.abs(w) < 1e8
        np.testing.assert_allclose(got[k].detach().numpy()[ok], w[ok],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _state(v: float) -> TrainState:
    return TrainState(params={"generator": {"w": torch.full((3,), v)}},
                      opt_state={"count": int(v), "mu": {}, "nu": {},
                                 "acc": None}, step=int(v))


@pytest.mark.parametrize("monitor,values,kept", [
    ("recall1", [0.2, 0.5, 0.1, 0.5], [1, 3]),       # max; a tie keeps newer
    ("avg_train_loss", [3.0, 1.0, 2.0, 1.5], [1, 3]),  # min
])
def test_best_k_retention(tmp_path, monitor, values, kept):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), monitor=monitor,
                            mode="min" if monitor.endswith("loss") else "max",
                            save_top_k=2)
    for step, v in enumerate(values):
        mgr.save(step, _state(step), {monitor: v})
    assert sorted(int(p.stem) for p in (tmp_path / "ckpt").glob("*.pt")) \
        == kept
    assert mgr.best_step() == max(kept, key=lambda s: (
        values[s] if monitor == "recall1" else -values[s], s))
    step, best = mgr.restore_best()
    assert step == mgr.best_step() and best.step == step


def test_restore_latest_rule(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore_latest() == (None, None, False)
    mgr.save(2, _state(2.0), {"recall1": 0.3})
    mgr.save_preemption(2, _state(20.0))            # a tie: the regular wins
    step, st, pre = mgr.restore_latest()
    assert (step, pre, st.step) == (2, False, 2)
    mgr.save_preemption(3, _state(3.0))             # newer: resume point
    step, st, pre = mgr.restore_latest()
    assert (step, pre) == (3, True)
    assert torch.equal(st.params["generator"]["w"], torch.full((3,), 3.0))
    assert [p.name for p in (tmp_path / "ckpt_preempt").iterdir()] == ["3.pt"]
