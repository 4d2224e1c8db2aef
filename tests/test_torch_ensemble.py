"""The port's N-decoder ensemble (models/ensemble.py, train/modes.py's
ensemble half) against gdr_tpu's, on bridged f32 weights of one tiny
configuration: the split/merge and bridge round trips, every member's
teacher-forced logits, one train step (dropout 0) at R-Drop off and with
Contrast / KL / L2 — loss, per-member losses and the parameters after the
4-group AdamW behind a global-norm clip, its "no decay" groups decaying at
optax's default 1e-4 as ``optax.adamw(lr)`` gives the reference — the
merge of the members' retrievals, the extra k-means assignments, and
``eval_ensemble``'s merged ranking.  Tolerance 1e-5 in f32 (logits 1e-4
atol, their scale is ~10)."""

import numpy as np
import optax
import pytest
import torch

import jax

from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.data import synthetic as jsyn
from gdr_tpu.eval.evaluator import EvalData as JaxEvalData
from gdr_tpu.index.builder import Index as JaxIndex
from gdr_tpu.models import ensemble as jens
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.train import modes as jmodes
from gdr_tpu.train.optimizer import _is_no_decay as jax_is_no_decay
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import (ensemble_from_flax, ensemble_to_flax,
                                   save_tree_npz)
from gdr_tpu_torch.data import synthetic as tsyn
from gdr_tpu_torch.eval.evaluator import EvalData
from gdr_tpu_torch.index.io import Index
from gdr_tpu_torch.models import ensemble as tens
from gdr_tpu_torch.ops.codec import digits_to_label
from gdr_tpu_torch.train import modes as tmodes
from torch_port_helpers import TINY

N = 2
KARY = TINY["kary"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ensemble(dropout: float = 0.0, seed: int = 0):
    kw = {**TINY, "dropout_rate": dropout}
    jm = JaxRetriever(JaxModelConfig(**kw))
    enc, dec = jens.init_ensemble(jm, jax.random.PRNGKey(seed), N,
                                  input_len=8)
    ens = tens.Ensemble(ModelConfig(**kw), N)
    ens.load_state_dict(ensemble_from_flax(_np({"enc": enc, "dec": dec})))
    return jm, {"enc": enc, "dec": dec}, ens


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    return _ensemble()


def _batch(rng, b: int = 4, s: int = 8):
    ids = rng.integers(2, 128, size=(b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[-1, s - 2:] = 0
    labels = np.zeros((N, b, TINY["max_output_length"]), np.int32)
    for i in range(N):
        for j in range(b):
            path = list(rng.integers(0, KARY, size=int(rng.integers(1, 4))))
            labels[i, j], _ = digits_to_label(path, KARY,
                                              TINY["max_output_length"])
    return {"input_ids": ids, "attn_mask": mask, "labels": labels,
            "label_mask": (labels != 0).astype(np.int32)}


def test_split_merge_and_bridge_round_trip(pair):
    _, tree, ens = pair
    # side_of: the encoder side is member 0's shared and encoder, once
    sides = {n: ens.side_of(n) for n, _ in ens.named_parameters()}
    assert set(sides.values()) == {"enc", "dec"}
    assert all(n.startswith(("members.0.shared.", "members.0.encoder."))
               for n, s in sides.items() if s == "enc")
    # the encoder side is one set of tensors for every member
    assert ens.members[1].shared.weight is ens.members[0].shared.weight
    back = ensemble_to_flax(ens)
    want = dict(jax.tree_util.tree_leaves_with_path(_np(tree)))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_ensemble_logits_per_member_match_jax(pair):
    jm, tree, ens = pair
    b = _batch(np.random.default_rng(0))
    lg_j, hd_j = jens.ensemble_logits(jm, tree["enc"], tree["dec"],
                                      b["input_ids"], b["attn_mask"],
                                      b["labels"], b["label_mask"],
                                      return_hidden=True)
    with torch.no_grad():
        lg_t, hd_t = tens.ensemble_logits(
            ens, *(torch.tensor(b[k]) for k in ("input_ids", "attn_mask",
                                                "labels", "label_mask")))
    assert lg_t.shape == (N, 4, TINY["max_output_length"], lg_t.shape[-1])
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(hd_t.numpy(), np.asarray(hd_j), atol=1e-5)


def _jax_optimizer(params, lr, decoder_lr):
    """train_ensemble's optimizer, as gdr_tpu/train/modes.py builds it."""
    def group(path, _):
        side = str(getattr(path[0], "key", path[0]))
        return f"{side}_{'nd' if jax_is_no_decay(path) else 'wd'}"

    transforms = {"enc_wd": optax.adamw(lr, weight_decay=1e-4),
                  "enc_nd": optax.adamw(lr),
                  "dec_wd": optax.adamw(decoder_lr, weight_decay=1e-4),
                  "dec_nd": optax.adamw(decoder_lr)}
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.multi_transform(
                           transforms,
                           jax.tree_util.tree_map_with_path(group, params)))


@pytest.mark.parametrize("rdrop,loss", [(0.0, "Contrast"), (0.5, "Contrast"),
                                        (0.5, "KL"), (0.5, "L2")])
def test_train_step_matches_jax(rdrop, loss):
    jm, params, ens = _ensemble(seed=1)
    lr, dlr = 1e-3, 5e-4
    opt_j = _jax_optimizer(params, lr, dlr)
    state_j = opt_j.init(params)
    step_j = jens.make_ensemble_train_step(jm, opt_j, rdrop=rdrop,
                                           rdrop_loss=loss)
    step_t = tens.make_ensemble_train_step(
        ens, tmodes.ensemble_optimizer(ens, lr, dlr), rdrop=rdrop,
        rdrop_loss=loss)
    rng = np.random.default_rng(3)
    for i in range(2):
        b = _batch(rng)
        params, state_j, loss_j, per_j = step_j(params, state_j, b,
                                                jax.random.PRNGKey(i))
        loss_t, per_t = step_t({k: torch.tensor(v) for k, v in b.items()},
                               torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j),
                                   rtol=1e-5)
    want = ensemble_from_flax(_np(params))
    for name, p in ens.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_no_decay_groups_decay_at_the_optax_default():
    """With zero gradients AdamW moves a parameter only by its decay: the
    reference's enc_nd / dec_nd groups are ``optax.adamw(lr)``, whose
    weight decay is 1e-4, and the port's move by the same amount."""
    _, params, ens = _ensemble(seed=2)
    lr, dlr = 0.5, 0.25
    opt_j = _jax_optimizer(params, lr, dlr)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    upd, _ = opt_j.update(zeros, opt_j.init(params), params)
    want = ensemble_from_flax(_np(optax.apply_updates(params, upd)))
    opt_t = tmodes.ensemble_optimizer(ens, lr, dlr)
    opt_t.step()                                  # no .grad: zero gradients
    got = ens.state_dict()
    scale = "members.1.decoder.final_norm.scale"
    assert opt_t.labels[scale] == "dec_nd"
    np.testing.assert_allclose(got[scale].numpy(), 1 - dlr * 1e-4, rtol=1e-7)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_train_step_needs_a_generator_for_rdrop(pair):
    _, _, ens = pair
    step = tens.make_ensemble_train_step(
        ens, tmodes.ensemble_optimizer(ens, 1e-3, 5e-4), rdrop=0.1)
    b = {k: torch.tensor(v) for k, v in _batch(np.random.default_rng(0)
                                                ).items()}
    with pytest.raises(ValueError, match="generator"):
        step(b)


def test_merge_retrievals_matches_jax():
    rng = np.random.default_rng(4)
    docs = [[str(d) for d in rng.choice(30, 12, replace=False)]
            for _ in range(3)]
    scores = [list(rng.normal(size=12)) for _ in range(3)]
    for k in (1, 5, 40):
        assert tens.merge_retrievals(docs, scores, k) == \
            jens.merge_retrievals(docs, scores, k)


def _worlds(seed=0, n_docs=40):
    kw = dict(n_docs=n_docs, dim=TINY["encoder_d_model"], kary=KARY,
              leaf_cap=4, max_output_length=TINY["max_output_length"],
              seed=seed)
    jt, tt = jsyn.build_synthetic_task(**kw), tsyn.build_synthetic_task(**kw)
    j_index = JaxIndex(jt.store, jt.trie, jt.paths, jt.cid_of_doc)
    t_index = Index(tt.store, tt.trie, tt.paths, tt.cid_of_doc)
    return jt, tt, j_index, t_index


def test_synthetic_task_and_assignments_match_jax():
    jt, tt, j_index, t_index = _worlds()
    assert tt.paths == jt.paths and tt.cid_of_doc == jt.cid_of_doc
    for name in ("store", "input_ids", "labels", "label_mask", "cand_idx",
                 "cand_mask"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    np.testing.assert_array_equal(tt.trie.children, jt.trie.children)
    idx = np.arange(5)
    assert tsyn.batch_slice(tt, idx).keys() == jsyn.batch_slice(jt, idx).keys()
    got = tmodes.alternative_assignments(t_index, 3, KARY, 4, seed=0,
                                         device="cpu")
    want = jmodes.alternative_assignments(j_index, 3, KARY, 4, seed=0)
    assert got == want
    arr = tmodes.paths_to_array(got)
    np.testing.assert_array_equal(arr, jmodes.paths_to_array(want))
    assert tmodes.array_to_paths(arr) == got
    labels = tmodes._member_labels(got, tt.pos_idx, ModelConfig(**TINY))
    np.testing.assert_array_equal(
        labels, jmodes._member_labels(want, jt.pos_idx,
                                      JaxModelConfig(**TINY)))


def test_eval_ensemble_merged_ranking_matches_jax(pair, tmp_path,
                                                  monkeypatch):
    jm, tree, ens = pair
    jt, tt, j_index, t_index = _worlds(seed=1)
    paths = tmodes.alternative_assignments(t_index, N, KARY, 4, seed=3,
                                           device="cpu")
    np.save(tmp_path / "ensemble_paths.npy", tmodes.paths_to_array(paths))
    jmodes._save_msgpack(str(tmp_path / "ensemble.msgpack"), tree)
    save_tree_npz(str(tmp_path / "ensemble.npz"), _np(tree))
    nq = 10
    j_dev = JaxEvalData(jt.input_ids[:nq], jt.attn_mask[:nq],
                        jt.gt_docs[:nq], jt.gt_cids[:nq])
    t_dev = EvalData(tt.input_ids[:nq], tt.attn_mask[:nq], tt.gt_docs[:nq],
                     tt.gt_cids[:nq])
    merged = {}

    def capture(tag, real):
        def fn(preds, gts, **kw):
            merged[tag] = preds
            return real(preds, gts, **kw)
        return fn

    monkeypatch.setattr(jmodes.M, "full_suite",
                        capture("jax", jmodes.M.full_suite))
    monkeypatch.setattr(tmodes.M, "full_suite",
                        capture("port", tmodes.M.full_suite))
    mcfg_j, mcfg_t = JaxModelConfig(**TINY), ModelConfig(**TINY)
    want = jmodes.eval_ensemble(mcfg_j, j_index, j_dev, str(tmp_path), N,
                                beam=4, batch_size=4)
    got = tmodes.eval_ensemble(mcfg_t, t_index, t_dev, str(tmp_path), N,
                               beam=4, batch_size=4, device="cpu")
    assert merged["port"] == merged["jax"]
    assert any(merged["port"].values())
    assert got == want
