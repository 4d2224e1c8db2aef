"""The whole training loss and its gradient against ``gdr_tpu``'s: the
reference's ``make_train_step`` runs with an optimizer that only records
the gradients it is given, and the port's ``compute_grads`` runs on the
same bridged weights and batch, with the reference's own draws handed in
(the input-dropout gate and keep mask, the denoising keep mask and the
Gumbel noise of its categorical, all from the step's folded key).  The
port's gradients go through the inverse bridge (``params_to_flax``) to the
reference's leaves; the doc tower's through its forward bridge.  Module
dropout cannot be injected, so ``dropout_rate`` is 0.  Then three whole
train steps with the reference's own optimizer.  Tolerance: f32, rtol
1e-5 and atol 1e-5 (grad norm rtol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdr_tpu.config import tiny_config as jax_tiny_config
from gdr_tpu.models.dual_encoder import tiny_doc_encoder
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from gdr_tpu.train.trainer import TrainState as JaxTrainState
from gdr_tpu.train.trainer import make_train_step as jax_make_train_step
from gdr_tpu_torch.config import tiny_config
from gdr_tpu_torch.convert import (doc_encoder_params_from_flax,
                                   params_from_flax, params_to_flax)
from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.models.gdr import GenerativeRetriever
from gdr_tpu_torch.train.trainer import (compute_grads, init_train_state,
                                         make_loss_fn, make_train_step)
from gdr_tpu_torch.utils.rng import generator

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, C, N, LE = 4, 16, 5, 40, 12
LABELS = np.array([[2, 7, 11, 1, 0], [3, 8, 1, 0, 0], [5, 6, 12, 16, 1],
                   [4, 1, 0, 0, 0]], np.int32)


def _configs(model_kw, train_kw=None):
    jc, tc = jax_tiny_config(), tiny_config()
    mk = dict(dropout_rate=0.0, **model_kw)
    tk = dict(bf16=False, **(train_kw or {}))
    return (jc.replace(model=dataclasses.replace(jc.model, **mk),
                       train=dataclasses.replace(jc.train, **tk)),
            tc.replace(model=dataclasses.replace(tc.model, **mk),
                       train=dataclasses.replace(tc.train, **tk)))


def _batch(rng, extra=()):
    ids = rng.integers(2, 128, size=(B, S)).astype(np.int32)
    ids[:, -1] = 1
    mask = np.ones((B, S), np.int32)
    mask[2, 12:] = 0
    batch = dict(input_ids=ids, attn_mask=mask, labels=LABELS,
                 label_mask=(LABELS > 0).astype(np.int32),
                 pos_idx=rng.integers(0, N, B).astype(np.int32),
                 cand_idx=rng.integers(0, N, (B, C)).astype(np.int32),
                 cand_mask=np.concatenate([rng.random((B, C - 1)) < 0.8,
                                           np.ones((B, 1), bool)], 1))
    if "aug" in extra:
        batch["aug_input_ids"] = rng.integers(2, 128, (B, S)).astype(np.int32)
        batch["aug_attn_mask"] = np.ones((B, S), np.int32)
    if "prefix" in extra:
        batch["prefix_emb"] = rng.normal(size=(B, 5, 16)).astype(np.float32)
        batch["prefix_emb_mask"] = (LABELS > 1).astype(np.float32)
    if "neg" in extra:
        neg = np.stack([np.roll(LABELS, k, axis=0) for k in (1, 2)], 1)
        batch["neg_labels"] = neg
        batch["neg_label_mask"] = (neg > 0).astype(np.int32)
    if "stage2" in extra:
        for name, shape in (("pos", (B, LE)), ("cand", (B, C, LE))):
            batch[f"{name}_tokens"] = rng.integers(1, 512, shape).astype(
                np.int32)
            m = np.ones(shape, np.int32)
            m[..., LE - 3:] = rng.random(shape[:-1] + (3,)) < 0.5
            batch[f"{name}_tok_mask"] = m
    return batch


def _reference_draws(key, step, mcfg, batch):
    """The reference step's own draws, from its folded and split key."""
    r = jax.random.fold_in(key, step)
    _, r_gate, r_mask, r_den, r_den2 = jax.random.split(r, 5)
    b, s = batch["input_ids"].shape
    noise = {}
    if mcfg.input_dropout > 0:
        noise["input_gate"] = bool(jax.random.bernoulli(r_gate,
                                                        mcfg.input_dropout))
        noise["input_keep"] = torch.as_tensor(np.array(
            jax.random.bernoulli(r_mask, 0.9, (2 * b, s))))
    if mcfg.denoising:
        noise["denoise_keep"] = torch.as_tensor(np.array(
            jax.random.bernoulli(r_den, 0.9, (b, s))))
        noise["denoise_gumbel"] = torch.as_tensor(np.array(jax.random.gumbel(
            r_den2, (b, s, mcfg.vocab_size), jnp.float32)))
    return noise


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


CASES = {
    "Contrast, denoising, embedding distillation, input dropout": (
        dict(input_dropout=0.5, denoising=True, embedding_distillation=0.3),
        ()),
    "KL, weight distillation, hard negatives, aug queries": (
        dict(rdrop_loss="KL", input_dropout=0.0, weight_distillation=0.4),
        ("aug", "prefix", "neg")),
    "L2, slow PAWA (full-vocab head), hard negatives": (
        dict(rdrop_loss="L2", adaptor_efficient=False, input_dropout=0.5),
        ("neg",)),
    "stage 2, live doc tower": (dict(input_dropout=0.5), ("stage2",)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_reference(case):
    torch.set_num_threads(2)
    model_kw, extra = CASES[case]
    stage = 2 if "stage2" in extra else 1
    jc, tc = _configs(model_kw)
    jm = JaxRetriever(jc.model)
    params = {"generator": init_params(jm, jax.random.PRNGKey(0),
                                       input_len=S)}
    jenc = tenc = None
    if stage == 2:
        jenc = tiny_doc_encoder(d_model=jc.model.encoder_d_model)
        dummy = jnp.zeros((2, LE), jnp.int32)
        params["doc_encoder"] = jenc.init(jax.random.PRNGKey(1), dummy,
                                          jnp.ones_like(dummy))
    host = jax.tree_util.tree_map(np.asarray, params)
    tm = GenerativeRetriever(tc.model)
    tm.load_state_dict(params_from_flax(host["generator"]))
    if stage == 2:
        tenc = DocEncoder(tiny_doc_encoder_config(tc.model.encoder_d_model))
        tenc.load_state_dict(doc_encoder_params_from_flax(
            host["doc_encoder"]))

    rng = np.random.default_rng(1)
    batch = _batch(rng, extra)
    store = rng.normal(size=(N, 16)).astype(np.float32)
    record = optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                              {"g": g}))
    step = jax_make_train_step(jm, jenc, record, jc, stage=stage)
    key = jax.random.PRNGKey(3)
    state = JaxTrainState.create(params, record)
    state, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.asarray(store), key)
    jgrads = state.opt_state["g"]

    loss_fn = make_loss_fn(tm, tenc, tc, stage=stage)
    got, grads = compute_grads(
        tm, tenc, loss_fn, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.as_tensor(store), generator(0, 0, "cpu"),
        _reference_draws(key, 0, jc.model, batch))
    assert set(got) == set(want) - {"grad_norm"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL,
                                   err_msg=k)
    gen = {k.split("/", 1)[1]: v for k, v in grads.items()
           if k.startswith("generator/")}
    mine, ref = _flat(params_to_flax(gen)), _flat(jgrads["generator"])
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], **TOL, err_msg=k)
    if stage == 2:
        ref_doc = doc_encoder_params_from_flax(
            jax.tree_util.tree_map(np.asarray, jgrads["doc_encoder"]))
        for name, g in ref_doc.items():
            np.testing.assert_allclose(grads[f"doc_encoder/{name}"].numpy(),
                                       g.numpy(), **TOL, err_msg=name)
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    np.testing.assert_allclose(norm.item(), float(want["grad_norm"]),
                               rtol=1e-5)


def test_three_train_steps_with_the_reference_optimizer():
    """Three whole steps (loss, backward, clip, six-group AdamW with a
    warmup) on one weight set: the losses, grad norms and the f32 masters
    after them."""
    torch.set_num_threads(2)
    jc, tc = _configs(dict(input_dropout=0.5, embedding_distillation=0.5),
                      dict(warmup_steps=2, max_grad_norm=50.0))
    jm = JaxRetriever(jc.model)
    params = init_params(jm, jax.random.PRNGKey(0), input_len=S)
    tm = GenerativeRetriever(tc.model)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    opt, _ = jax_build_optimizer(jc.train, params, None, 10)
    step = jax_make_train_step(jm, None, opt, jc, stage=1)
    state = JaxTrainState.create({"generator": params}, opt)
    tstate, topt = init_train_state(tc, tm, None, 10)
    tstep = make_train_step(tm, None, topt, tc, stage=1)
    rng = np.random.default_rng(0)
    store = rng.normal(size=(N, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for i in range(3):
        batch = _batch(rng)
        state, want = step(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jnp.asarray(store), key)
        tstate, got = tstep(tstate, batch, torch.as_tensor(store), 0,
                            _reference_draws(key, i, jc.model, batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       **TOL, err_msg=f"step {i} {k}")
    mine = _flat(params_to_flax(tstate.params["generator"]))
    ref = _flat(state.params["generator"])
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], **TOL, err_msg=k)
    assert tstate.step == 3 and tstate.opt_state["count"] == 3
