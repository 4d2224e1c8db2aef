"""``gdr_tpu_torch/train/optimizer.py`` against ``gdr_tpu``'s optax
optimizer (``clip_by_global_norm`` → ``multi_transform`` of six AdamW
groups, inside ``MultiSteps`` when accumulating): the group of every port
parameter against the reference's label of its bridged leaf, and three
updates on the same f32 parameters and gradients, with each schedule and
warmup, with the clip active, and with accumulation k = 2.  Tolerance:
f32, rtol 1e-5 and atol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gdr_tpu.config import TrainConfig as JaxTrainConfig
from gdr_tpu.config import tiny_config as jax_tiny_config
from gdr_tpu.models.dual_encoder import tiny_doc_encoder
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from gdr_tpu_torch.config import TrainConfig
from gdr_tpu_torch.convert import (doc_encoder_params_from_flax,
                                   params_from_flax, params_to_flax)
from gdr_tpu_torch.train.optimizer import GROUPS, build_optimizer, flat

TOL = dict(rtol=1e-5, atol=1e-5)


def _trees():
    jc = jax_tiny_config()
    jm = JaxRetriever(dataclasses.replace(jc.model, denoising=True,
                                          concate_fusion=True))
    gen = init_params(jm, jax.random.PRNGKey(0), input_len=8)
    dummy = jnp.zeros((2, 8), jnp.int32)
    doc = tiny_doc_encoder(16).init(jax.random.PRNGKey(1), dummy,
                                    jnp.ones_like(dummy))
    return (jax.tree_util.tree_map(np.asarray, gen),
            jax.tree_util.tree_map(np.asarray, doc))


def _port(gen, doc):
    return {"generator": params_from_flax(gen),
            "doc_encoder": doc_encoder_params_from_flax(doc)}


def test_every_parameter_is_in_the_reference_group():
    gen, doc = _trees()
    _, labels = jax_build_optimizer(JaxTrainConfig(), gen, doc, 10)
    params = _port(gen, doc)
    _, mine = build_optimizer(TrainConfig(), params, 10)
    # the generator: each port parameter's flax leaves (q / k / v of a
    # fused qkv weight) carry the port's label
    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(labels["generator"])}
    seen = set()
    for name, p in params["generator"].items():
        for path, _ in jax.tree_util.tree_leaves_with_path(
                params_to_flax({name: p})):
            key = jax.tree_util.keystr(path)
            assert ref[key] == mine[f"generator/{name}"], (name, key)
            seen.add(key)
    assert seen == set(ref)
    # the doc tower: its labels as codes, through the forward bridge
    code = {g: float(i) for i, g in enumerate(GROUPS)}
    coded = doc_encoder_params_from_flax(jax.tree_util.tree_map(
        lambda lab, leaf: np.full(np.shape(leaf), code[lab], np.float32),
        labels["doc_encoder"], doc))
    for name, t in coded.items():
        assert (t == code[mine[f"doc_encoder/{name}"]]).all(), name
    assert {g for g in mine.values()} == set(GROUPS)


CASES = {
    "linear with warmup": dict(scheduler="linear", warmup_steps=2),
    "exp": dict(scheduler="exp"),
    "clip active": dict(max_grad_norm=0.5),
    "accumulation k=2": dict(gradient_accumulation_steps=2, warmup_steps=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_updates_match_optax(case):
    kw = {**dict(weight_decay=0.1, max_grad_norm=1e3, learning_rate=3e-3,
                 decoder_learning_rate=1e-3, doc_encoder_learning_rate=2e-3),
          **CASES[case]}
    gen, doc = _trees()
    jcfg = dataclasses.replace(JaxTrainConfig(), **kw)
    opt, _ = jax_build_optimizer(jcfg, gen, doc, 10)
    jparams = {"generator": gen, "doc_encoder": doc}
    jstate = opt.init(jparams)
    params = _port(gen, doc)
    topt, _ = build_optimizer(dataclasses.replace(TrainConfig(), **kw),
                              params, 10)
    tstate = topt.init(params)
    rng = np.random.default_rng(0)
    k = kw.get("gradient_accumulation_steps", 1)
    for step in range(3 * k):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=np.shape(x)) * 0.3).astype(np.float32),
            jparams)
        upd, jstate = opt.update(grads, jstate, jparams)
        jparams = jax.tree_util.tree_map(np.asarray,
                                         optax.apply_updates(jparams, upd))
        applied = topt.update(params, flat(_port(grads["generator"],
                                                 grads["doc_encoder"])),
                              tstate)
        assert applied == ((step + 1) % k == 0)
    want = flat(_port(jparams["generator"], jparams["doc_encoder"]))
    for key, t in flat(params).items():
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), **TOL,
                                   err_msg=key)
    assert tstate["count"] == 3
    moved = max((t - w).abs().max().item() for t, w in zip(
        flat(params).values(), flat(_port(gen, doc)).values()))
    assert moved > 1e-3                       # the updates were not no-ops
