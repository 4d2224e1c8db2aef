"""The port's Seq2SeqLM (models/seq2seq.py) against gdr_tpu's, on bridged
f32 weights of one tiny configuration: teacher-forced logits, the
KV-cached decode step at every position of a 40-position cache (longer than
the CUDA self-attention core's register path, here through its plain
version), sampling and query generation with gdr_tpu's own Gumbel draws
handed in (``jax.random.categorical`` is ``argmax(x + gumbel(key))``; the
reference splits its key once per step), and one qg train step (dropout 0,
AdamW at optax's defaults, weight decay 1e-4 included).  Tolerance 1e-5
(atol and rtol; logits 1e-4 atol, their scale is ~10) in f32."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.models import seq2seq as jseq
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import params_from_flax, params_to_flax
from gdr_tpu_torch.models import seq2seq as tseq
from torch_port_helpers import TINY

VOCAB, S, LQ = 128, 10, 40


def _pair(dropout: float = 0.1, seed: int = 0):
    kw = {**TINY, "dropout_rate": dropout}
    jm = jseq.Seq2SeqLM(JaxModelConfig(**kw))
    ids = np.ones((2, S), np.int32)
    dq = np.zeros((2, 6), np.int32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, ids, ids, dq,
                     np.ones_like(dq))
    tm = tseq.Seq2SeqLM(ModelConfig(**kw))
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    return _pair()


def _docs(rng, b):
    ids = rng.integers(2, VOCAB, size=(b, S)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[-1, S - 3:] = 0
    return ids, mask


def _jax_noise(rng, steps: int, rows: int) -> torch.Tensor:
    """The Gumbel noise ``jseq.sample`` draws from ``rng``: one split per
    step, noise of the logits' shape."""
    out = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (rows, VOCAB),
                                                jnp.float32)))
    return torch.tensor(np.stack(out))


def test_bridge_round_trip_is_exact(pair):
    _, params, tm = pair
    back = params_to_flax(tm.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_teacher_forced_logits_match_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    ids, mask = _docs(rng, 3)
    q = rng.integers(2, VOCAB, size=(3, 7)).astype(np.int32)
    qm = np.ones_like(q)
    qm[0, 5:] = 0
    want = np.asarray(jm.apply(params, ids, mask, q, qm))
    got = tm(torch.tensor(ids), torch.tensor(mask), torch.tensor(q),
             torch.tensor(qm))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-5)


def test_decode_step_matches_jax_at_every_position_of_a_40_cache(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    ids, mask = _docs(rng, 3)
    toks = rng.integers(0, VOCAB, size=(LQ, 3)).astype(np.int32)
    enc_j = jm.apply(params, ids, mask, method=jm.encode)
    cache_j = jm.apply(params, enc_j, LQ, method=jm.init_cache)
    with torch.no_grad():
        enc_t = tm.encode(torch.tensor(ids), torch.tensor(mask))
        cache_t = tm.init_cache(enc_t, LQ)
        assert cache_t["tm_self_k_0"].shape[0] == LQ
        for pos in range(LQ):
            lg_j, cache_j = jm.apply(params, toks[pos], cache_j, mask,
                                     jnp.int32(pos), method=jm.decode_step)
            lg_t, cache_t = tm.decode_step(torch.tensor(toks[pos]), cache_t,
                                           torch.tensor(mask), pos)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                       atol=1e-4, rtol=1e-5,
                                       err_msg=f"pos {pos}")


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 10),
                                               (1.0, 3)])
def test_sample_with_jax_noise_matches_jax(pair, temperature, top_k):
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    ids, mask = _docs(rng, 4)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jseq.sample(jm, params, ids, mask, 12, key,
                                  temperature=temperature, top_k=top_k))
    got = tseq.sample(tm, torch.tensor(ids), torch.tensor(mask), 12,
                      temperature=temperature, top_k=top_k,
                      noise=_jax_noise(key, 12, 4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_sample_pads_after_eos_and_is_seeded(pair):
    _, _, tm = pair
    rng = np.random.default_rng(3)
    ids, mask = _docs(rng, 6)
    args = (tm, torch.tensor(ids), torch.tensor(mask), LQ)
    a = tseq.sample(*args, generator=torch.Generator().manual_seed(5))
    b = tseq.sample(*args, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    for row in a.numpy():
        eos = np.flatnonzero(row == jseq.EOS)
        if len(eos):
            assert (row[eos[0] + 1:] == jseq.PAD).all()
    with pytest.raises(ValueError, match="generator or noise"):
        tseq.sample(*args)
    with pytest.raises(ValueError, match="noise"):
        tseq.sample(*args, noise=torch.zeros(3, 6, VOCAB))


def test_generate_queries_with_jax_noise_matches_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    ids, mask = _docs(rng, 3)
    key = jax.random.PRNGKey(11)
    want_t, want_s = jseq.generate_queries(jm, params, ids, mask, n_per_doc=2,
                                           max_len=LQ, rng=key,
                                           temperature=1.0, top_k=10)
    got_t, got_s = tseq.generate_queries(
        tm, torch.tensor(ids), torch.tensor(mask), n_per_doc=2, max_len=LQ,
        top_k=10, noise=_jax_noise(key, LQ, 6))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_qg_train_step_matches_jax():
    jm, params, tm = _pair(dropout=0.0, seed=3)
    rng = np.random.default_rng(5)
    ids, mask = _docs(rng, 4)
    q = rng.integers(2, VOCAB, size=(4, 8)).astype(np.int32)
    q[:, 6:] = 0
    q[:, 5] = jseq.EOS
    batch = {"doc_tokens": ids, "doc_mask": mask, "query_tokens": q}
    lr = 1e-3
    opt = optax.adamw(lr)
    step_j = jseq.make_qg_train_step(jm, opt)
    p_j, state_j = params, opt.init(params)
    step_t = tseq.make_qg_train_step(tm, tseq.qg_optimizer(tm, lr))
    for i in range(2):
        p_j, state_j, loss_j = step_j(p_j, state_j, batch,
                                      jax.random.PRNGKey(i))
        loss_t = step_t({k: torch.tensor(v) for k, v in batch.items()},
                        torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, p_j))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # optax.adamw(lr) decays at its default 1e-4, and so does the port
    assert tseq.qg_optimizer(tm, lr).hyper == {"all": (lr, 1e-4)}
