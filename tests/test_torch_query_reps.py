"""The port's decoder-side query reps against the JAX package's, on bridged
f32 weights: the decoder states pooled in the beam carry
(``generate_cids(accumulate_hidden=True)``), the teacher-forced oracle that
re-runs the decoder over the finished sequences
(``Evaluator._per_beam_decoder_query``), ``pool_query`` / ``fuse_queries``,
and ``Evaluator.retrieve`` with ``decoder_avg`` / ``decoder_special`` under
both fusion strategies, with and without the encoder rep, on the plain and
packed stores.  The trie mixes leaf depths 2 and 3, so some beams finish
early and full-depth beams need the extra pooling step.  Invalid slots tie
at −1e9 and the two top-k implementations break ties differently, so only
valid slots are compared."""

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdr_tpu.config import EvalConfig as JaxEvalConfig
from gdr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdr_tpu.ops import beam as jbeam
from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.ops import beam as tbeam
from gdr_tpu_torch.ops.codec import EOS_ID
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import queries, small_cid_map, tiny_pair

BEAMS, MAX_LEN = 12, 5          # depth 3 + EOS + the extra pooling step
EV = dict(num_beams=10, num_return_sequences=16, max_output_length=5)


@pytest.fixture(scope="module")
def world():
    # the doc space (16) differs from d_model (32): query_proj is on
    jm, params, tm = tiny_pair(seed=4, encoder_d_model=16,
                               concate_fusion=True)
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    n = sum(len(v) for v in cid_to_docs.values())
    rng = np.random.default_rng(6)
    store = rng.normal(size=(n, 16)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids, mask = queries(rng, 3, 8, 128)
    return jm, params, tm, trie, store, ids, mask


def _valid_equal(got, want):
    valid = np.asarray(want.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.nodes.numpy()[valid],
                                  np.asarray(want.nodes)[valid])
    np.testing.assert_array_equal(got.sequences.numpy()[valid],
                                  np.asarray(want.sequences)[valid])
    return valid


@pytest.mark.parametrize("progressive", [True, False],
                         ids=["progressive", "fixed-width"])
def test_pooled_hidden_matches_jax_and_the_rerun_oracle(world, progressive):
    jm, params, tm, trie, store, ids, mask = world
    ut = jm.apply(params, MAX_LEN, method=jm.decode_tables)
    want, _, enc_j = jbeam.generate_cids(
        jm, params, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(trie.children), jnp.asarray(trie.eos_allowed), BEAMS,
        MAX_LEN, 0.8, progressive=progressive, accumulate_hidden=True,
        u_table=ut)
    with torch.no_grad():
        got, _, _ = tbeam.generate_cids(
            tm, torch.tensor(ids), torch.tensor(mask),
            torch.tensor(trie.children), torch.tensor(trie.eos_allowed),
            BEAMS, MAX_LEN, 0.8, progressive=progressive,
            accumulate_hidden=True)
    valid = _valid_equal(got, want)
    seqs = got.sequences.numpy()[valid]
    # early finishers (EOS after 2 digits) and full-depth beams, whose EOS
    # input enters the pool only at the extra step
    assert (seqs[:, 3] == EOS_ID).any() and (seqs[:, 4] == EOS_ID).any()
    for name in ("hid_avg", "hid_last"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   np.asarray(getattr(want, name))[valid],
                                   atol=1e-5, err_msg=name)

    # the reference's way: re-run the port's sequences through the JAX
    # decoder, teacher-forced, and pool.  Looser: the whole-sequence
    # decoder sums attention in another order than the incremental one
    # (the reference package holds the same pair at 2e-4, test_beam.py)
    seq_j = SimpleNamespace(sequences=jnp.asarray(got.sequences.numpy()))
    for special in (False, True):
        jev = JaxEvaluator(jm, trie, store, JaxEvalConfig(
            **EV, use_query_embed_decoder_avg=not special,
            use_query_embed_decoder_special=special))
        oracle = np.asarray(jev._per_beam_decoder_query(
            params, seq_j, enc_j, jnp.asarray(mask)))
        pooled = got.hid_last if special else got.hid_avg
        with torch.no_grad():
            q = tm.project_query(pooled).numpy()
        np.testing.assert_allclose(q[valid], oracle[valid], rtol=2e-4,
                                   atol=2e-4, err_msg=f"special={special}")


@pytest.mark.parametrize("source", ["encoder", "decoder_avg",
                                    "decoder_special"])
def test_pool_query_and_fuse_queries_match_jax(world, source):
    jm, params, tm = world[:3]
    rng = np.random.default_rng(8)
    enc = rng.normal(size=(3, 7, 32)).astype(np.float32)
    hidden = rng.normal(size=(3, 5, 32)).astype(np.float32)
    dmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                     np.int32)
    jm_s = jm.clone(cfg=dataclasses.replace(jm.cfg, query_source=source))
    want = np.asarray(jm_s.apply(params, jnp.asarray(enc), jnp.asarray(hidden),
                                 jnp.asarray(dmask), method=jm_s.pool_query))
    tm_s = copy.copy(tm)
    tm_s.cfg = dataclasses.replace(tm.cfg, query_source=source)
    with torch.no_grad():
        got = tm_s.pool_query(torch.tensor(enc), torch.tensor(hidden),
                              torch.tensor(dmask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    q_dec = rng.normal(size=(3, 4, 16)).astype(np.float32)
    q_enc = rng.normal(size=(3, 1, 16)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(q_dec), jnp.asarray(q_enc),
                               method=jm.fuse_queries))
    with torch.no_grad():
        got = tm.fuse_queries(torch.tensor(q_dec), torch.tensor(q_enc)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


_JAX_EVALUATORS = {}


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("encoder", [True, False], ids=["enc", "no-enc"])
@pytest.mark.parametrize("fusion", ["average", "concate"])
@pytest.mark.parametrize("rep", ["decoder_avg", "decoder_special"])
def test_retrieve_with_decoder_reps_matches_jax(world, rep, fusion, encoder,
                                                packed):
    jm, params, tm, trie, store, ids, mask = world
    kw = dict(EV, use_query_embed_encoder=encoder, fusion_strategy=fusion,
              use_query_embed_decoder_avg=rep == "decoder_avg",
              use_query_embed_decoder_special=rep == "decoder_special")
    key = (rep, fusion, encoder, packed)
    if key not in _JAX_EVALUATORS:
        _JAX_EVALUATORS[key] = JaxEvaluator(jm, trie, store,
                                            JaxEvalConfig(**kw), packed=packed)
    jev = _JAX_EVALUATORS[key]
    tev = Evaluator(tm, trie, store, EvalConfig(**kw), packed=packed)
    assert tev._max_len == jev._max_len == int(trie.depth.max()) + 2
    res_j, rr_j = jev.retrieve(params, ids, mask)
    res_t, rr_t = tev.retrieve(ids, mask)
    _valid_equal(res_t, res_j)
    assert res_t.hid_avg is None and res_t.hid_last is None
    dv = np.asarray(rr_j.doc_valid)
    assert dv.sum() > 0
    np.testing.assert_array_equal(rr_t.doc_valid.numpy(), dv)
    np.testing.assert_array_equal(rr_t.doc_ids.numpy()[dv],
                                  np.asarray(rr_j.doc_ids)[dv])
    np.testing.assert_allclose(rr_t.scores.numpy()[dv],
                               np.asarray(rr_j.scores)[dv], atol=1e-5)


def test_retrieve_many_with_decoder_reps_matches_retrieve(world):
    jm, params, tm, trie, store, ids, mask = world
    ev = Evaluator(tm, trie, store, EvalConfig(
        **EV, use_query_embed_decoder_avg=True), packed=True)
    ids_g, mask_g = np.stack([ids, ids[::-1]]), np.stack([mask, mask[::-1]])
    res, rr = ev.retrieve_many(ids_g, mask_g)
    assert res.hid_avg is None and res.nodes.shape == (2, 3, EV["num_beams"])
    for g in range(2):
        res_1, rr_1 = ev.retrieve(ids_g[g], mask_g[g])
        torch.testing.assert_close(rr.doc_ids[g], rr_1.doc_ids, rtol=0, atol=0)
        torch.testing.assert_close(rr.scores[g], rr_1.scores, rtol=0, atol=0)


@pytest.mark.parametrize("want_dec,steps", [(False, 4), (True, 5)],
                         ids=["default", "decoder_avg"])
def test_pooling_adds_one_step_and_nothing_else(world, want_dec, steps,
                                                monkeypatch):
    # the default path keeps its max_len and step count and pools nothing;
    # pooled reps run the one extra step that full-depth beams need
    jm, params, tm, trie, store, ids, mask = world
    ev = Evaluator(tm, trie, store, EvalConfig(
        **EV, use_query_embed_decoder_avg=want_dec))
    calls = []
    step = tm.decode_step_candidates

    def counted(token, cache, enc_mask, pos, num_beams=1,
                return_hidden=False):
        calls.append(return_hidden)
        return step(token, cache, enc_mask, pos, num_beams, return_hidden)
    monkeypatch.setattr(tm, "decode_step_candidates", counted)
    ev.retrieve(ids, mask)
    assert ev._max_len == steps
    assert calls == [want_dec] * steps


def test_concate_fusion_needs_the_fusion_layer(world):
    jm, params, tm, trie, store = world[:5]
    tm_plain = copy.copy(tm)
    tm_plain.cfg = dataclasses.replace(tm.cfg, concate_fusion=False)
    with pytest.raises(ValueError, match="concate_fusion"):
        Evaluator(tm_plain, trie, store, EvalConfig(
            **EV, use_query_embed_decoder_avg=True, fusion_strategy="concate"))
