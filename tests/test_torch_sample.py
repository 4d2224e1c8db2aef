"""The port's sampled CID decoding (ops/beam.py::sample_cids and the
evaluator's ``gen_method`` ``sample`` / ``top_k``) against the JAX
package's, on bridged f32 weights.

Torch and JAX draw different random numbers, so exact parity comes from
injected noise: ``jax.random.categorical(key, x)`` is ``argmax(x +
gumbel(key, x.shape))``, and the port draws ``argmax(dist + g)`` with ``g``
handed in, so the JAX package's own Gumbel noise (keys
``split(fold_in(PRNGKey(seed), batch_idx), max_len)``) makes the rollouts
equal.  Without injected noise the tests check what holds for any draw:
every rollout is a trie path, a seed and batch index fix the rollouts, and
a near-zero temperature gives beam search's top-1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gdr_tpu.config import EvalConfig as JaxEvalConfig
from gdr_tpu.eval.evaluator import EvalData as JaxEvalData
from gdr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdr_tpu.ops import beam as jbeam
from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator, sample_seed
from gdr_tpu_torch.ops import beam as tbeam
from gdr_tpu_torch.ops.codec import decode_token_batch
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import queries, small_cid_map, tiny_pair

SAMPLES, MAX_LEN, KARY = 6, 5, 4
EV = dict(num_beams=8, num_return_sequences=16, max_output_length=5)
TIMER_KEYS = {"retrieve_total_s", "retrieve_mean_ms", "decode_host_total_s",
              "decode_host_mean_ms"}


@pytest.fixture(scope="module")
def world():
    jm, params, tm = tiny_pair(seed=2, encoder_d_model=16,
                               concate_fusion=True)
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, KARY)
    n = sum(len(v) for v in cid_to_docs.values())
    rng = np.random.default_rng(11)
    store = rng.normal(size=(n, 16)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids, mask = queries(rng, 3, 8, 128)
    return jm, params, tm, trie, store, ids, mask, cid_to_docs


def jax_noise(rng, max_len: int, rows: int) -> torch.Tensor:
    """The Gumbel noise ``sample_cids`` of the JAX package draws from
    ``rng``: one key per position, noise of the candidate logits' shape."""
    keys = jax.random.split(rng, max_len)
    return torch.tensor(np.stack([
        np.asarray(jax.random.gumbel(k, (rows, KARY + 1), jnp.float32))
        for k in keys]))


def _tables(trie):
    return torch.tensor(trie.children), torch.tensor(trie.eos_allowed)


def test_jax_categorical_is_argmax_of_gumbel_noise():
    key = jax.random.PRNGKey(5)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 5)) * 3,
                    jnp.float32)
    want = np.asarray(jax.random.categorical(key, x))
    got = np.asarray(jnp.argmax(x + jax.random.gumbel(key, x.shape,
                                                      jnp.float32), axis=-1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pool", [False, True], ids=["no-pool", "pool"])
@pytest.mark.parametrize("top_k", [0, 2])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sample_cids_with_jax_noise_matches_jax(world, temperature, top_k,
                                                pool):
    jm, params, tm, trie, store, ids, mask, _ = world
    rng = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    want, q_j, _ = jbeam.sample_cids(
        jm, params, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(trie.children), jnp.asarray(trie.eos_allowed), SAMPLES,
        MAX_LEN, rng, temperature=temperature, top_k=top_k,
        length_penalty=0.8, accumulate_hidden=pool,
        u_table=jm.apply(params, MAX_LEN, method=jm.decode_tables))
    with torch.no_grad():
        got, q_t, _ = tbeam.sample_cids(
            tm, torch.tensor(ids), torch.tensor(mask), *_tables(trie),
            SAMPLES, MAX_LEN, temperature=temperature, top_k=top_k,
            length_penalty=0.8, accumulate_hidden=pool,
            noise=jax_noise(rng, MAX_LEN, len(ids) * SAMPLES))
    assert np.asarray(want.valid).all() and got.valid.all()
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(want.sequences))
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)
    np.testing.assert_allclose(got.cum_logprobs.numpy(),
                               np.asarray(want.cum_logprobs), atol=1e-5)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)
    if pool:
        for name in ("hid_avg", "hid_last"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-5, err_msg=name)
    else:
        assert got.hid_avg is None and got.hid_last is None


SAMPLED_EVALS = {
    "sample-plain": (dict(gen_method="sample", temperature=0.8), False),
    "top_k-packed-special-concate": (dict(
        gen_method="top_k", sample_top_k=2, sample_seed=4,
        use_query_embed_decoder_special=True, fusion_strategy="concate"),
        True),
}


def _sampled_evaluators(world, case):
    jm, params, tm, trie, store = world[:5]
    kw, packed = SAMPLED_EVALS[case]
    cfg = dict(EV, **kw)
    return (JaxEvaluator(jm, trie, store, JaxEvalConfig(**cfg), packed=packed),
            Evaluator(tm, trie, store, EvalConfig(**cfg), packed=packed))


def _batch_noise(ev, batch_idx: int, batch: int) -> torch.Tensor:
    rng = jax.random.fold_in(jax.random.PRNGKey(ev.cfg.sample_seed),
                             batch_idx)
    return jax_noise(rng, ev._max_len, batch * ev.cfg.num_beams)


@pytest.mark.parametrize("case", list(SAMPLED_EVALS))
def test_retrieve_sampled_matches_jax(world, case):
    jm, params, tm, trie, store, ids, mask, _ = world
    jev, tev = _sampled_evaluators(world, case)
    res_j, rr_j = jev.retrieve(params, ids, mask, batch_idx=2)
    res_t, rr_t = tev.retrieve(ids, mask, batch_idx=2,
                               noise=_batch_noise(tev, 2, len(ids)))
    np.testing.assert_array_equal(res_t.sequences.numpy(),
                                  np.asarray(res_j.sequences))
    np.testing.assert_allclose(res_t.scores.numpy(), np.asarray(res_j.scores),
                               atol=1e-5)
    dv = np.asarray(rr_j.doc_valid)
    assert dv.sum() > 0
    np.testing.assert_array_equal(rr_t.doc_valid.numpy(), dv)
    np.testing.assert_array_equal(rr_t.doc_ids.numpy()[dv],
                                  np.asarray(rr_j.doc_ids)[dv])
    np.testing.assert_allclose(rr_t.scores.numpy()[dv],
                               np.asarray(rr_j.scores)[dv], atol=1e-5)


def test_evaluate_sampled_matches_jax(world, monkeypatch):
    # each eval batch draws the noise of its own batch index
    # (start // batch_size), as the JAX package folds it into the key
    jm, params, tm, trie, store, ids, mask, cid_to_docs = world
    jev, tev = _sampled_evaluators(world, "sample-plain")
    cid_of = {d: c for c, docs in cid_to_docs.items() for d in docs}
    ids5 = np.concatenate([ids, ids[:2]])
    mask5 = np.concatenate([mask, mask[:2]])
    gt = np.random.default_rng(3).integers(0, len(store), size=len(ids5))
    data = dict(input_ids=ids5, attn_mask=mask5,
                gt_docs=[[str(d)] for d in gt],
                gt_cids=[[cid_of[int(d)]] for d in gt])
    seen = []
    retrieve = tev.retrieve

    def with_jax_noise(ids_b, mask_b, batch_idx=0):
        seen.append(batch_idx)
        return retrieve(ids_b, mask_b, batch_idx,
                        noise=_batch_noise(tev, batch_idx, len(ids_b)))
    monkeypatch.setattr(tev, "retrieve", with_jax_noise)
    want = jev.evaluate(params, JaxEvalData(**data), batch_size=2)
    got = tev.evaluate(EvalData(**data), batch_size=2)
    assert seen == [0, 1, 2]
    assert set(got) == set(want)
    for k, v in got.items():
        if k not in TIMER_KEYS:
            assert v == pytest.approx(want[k], abs=1e-9), k


def test_rollouts_are_valid_trie_paths(world):
    jm, params, tm, trie, store, ids, mask, cid_to_docs = world
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        res, _, _ = tbeam.sample_cids(
            tm, torch.tensor(ids), torch.tensor(mask), *_tables(trie), 20,
            MAX_LEN, gen, temperature=1.5, length_penalty=0.8)
    assert res.valid.all()
    cids = decode_token_batch(res.sequences.reshape(-1, MAX_LEN + 1).numpy(),
                              KARY)
    assert set(cids) <= set(cid_to_docs) and len(set(cids)) > 3
    assert (trie.cluster_of_node[res.nodes.numpy()] >= 0).all()
    s = res.scores.numpy()
    assert (np.diff(s, axis=1) <= 0).all()               # sorted per query


def test_seed_and_batch_index_fix_the_rollouts(world):
    jm, params, tm, trie, store, ids, mask, _ = world
    ev = Evaluator(tm, trie, store, EvalConfig(**EV, gen_method="sample"))
    a = ev.retrieve(ids, mask, batch_idx=0)[0].sequences
    b = ev.retrieve(ids, mask, batch_idx=0)[0].sequences
    c = ev.retrieve(ids, mask, batch_idx=1)[0].sequences
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert sample_seed(0, 0) != sample_seed(0, 1) != sample_seed(1, 1)


def test_near_zero_temperature_gives_beam_top1(world):
    jm, params, tm, trie, store, ids, mask, _ = world
    tables = _tables(trie)
    with torch.no_grad():
        samp, _, _ = tbeam.sample_cids(
            tm, torch.tensor(ids), torch.tensor(mask), *tables, 3, MAX_LEN,
            torch.Generator().manual_seed(1), temperature=1e-4)
        beam, _, _ = tbeam.generate_cids(
            tm, torch.tensor(ids), torch.tensor(mask), *tables, 1, MAX_LEN,
            progressive=False)
    for s in range(3):
        assert torch.equal(samp.sequences[:, s], beam.sequences[:, 0])


def test_sample_cids_refuses_missing_or_misshapen_noise(world):
    jm, params, tm, trie, store, ids, mask, _ = world
    args = (tm, torch.tensor(ids), torch.tensor(mask), *_tables(trie),
            SAMPLES, MAX_LEN)
    with pytest.raises(ValueError, match="generator or noise"):
        tbeam.sample_cids(*args)
    with pytest.raises(ValueError, match="noise"):
        tbeam.sample_cids(*args, noise=torch.zeros(MAX_LEN, 3, KARY + 1))
