"""The port's slow PAWA head (``adaptor_efficient=False``,
models/pawa.py::FullPawaAdaptor) against the JAX package's, on bridged f32
weights: the adaptor's incremental step and its [d, d] transform, the
decode step's candidate logits, and ``Evaluator.retrieve`` on the plain and
packed stores.  The slow head has no U table: nothing builds one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdr_tpu.config import EvalConfig as JaxEvalConfig
from gdr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.models import pawa as tpawa
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import queries, small_cid_map, tiny_pair

ROWS, MAX_LEN, KARY, D = 6, 4, 4, 32
EV = dict(num_beams=10, num_return_sequences=16, max_output_length=5)


@pytest.fixture(scope="module")
def world():
    jm, params, tm = tiny_pair(seed=5, adaptor_efficient=False)
    assert isinstance(tm.pawa, tpawa.FullPawaAdaptor)
    return jm, params, tm


def _tokens(rng, pos: int) -> np.ndarray:
    """Decoder inputs at ``pos``: the start token, then digit tokens."""
    if pos == 0:
        return np.zeros(ROWS, np.int32)
    digits = rng.integers(0, KARY, ROWS)
    return (2 + (pos - 1) * KARY + digits).astype(np.int32)


def test_adaptor_step_and_transform_match_jax(world):
    jm, params, tm = world
    rng = np.random.default_rng(0)
    cache_j = jm.apply(params, ROWS, MAX_LEN,
                       method=lambda m, b, l: m.pawa.init_cache(b, l))
    cache_t = tm.pawa.init_cache(ROWS, MAX_LEN)
    for pos in range(MAX_LEN):
        tok = _tokens(rng, pos)
        a_j, cache_j = jm.apply(
            params, jnp.asarray(tok), cache_j, pos,
            method=lambda m, t, c, p: m.pawa.decode_step(t, c, p))
        with torch.no_grad():
            a_t, cache_t = tm.pawa.decode_step(torch.tensor(tok), cache_t, pos)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5)
        for k, v in cache_j.items():
            np.testing.assert_allclose(cache_t[k].numpy(), np.asarray(v),
                                       atol=1e-5, err_msg=k)
        s = rng.normal(size=(ROWS, D)).astype(np.float32)
        want = jm.apply(params, a_j[:, 0], jnp.asarray(s),
                        method=lambda m, a, x: m.pawa.transform(a, x))
        with torch.no_grad():
            got = tm.pawa.transform(a_t[:, 0], torch.tensor(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_transform_in_row_chunks_equals_one_chunk(world, monkeypatch):
    tm = world[2]
    g = torch.Generator().manual_seed(3)
    a, s = torch.randn(11, D, generator=g), torch.randn(11, D, generator=g)
    with torch.no_grad():
        whole = tm.pawa.transform(a, s)
        monkeypatch.setattr(tpawa, "_TRANSFORM_CHUNK_BYTES", 4 * D * D * 3)
        chunked = tm.pawa.transform(a, s)              # chunks of 3 rows
    torch.testing.assert_close(chunked, whole)


def test_candidate_logits_match_jax(world):
    jm, params, tm = world
    rng = np.random.default_rng(1)
    batch, beams = 2, ROWS // 2
    ids, mask = queries(rng, batch, 7, 128)
    enc_j = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                     method=jm.encode)
    cache_j = jm.apply(params, enc_j, MAX_LEN, beams, method=jm.init_cache)
    with torch.no_grad():
        cache_t = tm.init_cache(tm.encode(torch.tensor(ids),
                                          torch.tensor(mask)), MAX_LEN, beams)
    assert "cross_ucand" not in cache_t
    for pos in range(MAX_LEN):
        tok = _tokens(rng, pos)
        cand_j, hid_j, cache_j = jm.apply(
            params, jnp.asarray(tok), cache_j, jnp.asarray(mask), pos, beams,
            True, method=jm.decode_step_candidates)
        with torch.no_grad():
            cand_t, hid_t, cache_t = tm.decode_step_candidates(
                torch.tensor(tok), cache_t, torch.tensor(mask), pos, beams,
                return_hidden=True)
        np.testing.assert_allclose(cand_t.numpy(), np.asarray(cand_j),
                                   atol=1e-5, err_msg=f"pos {pos}")
        np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j),
                                   atol=1e-5, err_msg=f"pos {pos}")


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_retrieve_matches_jax(world, packed, monkeypatch):
    jm, params, tm = world
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, KARY)
    n = sum(len(v) for v in cid_to_docs.values())
    rng = np.random.default_rng(4)
    store = rng.normal(size=(n, D)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids, mask = queries(rng, 3, 8, 128)

    def no_table(*args):
        raise AssertionError("the slow PAWA head has no U table")
    monkeypatch.setattr(tm, "decode_tables", no_table)
    jev = JaxEvaluator(jm, trie, store, JaxEvalConfig(**EV), packed=packed)
    tev = Evaluator(tm, trie, store, EvalConfig(**EV), packed=packed)
    assert tev._u_table() is None
    res_j, rr_j = jev.retrieve(params, ids, mask)
    res_t, rr_t = tev.retrieve(ids, mask)
    valid = np.asarray(res_j.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(res_t.valid.numpy(), valid)
    np.testing.assert_array_equal(res_t.sequences.numpy()[valid],
                                  np.asarray(res_j.sequences)[valid])
    np.testing.assert_allclose(res_t.scores.numpy()[valid],
                               np.asarray(res_j.scores)[valid], atol=1e-5)
    dv = np.asarray(rr_j.doc_valid)
    assert dv.sum() > 0
    np.testing.assert_array_equal(rr_t.doc_valid.numpy(), dv)
    np.testing.assert_array_equal(rr_t.doc_ids.numpy()[dv],
                                  np.asarray(rr_j.doc_ids)[dv])
    np.testing.assert_allclose(rr_t.scores.numpy()[dv],
                               np.asarray(rr_j.scores)[dv], atol=1e-5)
