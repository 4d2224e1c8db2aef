"""The port's Evaluator (eval/evaluator.py) against the JAX package's, with
PAWA on, on the four store layouts (plain, packed, and each as int8; the
JAX side on its XLA path, f32): ``retrieve``, ``retrieve_many`` and
``evaluate``, whose result TSV must be byte-identical to the JAX one."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gdr_tpu.config import EvalConfig as JaxEvalConfig
from gdr_tpu.eval.evaluator import EvalData as JaxEvalData
from gdr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import queries, small_cid_map, tiny_pair

EV = dict(num_beams=10, num_return_sequences=16, max_output_length=5)


@pytest.fixture(scope="module")
def world():
    jm, params, tm = tiny_pair(seed=1, encoder_d_model=16)   # query_proj on
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    n = sum(len(v) for v in cid_to_docs.values())
    rng = np.random.default_rng(2)
    store = rng.normal(size=(n, 16)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids, mask = queries(rng, 4, 8, 128)
    cid_of_doc = {d: cid for cid, docs in cid_to_docs.items() for d in docs}
    gt = rng.integers(0, n, size=len(ids))
    data = dict(input_ids=ids, attn_mask=mask,
                gt_docs=[[str(d)] for d in gt],
                gt_cids=[[cid_of_doc[int(d)]] for d in gt])
    return jm, params, tm, trie, store, ids, mask, data


_JAX_EVALUATORS = {}
LAYOUTS = {"plain": dict(packed=False), "packed": dict(packed=True),
           "plain-int8": dict(packed=False, quantize=True),
           "packed-int8": dict(packed=True, quantize=True)}
TIMER_KEYS = {"retrieve_total_s", "retrieve_mean_ms", "decode_host_total_s",
              "decode_host_mean_ms"}


def _evaluators(world, layout):
    jm, params, tm, trie, store = world[:5]
    kw = LAYOUTS[layout]
    if layout not in _JAX_EVALUATORS:
        _JAX_EVALUATORS[layout] = JaxEvaluator(
            jm, trie, store, JaxEvalConfig(**EV), **kw)
    return (_JAX_EVALUATORS[layout],
            Evaluator(tm, trie, store, EvalConfig(**EV), **kw))


def _results_equal(res_t, rr_t, res_j, rr_j):
    valid = np.asarray(res_j.valid)
    np.testing.assert_array_equal(res_t.valid.numpy(), valid)
    np.testing.assert_array_equal(res_t.nodes.numpy()[valid],
                                  np.asarray(res_j.nodes)[valid])
    np.testing.assert_allclose(res_t.scores.numpy()[valid],
                               np.asarray(res_j.scores)[valid], atol=1e-5)
    dv = np.asarray(rr_j.doc_valid)
    assert dv.sum() > 0
    np.testing.assert_array_equal(rr_t.doc_valid.numpy(), dv)
    np.testing.assert_array_equal(rr_t.doc_ids.numpy()[dv],
                                  np.asarray(rr_j.doc_ids)[dv])
    np.testing.assert_allclose(rr_t.scores.numpy()[dv],
                               np.asarray(rr_j.scores)[dv], atol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_retrieve_matches_jax(world, layout):
    jm, params, tm, trie, store, ids, mask, _ = world
    jev, tev = _evaluators(world, layout)
    res_j, rr_j = jev.retrieve(params, ids, mask)
    res_t, rr_t = tev.retrieve(ids, mask)
    _results_equal(res_t, rr_t, res_j, rr_j)


@pytest.mark.parametrize("layout", ["plain-int8", "packed-int8"])
def test_int8_store_layout_matches_jax(world, layout):
    jev, tev = _evaluators(world, layout)
    assert tev.store.values.dtype == torch.int8
    np.testing.assert_array_equal(tev.store.values.numpy(),
                                  np.asarray(jev.store.values))
    np.testing.assert_array_equal(tev.store.scales.numpy(),
                                  np.asarray(jev.store.scales))
    if tev.packed:
        np.testing.assert_array_equal(tev._p_starts.numpy(),
                                      np.asarray(jev._p_starts))
        np.testing.assert_array_equal(tev._p_row_to_doc.numpy(),
                                      np.asarray(jev._p_row_to_doc))


@pytest.mark.parametrize("layout", ["plain-int8", "packed-int8"])
def test_retrieve_many_matches_jax(world, layout):
    jm, params, tm, trie, store, ids, mask, _ = world
    jev, tev = _evaluators(world, layout)
    ids_g, mask_g = ids.reshape(2, 2, -1), mask.reshape(2, 2, -1)
    res_j, rr_j = jev.retrieve_many(params, ids_g, mask_g)
    res_t, rr_t = tev.retrieve_many(ids_g, mask_g)
    assert res_t.nodes.shape == (2, 2, EV["num_beams"])
    assert rr_t.doc_ids.shape == (2, len(EvalConfig().score_rates), 2,
                                  EV["num_return_sequences"])
    _results_equal(res_t, rr_t, res_j, rr_j)


def _evaluate_equal(got, want):
    assert got and set(got) == set(want)
    assert TIMER_KEYS <= set(got)
    for k, v in got.items():
        if k not in TIMER_KEYS:
            assert v == pytest.approx(want[k], abs=1e-9), k


def test_evaluate_matches_jax(world):
    jm, params, tm, trie, store, ids, mask, data = world
    jev, tev = _evaluators(world, "packed")
    want = jev.evaluate(params, JaxEvalData(**data), batch_size=2)
    got = tev.evaluate(EvalData(**data), batch_size=2)
    _evaluate_equal(got, want)


@pytest.mark.parametrize("layout", ["plain-int8", "packed-int8"])
def test_evaluate_int8_matches_jax_with_result_tsv(world, layout, tmp_path):
    jm, params, tm, trie, store, ids, mask, data = world
    jev, tev = _evaluators(world, layout)
    want_tsv, got_tsv = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    want = jev.evaluate(params, JaxEvalData(**data), batch_size=3,
                        result_tsv=str(want_tsv))
    got = tev.evaluate(EvalData(**data), batch_size=3,
                       result_tsv=str(got_tsv))
    _evaluate_equal(got, want)
    assert Path(got_tsv).read_bytes() == Path(want_tsv).read_bytes()
    assert len(Path(got_tsv).read_text().splitlines()) == len(ids)


def test_u_table_built_once_per_weight_set(world):
    tm, trie, store = world[2], world[3], world[4]
    ev = Evaluator(tm, trie, store, EvalConfig(**EV), packed=True)
    first = ev._u_table()
    assert ev._u_table() is first
    with torch.no_grad():
        tm.pawa.u.mul_(1.0)                      # an in-place weight update
    assert ev._u_table() is not first


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_layouts_raise(world, kw):
    """Every layout is ported; an int8 store on a mesh needs the packed
    layout, as in the reference (checked before the mesh is read)."""
    tm, trie, store = world[2], world[3], world[4]
    with pytest.raises(ValueError, match="needs packed=True"):
        Evaluator(tm, trie, store, EvalConfig(**EV), quantize=True, **kw)
