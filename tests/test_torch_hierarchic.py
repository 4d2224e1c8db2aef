"""The port's hierarchic decoding (models/hierarchic.py, the full-vocabulary
step of ops/beam.py and train/modes.py's hierarchic mode) against
gdr_tpu's, on bridged f32 weights of one tiny configuration: the bridge
round trip, the positional routing of the teacher-forced logits, the decode
step (equal to the training row at its position, and to gdr_tpu's), the
constrained search on valid beams (beam 1 its greedy decode), one training
step (AdamW at optax's defaults, weight decay 1e-4 on every parameter), and
``beam_search(candidates_mode=False)`` on a step function of fixed
full-vocabulary logits.  Tolerance 1e-5 in f32 (logits 1e-4 atol, their
scale is ~10)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.models import hierarchic as jh
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import shift_right as jax_shift_right
from gdr_tpu.ops import beam as jbeam
from gdr_tpu.ops.losses import masked_cross_entropy as jax_ce
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import hierarchic_from_flax, hierarchic_to_flax
from gdr_tpu_torch.models import hierarchic as th
from gdr_tpu_torch.models.gdr import shift_right
from gdr_tpu_torch.ops import beam as tbeam
from gdr_tpu_torch.ops.codec import digits_to_label
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.train import modes as tmodes
from torch_port_helpers import TINY, queries, small_cid_map

DEPTH, KARY, L = 3, TINY["kary"], TINY["max_output_length"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed: int = 0):
    kw = {**TINY, "dropout_rate": 0.0}
    jm = JaxRetriever(JaxModelConfig(**kw))
    base, dec = jh.init_hierarchic(jm, jax.random.PRNGKey(seed), DEPTH,
                                   input_len=8)
    h = th.Hierarchic(ModelConfig(**kw), DEPTH)
    h.load_state_dict(hierarchic_from_flax(_np({"base": base, "dec": dec})))
    return jm, base, dec, h


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    return _pair()


def _labels(rng, b):
    labels = np.zeros((b, L), np.int32)
    for j in range(b):
        path = list(rng.integers(0, KARY, size=DEPTH))
        labels[j], _ = digits_to_label(path, KARY, L)
    return labels, (labels != 0).astype(np.int32)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_bridge_round_trip_is_exact(pair):
    _, base, dec, h = pair
    want = dict(jax.tree_util.tree_leaves_with_path(
        _np({"base": base, "dec": dec})))
    got = dict(jax.tree_util.tree_leaves_with_path(hierarchic_to_flax(h)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_logits_route_each_position_to_its_depth_and_match_jax(pair):
    jm, base, dec, h = pair
    rng = np.random.default_rng(0)
    ids, mask = queries(rng, 3, 8, 128)
    labels, lmask = _labels(rng, 3)
    want = np.asarray(jh.hierarchic_logits(jm, base, dec, ids, mask, labels,
                                           lmask))
    with torch.no_grad():
        got = th.hierarchic_logits(h, *_t(ids, mask, labels, lmask))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
        enc = h.base.encode(*_t(ids, mask))
        dec_in = shift_right(torch.tensor(labels))
        for p in range(L):
            one = h.stack_logits(min(p, DEPTH - 1), enc, torch.tensor(mask),
                                 dec_in, torch.tensor(lmask))
            assert torch.equal(got[:, p], one[:, p])


def test_decode_step_equals_the_training_row_and_jax(pair):
    jm, base, dec, h = pair
    rng = np.random.default_rng(1)
    ids, mask = queries(rng, 3, 8, 128)
    labels, _ = _labels(rng, 3)
    full = np.ones_like(labels)
    prefix = np.asarray(jax_shift_right(jnp.asarray(labels)))
    enc_j = jm.apply({"params": {**base["params"],
                                 "decoder": jh._index(dec, 0)}},
                     ids, mask, method=jm.encode)
    with torch.no_grad():
        train = th.hierarchic_logits(h, *_t(ids, mask, labels, full))
        enc = h.base.encode(*_t(ids, mask))
        for pos in range(L):
            got = th.hierarchic_decode_step(h, torch.tensor(prefix), enc,
                                            torch.tensor(mask), pos)
            want = jh.hierarchic_decode_step(jm, base, dec, prefix, enc_j,
                                             mask, jnp.int32(pos), DEPTH)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-5)
            np.testing.assert_allclose(got.numpy(), train[:, pos].numpy(),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("beams", [1, 6])
def test_generate_cids_match_jax_on_valid_beams(pair, beams):
    jm, base, dec, h = pair
    trie = build_trie(small_cid_map(), KARY)
    rng = np.random.default_rng(2)
    ids, mask = queries(rng, 3, 8, 128)
    res_j, q_j = jh.hierarchic_generate_cids(
        jm, base, dec, ids, mask, jnp.asarray(trie.children),
        jnp.asarray(trie.eos_allowed), num_beams=beams, max_len=L,
        length_penalty=0.8)
    res_t, q_t = th.hierarchic_generate_cids(
        h, *_t(ids, mask, trie.children, trie.eos_allowed), num_beams=beams,
        max_len=L, length_penalty=0.8)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)
    valid = np.asarray(res_j.valid)
    np.testing.assert_array_equal(res_t.valid.numpy(), valid)
    assert valid.any()
    for name in ("nodes", "sequences"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy()[valid],
                                      np.asarray(getattr(res_j, name))[valid])
    np.testing.assert_allclose(res_t.scores.numpy()[valid],
                               np.asarray(res_j.scores)[valid], atol=1e-5,
                               rtol=1e-5)


def test_beam_one_is_greedy(pair):
    """num_beams=1: at each step the best trie-allowed digit or EOS of
    the step's stack, until EOS."""
    _, _, _, h = pair
    trie = build_trie(small_cid_map(), KARY)
    rng = np.random.default_rng(3)
    ids, mask = queries(rng, 2, 8, 128)
    res, _ = th.hierarchic_generate_cids(
        h, *_t(ids, mask, trie.children, trie.eos_allowed), num_beams=1,
        max_len=L)
    with torch.no_grad():
        enc = h.base.encode(*_t(ids, mask))
        for b in range(2):
            prefix = torch.zeros((1, L), dtype=torch.long)
            node, tok = 0, 0
            for pos in range(L):
                prefix[0, pos] = tok
                lg = th.hierarchic_decode_step(h, prefix, enc[b:b + 1],
                                               torch.tensor(mask[b:b + 1]),
                                               pos)[0]
                cols = [pos * KARY + 2 + d for d in range(KARY)] + [1]
                ok = list(trie.children[node] >= 0) + [trie.eos_allowed[node]]
                opt = max((i for i in range(KARY + 1) if ok[i]),
                          key=lambda i: lg[cols[i]])
                if opt == KARY:
                    break
                node, tok = int(trie.children[node, opt]), cols[opt]
            assert int(res.nodes[b, 0]) == node


def test_full_vocab_beam_step_matches_jax():
    """beam_search(candidates_mode=False) reads each step's digit columns
    ``pos·kary + 2 + d`` and EOS from the full-vocabulary log-softmax."""
    trie = build_trie(small_cid_map(), KARY)
    batch, beams, vocab = 2, 5, KARY * L + 2
    rng = np.random.default_rng(4)
    table = (rng.normal(size=(L, batch * beams, vocab)) * 3).astype(np.float32)
    tab_j = jnp.asarray(table)

    def step_j(cur, cache, pos, width):
        return tab_j[pos], cache

    def step_t(cur, cache, pos, width):
        return torch.tensor(table[pos]), cache

    want = jbeam.beam_search(step_j, {}, batch, beams, KARY, L,
                             jnp.asarray(trie.children),
                             jnp.asarray(trie.eos_allowed),
                             length_penalty=0.8, candidates_mode=False)
    got = tbeam.beam_search(step_t, {}, batch, beams, KARY, L,
                            *_t(trie.children, trie.eos_allowed),
                            length_penalty=0.8, candidates_mode=False)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.nodes.numpy()[valid],
                                  np.asarray(want.nodes)[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], rtol=1e-6)


def test_train_step_matches_jax():
    jm, base, dec, h = _pair(seed=1)
    lr = 1e-3
    params = {"base": base, "dec": dec}
    opt_j = optax.adamw(lr)
    state_j = opt_j.init(params)

    def loss_fn(p, b):                   # train_eval_hierarchic's loss
        logits = jh.hierarchic_logits(jm, p["base"], p["dec"],
                                      b["input_ids"], b["attn_mask"],
                                      b["labels"], b["label_mask"])
        return jax_ce(logits, b["labels"], b["label_mask"])

    opt_t = tmodes.AdamW(h, {"all": (lr, tmodes.OPTAX_ADAMW_WD)})
    rng = np.random.default_rng(5)
    for _ in range(2):
        ids, mask = queries(rng, 4, 8, 128)
        labels, lmask = _labels(rng, 4)
        b = {"input_ids": ids, "attn_mask": mask, "labels": labels,
             "label_mask": lmask}
        loss_j, grads = jax.value_and_grad(loss_fn)(params, b)
        upd, state_j = opt_j.update(grads, state_j, params)
        params = optax.apply_updates(params, upd)
        loss_t = tmodes.hierarchic_train_step(
            h, opt_t, {k: torch.tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = hierarchic_from_flax(_np(params))
    for name, p in h.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
