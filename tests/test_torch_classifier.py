"""The port's encoder classifier (models/classifier.py) and the softmax
mode's step and ranking (train/modes.py) against gdr_tpu's, on bridged f32
weights of one tiny configuration: the bridge round trip, the class logits
and ``predict``, one training step (dropout 0; CE of the targets, AdamW at
optax's defaults, weight decay 1e-4 on every parameter), and the top
``min(100, C)`` ranking of clusters.  Tolerance 1e-5 in f32."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from gdr_tpu.config import ModelConfig as JaxModelConfig
from gdr_tpu.models.classifier import EncoderClassifier as JaxClassifier
from gdr_tpu_torch.config import ModelConfig
from gdr_tpu_torch.convert import params_from_flax, params_to_flax
from gdr_tpu_torch.eval.evaluator import EvalData
from gdr_tpu_torch.models.classifier import EncoderClassifier
from gdr_tpu_torch.train import modes as tmodes
from torch_port_helpers import TINY, queries

NUM_CLS = 13


def _pair(seed: int = 0, dropout: float = 0.1, num_cls: int = NUM_CLS):
    kw = {**TINY, "dropout_rate": dropout}
    jm = JaxClassifier(JaxModelConfig(**kw), num_cls=num_cls)
    ids = np.ones((2, 8), np.int32)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, ids, ids)
    tm = EncoderClassifier(ModelConfig(**kw), num_cls)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(2)
    return _pair()


def test_bridge_round_trip_is_exact(pair):
    _, params, tm = pair
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_flax(tm.state_dict())))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_logits_and_predict_match_jax(pair):
    jm, params, tm = pair
    ids, mask = queries(np.random.default_rng(0), 5, 8, 128)
    want = np.asarray(jm.apply(params, ids, mask))
    with torch.no_grad():
        got = tm(torch.tensor(ids), torch.tensor(mask))
        pred = tm.predict(torch.tensor(ids), torch.tensor(mask))
    assert got.dtype == torch.float32 and got.shape == (5, NUM_CLS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        pred.numpy(), np.asarray(jm.apply(params, ids, mask,
                                          method=jm.predict)))


def test_softmax_step_matches_jax():
    jm, params, tm = _pair(seed=1, dropout=0.0)
    lr = 1e-3
    opt_j = optax.adamw(lr)
    state_j = opt_j.init(params)

    def loss_fn(p, ids, msk, y, rng):          # train_eval_softmax's loss
        logits = jm.apply(p, ids, msk, deterministic=False,
                          rngs={"dropout": rng})
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, y[:, None], axis=-1).mean()

    opt_t = tmodes.AdamW(tm, {"all": (lr, tmodes.OPTAX_ADAMW_WD)})
    rng = np.random.default_rng(2)
    for i in range(2):
        ids, mask = queries(rng, 6, 8, 128)
        y = rng.integers(0, NUM_CLS, size=6).astype(np.int32)
        loss_j, grads = jax.value_and_grad(loss_fn)(
            params, ids, mask, y, jax.random.PRNGKey(i))
        upd, state_j = opt_j.update(grads, state_j, params)
        params = optax.apply_updates(params, upd)
        loss_t = tmodes.softmax_train_step(
            tm, opt_t, torch.tensor(ids), torch.tensor(mask), torch.tensor(y),
            torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("num_cls", [NUM_CLS, 120])
def test_rank_clusters_is_the_top_k_of_jax(num_cls):
    jm, params, tm = _pair(seed=2, num_cls=num_cls)
    rng = np.random.default_rng(3)
    ids, mask = queries(rng, 11, 8, 128)
    cids = [f"c{i}" for i in range(num_cls)]
    dev = EvalData(ids, mask, [[]] * 11, [[]] * 11)
    got = tmodes.rank_clusters(tm, dev, cids, batch_size=4)
    k = min(100, num_cls)
    _, top = jax.lax.top_k(jm.apply(params, ids, mask), k)
    top = np.asarray(top)
    assert len(got) == 11 and all(len(v) == k for v in got.values())
    for q in range(11):
        assert got[q] == [cids[int(c)] for c in top[q]]
