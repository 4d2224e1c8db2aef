"""``gdr_tpu_torch/ops/losses.py`` against ``gdr_tpu.ops.losses``: each
loss's value and its gradient with respect to every float input, on the
same seeded numpy inputs (``jax.value_and_grad`` against torch autograd).
Tolerance: f32, rtol 1e-5 and atol 1e-5 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdr_tpu.ops import losses as jl
from gdr_tpu_torch.ops import losses as tl

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, V, D, C = 4, 5, 11, 8, 3


def _labels(rng):
    labels = rng.integers(2, V, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 3:] = 0
    mask[2, 4:] = 0
    return labels, mask


def _check(jfn, tfn, floats, others=()):
    """Value and gradients of ``jfn(*floats, *others)`` (JAX) and
    ``tfn(...)`` (torch) agree."""
    val, grads = jax.value_and_grad(
        lambda *f: jfn(*f, *others), argnums=tuple(range(len(floats))))(
            *[jnp.asarray(f) for f in floats])
    ts = [torch.tensor(f, requires_grad=True) for f in floats]
    tv = tfn(*ts, *[torch.as_tensor(o) for o in others])
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(val), **TOL)
    for g, t in zip(grads, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_masked_cross_entropy():
    rng = np.random.default_rng(0)
    labels, mask = _labels(rng)
    _check(jl.masked_cross_entropy, tl.masked_cross_entropy,
           [rng.normal(size=(B, L, V)).astype(np.float32)], (labels, mask))


def test_rdrop_contrast():
    rng = np.random.default_rng(1)
    _, mask = _labels(rng)
    _check(jl.rdrop_contrast_loss, tl.rdrop_contrast_loss,
           [rng.normal(size=(B, L, D)).astype(np.float32)], (mask,))


@pytest.mark.parametrize("variant", ["KL", "L2", "L2 sliced"])
def test_rdrop_logit_variants(variant):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, L, V)).astype(np.float32)
    if variant == "KL":
        _check(jl.rdrop_kl_loss, tl.rdrop_kl_loss, [logits])
    else:
        cols = 4 * V if variant == "L2 sliced" else None
        _check(lambda x: jl.rdrop_l2_loss(x, cols),
               lambda x: tl.rdrop_l2_loss(x, cols), [logits])


def test_local_candidate_labels():
    kary = 4
    labels = np.array([[2, 7, 11, 1, 0], [5, 1, 0, 0, 0],
                       [3, 9, 13, 17, 1]], np.int32)
    want = np.asarray(jl.local_candidate_labels(jnp.asarray(labels), kary))
    got = tl.local_candidate_labels(torch.as_tensor(labels), kary).numpy()
    np.testing.assert_array_equal(got, want)


def test_doc_reweight_loss():
    rng = np.random.default_rng(3)
    labels, mask = _labels(rng)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    _check(lambda lg, q, d, lab, m: jl.doc_reweight_loss(lg, lab, m, q, d),
           lambda lg, q, d, lab, m: tl.doc_reweight_loss(lg, lab, m, q, d),
           [f(B, L, V), f(B, D), f(B, D)], (labels, mask))


def test_query_token_infonce():
    rng = np.random.default_rng(4)
    _, mask = _labels(rng)
    _check(jl.query_token_infonce, tl.query_token_infonce,
           [rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(B, L, D)).astype(np.float32)], (mask,))


def test_margin_ranking_loss():
    rng = np.random.default_rng(5)
    _check(lambda p, n: jl.margin_ranking_loss(p, n, 0.5),
           lambda p, n: tl.margin_ranking_loss(p, n, 0.5),
           [rng.random((B, 1, L)).astype(np.float32),
            rng.random((B, 2, L)).astype(np.float32)])


def test_embedding_distillation_loss():
    rng = np.random.default_rng(6)
    ids = rng.integers(2, 50, size=(B, 7)).astype(np.int32)
    ids[0, 3] = ids[1, 6] = ids[2, 0] = 1          # first EOS per row
    ids[2, 4] = 1                                    # a second one
    _check(lambda h, t, i: jl.embedding_distillation_loss(h, i, t),
           lambda h, t, i: tl.embedding_distillation_loss(h, i, t),
           [rng.normal(size=(B, 7, D)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32)], (ids,))


def test_weight_distillation_loss():
    rng = np.random.default_rng(7)
    _, mask = _labels(rng)
    _check(lambda v, t, m: jl.weight_distillation_loss(v, t, m),
           lambda v, t, m: tl.weight_distillation_loss(v, t, m),
           [rng.normal(size=(B, L, D)).astype(np.float32),
            rng.normal(size=(B, L, D)).astype(np.float32)],
           (mask.astype(np.float32),))


@pytest.mark.parametrize("squash,intra_rate", [("tanh", 1.0),
                                               ("sigmoid", 1.0),
                                               ("tanh", 0.5)])
def test_cluster_infonce(squash, intra_rate):
    rng = np.random.default_rng(8)
    cmask = rng.random((B, C)) < 0.7
    cmask[:, -1] = True                              # the positive
    _check(lambda q, p, c, m: jl.cluster_infonce(q, p, c, m, 0.05,
                                                 intra_rate, squash),
           lambda q, p, c, m: tl.cluster_infonce(q, p, c, m, 0.05,
                                                 intra_rate, squash),
           [rng.normal(size=(B, D)).astype(np.float32) * 0.3,
            rng.normal(size=(B, D)).astype(np.float32) * 0.3,
            rng.normal(size=(B, C, D)).astype(np.float32) * 0.3], (cmask,))


def test_denoising_losses_with_the_reference_noise():
    """Linear stand-ins for the encoder and the heads; the reference's own
    categorical key gives the Gumbel noise the port takes."""
    rng = np.random.default_rng(9)
    vocab, s = 13, 6
    ids = rng.integers(2, vocab, size=(B, s)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 4:] = 0
    keep = rng.random((B, s)) < 0.7
    key = jax.random.PRNGKey(4)
    gumbel = np.array(jax.random.gumbel(key, (B, s, vocab), jnp.float32))
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    emb, w_pred, w_disc = f(vocab, D), f(D, vocab), f(D, 2)

    def jfn(emb, w_pred, w_disc, ids, mask, keep):
        g, d = jl.denoising_losses(lambda x: jnp.tanh(emb[x]),
                                   lambda h: h @ w_pred, lambda h: h @ w_disc,
                                   ids, mask, keep, key)
        return g + 2.0 * d

    def tfn(emb, w_pred, w_disc, ids, mask, keep):
        g, d = tl.denoising_losses(lambda x: torch.tanh(emb[x.long()]),
                                   lambda h: h @ w_pred, lambda h: h @ w_disc,
                                   ids, mask, keep,
                                   gumbel=torch.as_tensor(gumbel))
        return g + 2.0 * d

    _check(jfn, tfn, [emb, w_pred, w_disc], (ids, mask, keep))
