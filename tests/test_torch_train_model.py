"""The teacher-forced paths of ``gdr_tpu_torch/models/gdr.py`` against
``gdr_tpu.models.gdr.GenerativeRetriever`` on bridged weights, with
``deterministic=True`` on the reference's side and eval mode on the
port's: ``forward`` over the full-vocab and the candidate-sliced head, the
slow PAWA head, the three query sources, an untied head with the query
projection, ``label_head_vectors`` and ``denoise`` (the reference's own
categorical key as Gumbel noise).  Tolerances: f32 atol 1e-5 (rtol 1e-5);
bf16 compute over f32 weights atol 2e-2 + rtol 1e-2, as elsewhere in the
port.  Dropout: its statistics, eval mode, and ``remat`` reproducing the
gradients of the same draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdr_tpu.models.gdr import shift_right as jax_shift_right
from gdr_tpu_torch.models.gdr import GenerativeRetriever, shift_right
from gdr_tpu_torch.models.t5 import Dropout, set_dropout_generator
from torch_port_helpers import tiny_pair

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=2e-2)
LABELS = np.array([[2, 7, 11, 1, 0], [3, 8, 1, 0, 0], [5, 6, 12, 16, 1]],
                  np.int32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    lm = (LABELS > 0).astype(np.int32)
    return ids, mask, lm


def _finite(a):
    return np.abs(a) < 1e8            # the positional mask's −1e9 entries


CASES = {
    "default": {},
    "slow PAWA": dict(adaptor_efficient=False),
    "decoder_avg": dict(query_source="decoder_avg"),
    "decoder_special, untied head, query_proj": dict(
        query_source="decoder_special", tie_decode_embedding=False,
        encoder_d_model=16),
}


@pytest.mark.parametrize(
    "case,sliced", [(c, s) for c in CASES for s in (False, True)
                    if not (s and c == "slow PAWA")],   # no sliced slow head
    ids=lambda v: v if isinstance(v, str) else ("sliced" if v else "full"))
def test_forward_matches_reference(case, sliced):
    jm, params, tm = tiny_pair(seed=1, **CASES[case])
    ids, mask, lm = _inputs()
    dec = np.array(jax_shift_right(jnp.asarray(LABELS)))
    want = jm.apply(params, ids, mask, dec, lm, deterministic=True,
                    sliced_head=sliced)
    got = tm(torch.as_tensor(ids), torch.as_tensor(mask),
             shift_right(torch.as_tensor(LABELS)), torch.as_tensor(lm),
             sliced_head=sliced)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].detach().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(_finite(g), _finite(w))
        np.testing.assert_allclose(g[_finite(w)], w[_finite(w)], **F32,
                                   err_msg=k)


def test_bf16_compute_over_f32_weights():
    """The reference's bf16 model (f32 parameters cast at use) against the
    port's bf16 copy of the same weights."""
    from gdr_tpu.config import ModelConfig as JaxModelConfig
    from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever

    jm, params, tm = tiny_pair(seed=2)
    jm16 = JaxRetriever(JaxModelConfig(**{
        f: getattr(tm.cfg, f) for f in JaxModelConfig.__dataclass_fields__}),
        dtype=jnp.bfloat16)
    tm16 = tm.to(torch.bfloat16)
    ids, mask, lm = _inputs(1)
    dec = np.array(jax_shift_right(jnp.asarray(LABELS)))
    want = jm16.apply(params, ids, mask, dec, lm, sliced_head=True)
    got = tm16(torch.as_tensor(ids), torch.as_tensor(mask),
               shift_right(torch.as_tensor(LABELS)), torch.as_tensor(lm),
               sliced_head=True)
    for k in want:
        w = np.asarray(want[k].astype(jnp.float32))
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g[_finite(w)], w[_finite(w)], **BF16,
                                   err_msg=k)


def test_label_head_vectors_and_decode_hidden():
    jm, params, tm = tiny_pair(seed=3, encoder_d_model=16)
    ids, mask, lm = _inputs(2)
    dec = np.array(jax_shift_right(jnp.asarray(LABELS)))
    want = jm.apply(params, dec, LABELS, method=jm.label_head_vectors)
    got = tm.label_head_vectors(torch.as_tensor(dec), torch.as_tensor(LABELS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    enc = jm.apply(params, ids, mask, method=jm.encode)
    want = jm.apply(params, enc, mask, dec, lm, method=jm.decode_hidden)
    got = tm.decode_hidden(torch.as_tensor(np.asarray(enc)),
                           torch.as_tensor(mask), torch.as_tensor(dec),
                           torch.as_tensor(lm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def test_denoise_with_the_reference_noise():
    jm, params, tm = tiny_pair(seed=4, denoising=True)
    ids, mask, _ = _inputs(3)
    keep = np.random.default_rng(5).random(ids.shape) < 0.8
    key = jax.random.PRNGKey(9)
    want = jm.apply(params, ids, mask, keep, key, method=jm.denoise)
    gumbel = np.array(jax.random.gumbel(key, (*ids.shape, 128), jnp.float32))
    got = tm.denoise(torch.as_tensor(ids), torch.as_tensor(mask),
                     torch.as_tensor(keep), gumbel=torch.as_tensor(gumbel))
    np.testing.assert_allclose([g.item() for g in got],
                               [float(w) for w in want], **F32)


def test_the_model_is_built_in_eval_mode():
    _, _, tm = tiny_pair(seed=0)
    fresh = GenerativeRetriever(tm.cfg)
    assert not fresh.training
    fresh.train()
    ids, mask, lm = _inputs()
    with pytest.raises(RuntimeError, match="generator"):
        fresh.encode(torch.as_tensor(ids), torch.as_tensor(mask))


def test_dropout_statistics():
    drop = Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.full((400_000,), 3.0)
    y = drop(x)
    kept = y != 0
    # keep probability 0.9 within 5 standard deviations, kept values / 0.9
    assert abs(kept.float().mean().item() - 0.9) < 5 * (0.09 / 4e5) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / 0.9))
    assert torch.equal(drop.eval()(x), x)


def test_remat_reproduces_the_gradients_of_its_dropout_draws():
    _, _, tm = tiny_pair(seed=6)
    ids, mask, lm = _inputs(4)
    grads = []
    for remat in (False, True):
        m = GenerativeRetriever(dataclasses.replace(tm.cfg, remat=remat,
                                                    dropout_rate=0.3))
        m.load_state_dict(tm.state_dict())
        m.train()
        set_dropout_generator(m, torch.Generator().manual_seed(7))
        out = m(torch.as_tensor(ids), torch.as_tensor(mask),
                shift_right(torch.as_tensor(LABELS)), torch.as_tensor(lm),
                sliced_head=True)
        (out["logits"][..., :4].sum() + out["query_embedding"].sum()
         ).backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-6, msg=n)
