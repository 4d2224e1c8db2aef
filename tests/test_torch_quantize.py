"""The port's int8 stores (ops/quantize.py) and the int8 packed scorer's
plain version (kernels/rerank.py::packed_scores_int8) against the JAX
package.  Quantization is compared bit for bit; the scorer against the
Pallas kernel in interpret mode at rtol 1e-5, atol 1e-4 (raw dots of up to
|127|·‖q‖₁ summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdr_tpu.ops import quantize as jq
from gdr_tpu.ops.pallas.rerank_kernel import packed_scores_pallas_int8
from gdr_tpu_torch import kernels
from gdr_tpu_torch.kernels import rerank as kr
from gdr_tpu_torch.ops import packed_store as tps
from gdr_tpu_torch.ops import quantize as tq
from gdr_tpu_torch.ops.trie import build_trie
from torch_port_helpers import small_cid_map

D = 32


def _store(seed: int, n: int = 80, d: int = D) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(
        1e-3, 10, size=(n, 1)).astype(np.float32)
    x[3] = 0.0                                      # an all-zero row
    x[5, :4] = np.abs(x[5]).max() * 1.5             # ties at the absmax
    return x


def _inputs(x: np.ndarray, dtype: str):
    """The same store as a JAX and a torch array of ``dtype``."""
    t = torch.tensor(x).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), getattr(jnp, dtype)), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_store_equals_jax(dtype):
    j, t = _inputs(_store(0), dtype)
    want, got = jq.quantize_store(j), tq.quantize_store(t)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert got.shape == want.shape and got.num_docs == want.num_docs
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_quantized_rows_equals_jax(dtype):
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    n = sum(len(v) for v in cid_to_docs.values())
    starts, _, row_to_doc, cap = tps.pack_layout(trie, align=32)
    assert (starts % 32 == 0).all()
    j, t = _inputs(_store(1, n=n), dtype)
    want = jq.pack_quantized_rows(j, jnp.asarray(row_to_doc))
    got = tq.pack_quantized_rows(t, torch.tensor(row_to_doc))
    assert got.shape == want.shape == (len(row_to_doc), D)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_dequantize_and_quantized_dot_match_jax():
    x = _store(2)
    jstore, tstore = jq.quantize_store(x), tq.quantize_store(torch.tensor(x))
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(x), size=(3, 4, 5)).astype(np.int32)
    q = rng.normal(size=(3, 4, D)).astype(np.float32)
    np.testing.assert_allclose(
        tq.dequantize_rows(tstore, torch.tensor(idx)).numpy(),
        np.asarray(jq.dequantize_rows(jstore, jnp.asarray(idx))), atol=1e-5)
    np.testing.assert_allclose(
        tq.quantized_dot(torch.tensor(q), tstore, torch.tensor(idx)).numpy(),
        np.asarray(jq.quantized_dot(jnp.asarray(q), jstore,
                                    jnp.asarray(idx))), atol=1e-5)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_packed_scores_int8_plain_matches_pallas(q_dtype):
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    n = sum(len(v) for v in cid_to_docs.values())
    starts, _, row_to_doc, cap = tps.pack_layout(trie, align=32)
    packed = tq.pack_quantized_rows(torch.tensor(_store(4, n=n)),
                                    torch.tensor(row_to_doc))
    rng = np.random.default_rng(5)
    r = 11                                          # not a multiple of 8
    beam_starts = rng.choice(starts, size=r).astype(np.int32)
    q = torch.tensor(rng.normal(size=(r, D)).astype(np.float32)).to(
        getattr(torch, q_dtype))
    want = packed_scores_pallas_int8(
        jnp.asarray(packed.values.numpy()), jnp.asarray(beam_starts),
        jnp.asarray(q.float().numpy(), getattr(jnp, q_dtype)), cap,
        interpret=True)
    kernels.reset_launch_counts()
    got = kr.packed_scores_int8(packed.values, torch.tensor(beam_starts), q,
                                cap)
    assert kernels.launch_counts()["packed_scores_int8"] == 0   # plain version on the cpu
    assert got.shape == (r, cap) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
