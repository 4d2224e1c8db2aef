"""The port's decoder-sublayer wrappers (kernels/decode.py) against the
JAX package's Pallas kernels in interpret mode and its XLA decoder block.

On the CPU the wrappers run their plain versions, which mirror the Pallas
kernels op for op: f32 at atol 1e-5, bf16 at atol 2e-2 (as
tests/test_decode_kernel.py holds the Pallas kernels against XLA).  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` and by tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gdr_tpu.models.t5 import Decoder as JaxDecoder
from gdr_tpu.ops.pallas import decode_kernel as jk
from gdr_tpu_torch import kernels
from gdr_tpu_torch.kernels import decode as kd

D, HEADS, DKV, DFF, S, LMAX, POS = 64, 4, 16, 128, 12, 4, 2
INNER = HEADS * DKV
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(rows: int, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    return dict(
        x=n(rows, D), scale=1 + n(D, std=0.1),
        wqkv=n(D, 3 * INNER, std=0.1), wo=n(INNER, D, std=0.1),
        bias_row=n(LMAX, HEADS, std=0.5),
        ck=n(LMAX, rows, INNER), cv=n(LMAX, rows, INNER),
        wcq=n(D, INNER, std=0.1), wco=n(INNER, D, std=0.1),
        wi=n(D, DFF, std=0.1), wo2=n(DFF, D, std=0.1),
        dtype=dtype)


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _cmp(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


def _cross_inputs(rows, beams, seed=1):
    rng = np.random.default_rng(seed)
    b = rows // beams
    ck = rng.normal(size=(b, HEADS, S, DKV)).astype(np.float32)
    cv = rng.normal(size=(b, HEADS, S, DKV)).astype(np.float32)
    keep = rng.integers(0, 2, (b, S)) | (np.arange(S) < 2)
    bias = (rng.normal(size=(b, HEADS, S)) * 0.5
            + np.where(keep[:, None, :], 0.0, -1e9)).astype(np.float32)
    return ck, cv, bias


CASES = [(dt, r) for dt in ("float32", "bfloat16") for r in (16, 24)]


@pytest.mark.parametrize("dtype,rows", CASES)
def test_self_attn_matches_pallas(dtype, rows):
    p = _inputs(rows, dtype)
    want, ck_w, cv_w = jk.self_attn_sublayer(
        _j(p["x"], dtype), jnp.asarray(POS, jnp.int32), _j(p["scale"], dtype),
        _j(p["wqkv"], dtype), _j(p["wo"], dtype), jnp.asarray(p["bias_row"]),
        _j(p["ck"], dtype), _j(p["cv"], dtype), heads=HEADS, d_kv=DKV,
        interpret=True)
    ck, cv = _t(p["ck"], dtype), _t(p["cv"], dtype)
    before = ck.clone()
    got, ck2, cv2 = kd.self_attn_sublayer(
        _t(p["x"], dtype), POS, _t(p["scale"], dtype),
        _t(p["wqkv"].T, dtype), _t(p["wo"].T, dtype),
        torch.tensor(p["bias_row"]), ck, cv, heads=HEADS, d_kv=DKV)
    assert ck2 is ck and cv2 is cv                    # written in place
    _cmp(got, want, dtype)
    _cmp(ck, ck_w, dtype)
    _cmp(cv, cv_w, dtype)
    others = [l for l in range(LMAX) if l != POS]
    assert torch.equal(ck[others], before[others])    # only row pos changes


@pytest.mark.parametrize("dtype,rows", CASES)
def test_cross_attn_matches_pallas(dtype, rows):
    beams = 8
    p = _inputs(rows, dtype)
    ck, cv, bias = _cross_inputs(rows, beams)
    want = jk.cross_attn_sublayer(
        _j(p["x"], dtype), _j(p["scale"], dtype), _j(p["wcq"], dtype),
        _j(p["wco"], dtype), _j(ck, dtype), _j(cv, dtype), jnp.asarray(bias),
        beams, heads=HEADS, d_kv=DKV, interpret=True)
    got = kd.cross_attn_sublayer(
        _t(p["x"], dtype), _t(p["scale"], dtype), _t(p["wcq"].T, dtype),
        _t(p["wco"].T, dtype), _t(ck, dtype), _t(cv, dtype),
        torch.tensor(bias), beams, heads=HEADS, d_kv=DKV)
    _cmp(got, want, dtype)


@pytest.mark.parametrize("dtype,rows", CASES)
def test_ffn_matches_pallas(dtype, rows):
    p = _inputs(rows, dtype)
    want = jk.ffn_sublayer(_j(p["x"], dtype), _j(p["scale"], dtype),
                           _j(p["wi"], dtype), _j(p["wo2"], dtype),
                           interpret=True)
    got = kd.ffn_sublayer(_t(p["x"], dtype), _t(p["scale"], dtype),
                          _t(p["wi"].T, dtype), _t(p["wo2"].T, dtype))
    _cmp(got, want, dtype)


# f32 shapes at which the CUDA kernels branch (rows, beams per query,
# encoder length S, heads, d_kv, FFN hidden): one beam per row over more
# keys than one 64-key pass (the streaming core at d_kv 64, and the tiled
# core's key tile); 5 beams a query (the tiled core) over a ragged S with
# pad keys; an FFN with a 4·d hidden at 13 rows (a ragged GEMM edge).  The
# Pallas FFN takes rows in blocks of 8, so it runs on 16 rows, 3 of them
# zero, and its first 13 are compared (the FFN is row by row).
F32_CASES = {
    "cross-1beam-S72-dkv64": ("cross", 16, 1, 72, 1, 64, DFF),
    "cross-5beams-S23-pads": ("cross", 15, 5, 23, HEADS, DKV, DFF),
    "ffn-hidden4x-13rows": ("ffn", 13, 1, S, HEADS, DKV, 4 * D),
}


@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_kernel_branches_match_pallas(case):
    kind, rows, beams, s_len, heads, d_kv, d_ff = F32_CASES[case]
    dt = "float32"
    inner = heads * d_kv
    rng = np.random.default_rng(7)

    def n(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    x, scale = n(rows, D), 1 + n(D, std=0.1)
    if kind == "ffn":
        wi, wo = n(D, d_ff, std=0.1), n(d_ff, D, std=0.05)
        pad = -rows % 8
        xp = np.concatenate([x, np.zeros((pad, D), np.float32)])
        want = jk.ffn_sublayer(_j(xp, dt), _j(scale, dt), _j(wi, dt),
                               _j(wo, dt), interpret=True)[:rows]
        got = kd.ffn_sublayer(_t(x, dt), _t(scale, dt), _t(wi.T, dt),
                              _t(wo.T, dt))
        _cmp(got, want, dt)
        return
    b = rows // beams
    wcq, wco = n(D, inner, std=0.1), n(inner, D, std=0.1)
    ck, cv = n(b, heads, s_len, d_kv), n(b, heads, s_len, d_kv)
    keep = rng.integers(0, 2, (b, s_len)) | (np.arange(s_len) < 2)
    bias = (n(b, heads, s_len, std=0.5)
            + np.where(keep[:, None, :], 0.0, -1e9)).astype(np.float32)
    want = jk.cross_attn_sublayer(
        _j(x, dt), _j(scale, dt), _j(wcq, dt), _j(wco, dt), _j(ck, dt),
        _j(cv, dt), jnp.asarray(bias), beams, heads=heads, d_kv=d_kv,
        interpret=True)
    got = kd.cross_attn_sublayer(
        _t(x, dt), _t(scale, dt), _t(wcq.T, dt), _t(wco.T, dt), _t(ck, dt),
        _t(cv, dt), torch.tensor(bias), beams, heads=heads, d_kv=d_kv)
    _cmp(got, want, dt)


def test_block_matches_xla_decode_step_at_15_rows():
    """The three sublayers chained as the port's DecoderBlock.decode_step
    against JAX's XLA DecoderBlock.decode_step at 3 queries × 5 beams (a row
    count no Pallas block could take)."""
    from gdr_tpu_torch.convert import params_from_flax
    from gdr_tpu_torch.models.t5 import Decoder

    torch.set_num_threads(2)
    b, k = 3, 5
    rng = np.random.default_rng(4)
    dec = JaxDecoder(num_layers=1, d_model=D, num_heads=HEADS, d_kv=DKV,
                     d_ff=DFF)
    enc = jnp.asarray(rng.normal(size=(b, S, D)), jnp.float32)
    params = dec.init(jax.random.PRNGKey(0), jnp.zeros((b, LMAX, D)), enc,
                      jnp.ones((b, LMAX), jnp.int32), jnp.ones((b, S), jnp.int32))
    mask = jnp.asarray(rng.integers(0, 2, (b, S)) | (np.arange(S) < 2),
                       jnp.int32)
    cache = dec.apply(params, b, LMAX, enc, k, method=dec.init_cache)
    filled = rng.normal(size=(LMAX, b * k, INNER)).astype(np.float32)
    cache["tm_self_k_0"] = jnp.asarray(filled)
    cache["tm_self_v_0"] = jnp.asarray(filled[::-1].copy())
    x = rng.normal(size=(b * k, 1, D)).astype(np.float32)

    def step(mdl, x, cache):
        return mdl.decode_step(x, cache, mask, jnp.asarray(POS), k)

    want, cache_w = dec.apply(params, jnp.asarray(x), cache, method=step)
    tdec = Decoder(1, D, HEADS, DKV, DFF)
    tdec.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tcache = {n: torch.tensor(np.asarray(v)) for n, v in cache.items()}
    with torch.no_grad():
        got, tcache = tdec.decode_step(torch.tensor(x), tcache,
                                       torch.tensor(np.asarray(mask)), POS, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tcache["tm_self_v_0"].numpy(),
                               np.asarray(cache_w["tm_self_v_0"]), atol=1e-5)


def test_cpu_calls_launch_nothing():
    kernels.reset_launch_counts()
    p = _inputs(8, "float32")
    x = _t(p["x"], "float32")
    kd.ffn_sublayer(x, _t(p["scale"], "float32"), _t(p["wi"].T, "float32"),
                    _t(p["wo2"].T, "float32"))
    kd.self_attn_sublayer(x, 1, _t(p["scale"], "float32"),
                          _t(p["wqkv"].T, "float32"), _t(p["wo"].T, "float32"),
                          torch.tensor(p["bias_row"]), _t(p["ck"], "float32"),
                          _t(p["cv"], "float32"), heads=HEADS, d_kv=DKV)
    assert {k: kernels.launch_counts()[k] for k in kd.WRAPPERS} == {
        "self_attn_sublayer": 0, "cross_attn_sublayer": 0, "ffn_sublayer": 0}



@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cross_attn_max_len_fits_shared_memory(dtype):
    # the CUDA cores' shared memory (csrc/decode_sublayers.cu): bf16 K and V
    # rows of d_kv + 8 with keys padded to 16, and the f32 bias row; f32
    # (the many-beam core, cross_tiled_smem): 32 q rows and a 64-key tile
    # each of K and V, rows of d_kv + 4 floats, and 32 beams' scores of
    # every key, keys padded to 64 and rows to + 4
    def smem(s, d_kv):
        if dtype == torch.bfloat16:
            sp = -(-s // 16) * 16
            return 2 * sp * (d_kv + 8) * 2 + sp * 4
        sp = -(-s // 64) * 64
        return (32 * (d_kv + 4) + 2 * 64 * (d_kv + 4) + 32 * (sp + 4)) * 4
    for d_kv in (16, 64, 128):
        n = kd.cross_attn_max_len(d_kv, dtype)
        assert smem(n, d_kv) <= 227 * 1024 < smem(n + 1, d_kv)
    # at least the 431 tokens the f32 core served before
    assert kd.cross_attn_max_len(64, dtype) == (
        784 if dtype == torch.bfloat16 else 1472)


def test_gemm_plain_is_the_sublayers_gemm_step():
    """gemm_plain composes the FFN sublayer's two steps exactly."""
    p = _inputs(8, "bfloat16")
    x, scale = _t(p["x"], "bfloat16"), _t(p["scale"], "bfloat16")
    wi, wo = _t(p["wi"].T, "bfloat16"), _t(p["wo2"].T, "bfloat16")
    h = kd.gemm(x, wi, "relu", scale=scale)
    assert torch.equal(kd.gemm(h, wo, "residual", resid=x),
                       kd.ffn_sublayer(x, scale, wi, wo))
    with pytest.raises(ValueError, match="resid for residual"):
        kd.gemm(x, wi, "residual", scale=scale)


@pytest.mark.parametrize("m, mt", [(1, 8), (8, 8), (9, 16), (31, 32),
                                   (32, 32), (33, 40), (64, 64), (65, 80),
                                   (100, 112), (128, 128)])
def test_gemm_plan_encodes_the_rows_kernel(m, mt):
    # the small-row kernel's plan: one tile of all M rows padded to 8 (to 16
    # past 64 rows), strips split over a cluster's blocks, one block a unit,
    # and no split-K workspace at any split count
    assert kd.rows_pad(m) == mt
    for bn, splits, stages in ((64, 1, 4), (48, 8, 2), (48, 3, 8)):
        plan = kd.rows_plan(m, 3072, bn, splits, stages)
        assert plan.kernel == kd.KERNEL_ROWS and plan.f32
        assert plan.rows == mt and plan.wg == mt // 8
        assert (plan.bn, plan.splits, plan.stages) == (bn, splits, stages)
        assert plan.units == plan.blocks == -(-3072 // bn) * splits
        assert plan.workspace(m, 3072) == 0
    # the bf16 tile kernel's split plans keep a partial a tile and split
    tile = kd.GemmPlan(1, 128, 4, 5, 0, 0)
    assert tile.kernel == kd.KERNEL_WGMMA and not tile.f32 and tile.rows == 64
    assert tile.workspace(m, 3072) == -(-m // 64) * 24 * 5 * 64 * 128
    # the warp-specialised ring's plans: tiles of 32·wg rows, each tile's
    # 32-float k-tiles cut into `splits` units dealt to `blocks` blocks; a
    # cut plan's workspace holds two partial tiles a block, an uncut one none
    ws = kd.ws_plan(m, 3072, 768, 128, 96, None, 264)
    assert ws.kernel == kd.KERNEL_WS and ws.f32
    assert ws.rows == 128 and ws.wg == 4
    assert (ws.bn, ws.splits, ws.blocks, ws.stages) == (96, 24, 264, 3)
    assert ws.units == -(-m // 128) * 32 * 24
    assert ws.workspace(m, 3072) == 2 * 264 * 128 * 96
    whole = kd.ws_plan(m, 768, 3072, 64, 192, 1, 132, stages=2)
    assert (whole.rows, whole.splits, whole.stages) == (64, 1, 2)
    assert whole.units == -(-m // 64) * 4 and whole.workspace(m, 768) == 0
