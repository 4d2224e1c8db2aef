"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so without a CUDA device every test here
skips.  The file imports neither JAX nor the reference package, so it runs
on a GPU machine that has neither (``--noconftest`` skips the JAX set-up of
tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Shapes are small and deliberately ragged (row counts that are not
multiples of any tile, one and 31 beams per query, scorer widths of 40 and
48 that are not multiples of 32 chunks, 37 beams, cap 5); the decoder's
GEMM and attention cores are also held at the main path's widths (K up to
3,080, N up to 3,072, d_kv 64, L 16, encoder lengths up to the
shared-memory limit), the sublayers at the shapes the other retrieve
options give them (3,200 rows at position 0; position 4 of a 5-position
cache), and the self-attention sublayer at caches longer than its 16
register positions (L 17, 24, 40 as query generation samples, and 64; 320
and 3,200 rows; every position).  The scorers are held to their plain
versions with a distinct query row per beam, and the retrieve options (decoder-side query reps,
sampling with shared noise, the slow PAWA head) to the CPU's plain route
on a small f32 model.  The GEMM runs each dtype's cost-model plans and
forced ones: in bf16 split-K with split counts that divide no k-tile
count and fewer persistent blocks than work units; split results are
bit-equal on every call and graph replay.  The warp-specialised f32 ring
runs both its tiles at 1 to 3,200 rows, cut across blocks at every k-tile,
in 2 to 13 units, or whole, on one to 264 blocks, rings of 1 to 7 stages;
above 128 rows (129 / 320 / 992 / 997 / 3,200) the four t5-base products
under the chooser's plan and forced cut plans, bit-equal on every call and
replay; the chooser takes it for every product above 128 rows, at the
least time of the model that the sweep fits (gdr_gemm_ws_time) over its
own plan list (gdr_gemm_ws_plans), within 10% of the fastest of those
plans on the clock, and it refuses what it does not serve.  The f32
small-row kernel runs at 1-128 rows (every row tiling) of the four t5-base
products under the chooser's plan and forced ones (a ring that wraps,
clusters of 1, 3 and 8 blocks), bit-equal on every call and replay
without workspace or counters; the chooser takes it at 1 / 31 / 32 / 100
rows and the warp-specialised ring at 992 / 3,200, at the least time of
the model that the sweep fits (gdr_gemm_rows_time); it refuses plans past
128 rows; its name passes the decoder roofline's filter.  The f32 cross-attention cores run at one
beam a query (streamed) and 100 (staged), over 1 to the shared-memory
limit of keys.  Tolerances: f32
atol 1e-4 + rtol 1e-5 (f32 sums in another order); bf16 atol 2e-2 + rtol
1e-2 (one bf16 ulp of an output whose f32 value sits near a rounding
edge).  The scorers' outputs are f32 sums, held at the f32 tolerance.

The index path has no kernel of its own; its plain PyTorch (Lloyd and
minibatch k-means from injected draws, the doc tower) is held to the CPU's
run of the same inputs, and the hierarchical recursion on the card to its
invariants.
"""

import pytest
import torch

from chip_smoke import SMALL_MODES
from gdr_tpu_torch import kernels
from gdr_tpu_torch.kernels import build
from gdr_tpu_torch.kernels import decode as kd
from gdr_tpu_torch.kernels import rerank as kr

D, HEADS, DKV, DFF, S, LMAX = 64, 4, 16, 128, 12, 4
INNER = HEADS * DKV
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)
    return rn


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# (d_model, heads, d_kv, d_ff, encoder length, its padded tail, weight std)
SMALL_WIDTHS = (D, HEADS, DKV, DFF, S, 3, 0.1)
BASE_WIDTHS = (768, 12, 64, 3072, 40, 8, 0.02)       # t5-base
QG_WIDTHS = (768, 12, 64, 3072, 64, 8, 0.02)         # t5-base over a 64-token doc
# widths, batch, beams, position, cache length: small ragged row counts;
# then t5-base at 3,200 rows (32 queries x 100) at the shapes the retrieve
# options give: sampling starts at full width at position 0, where the self
# core reads no cache row, and pooled decoder reps take a fifth step,
# position 4 of a 5-position cache; and query generation's shape, 320 rows
# each its own query over a 64-token doc, at the last of 40 positions
SUBLAYER_CASES = {
    **{f"{b}x{k}-pos{p}": (SMALL_WIDTHS, b, k, p, LMAX)
       for b, k in ((3, 1), (3, 5), (2, 31)) for p in (0, LMAX - 1)},
    **{f"t5base-3200-pos{p}-L{l}": (BASE_WIDTHS, 32, 100, p, l)
       for p, l in ((0, 4), (0, 5), (4, 5))},
    "t5base-qg-320x1-pos39-L40": (QG_WIDTHS, 320, 1, 39, 40),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SUBLAYER_CASES))
def test_decoder_sublayers_match_plain(dev, dtype, case):
    (d, heads, d_kv, d_ff, s_, pad, std), batch, beams, pos, lmax = \
        SUBLAYER_CASES[case]
    inner = heads * d_kv
    rn = _rand(dev, 7 * beams + pos + 100 * lmax)
    r = batch * beams
    x = rn(r, d, dtype=dtype)
    scale = (1 + rn(d, std=0.1)).to(dtype)
    kernels.reset_launch_counts()

    wqkv = rn(3 * inner, d, std=std, dtype=dtype)
    wo = rn(d, inner, std=std, dtype=dtype)
    bias_row = rn(lmax, heads, std=0.5)
    ck, cv = rn(lmax, r, inner, dtype=dtype), rn(lmax, r, inner, dtype=dtype)
    ck_p, cv_p, before = ck.clone(), cv.clone(), ck.clone()
    got, ck_o, cv_o = kd.self_attn_sublayer(x, pos, scale, wqkv, wo, bias_row,
                                            ck, cv, heads=heads, d_kv=d_kv)
    want, _, _ = kd.self_attn_sublayer_plain(x, pos, scale, wqkv, wo,
                                             bias_row, ck_p, cv_p,
                                             heads=heads, d_kv=d_kv)
    assert ck_o is ck and cv_o is cv                  # written in place
    _close(got, want, dtype)
    _close(ck, ck_p, dtype)
    _close(cv, cv_p, dtype)
    others = [l for l in range(lmax) if l != pos]
    assert torch.equal(ck[others], before[others])    # only row pos changes

    wcq = rn(inner, d, std=std, dtype=dtype)
    wco = rn(d, inner, std=std, dtype=dtype)
    cross_k = rn(batch, heads, s_, d_kv, dtype=dtype)
    cross_v = rn(batch, heads, s_, d_kv, dtype=dtype)
    cbias = rn(batch, heads, s_, std=0.5)
    cbias[:, :, s_ - pad:] += -1e9                    # padded key positions
    got = kd.cross_attn_sublayer(x, scale, wcq, wco, cross_k, cross_v, cbias,
                                 beams, heads=heads, d_kv=d_kv)
    want = kd.cross_attn_sublayer_plain(x, scale, wcq, wco, cross_k, cross_v,
                                        cbias, beams, heads=heads, d_kv=d_kv)
    _close(got, want, dtype)

    wi = rn(d_ff, d, std=std, dtype=dtype)
    wo2 = rn(d, d_ff, std=std, dtype=dtype)
    _close(kd.ffn_sublayer(x, scale, wi, wo2),
           kd.ffn_sublayer_plain(x, scale, wi, wo2), dtype)
    torch.cuda.synchronize()
    assert {k: kernels.launch_counts()[k] for k in kd.WRAPPERS} == {
        "self_attn_sublayer": 1, "cross_attn_sublayer": 1, "ffn_sublayer": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 31, 65, 300])
@pytest.mark.parametrize("n,k", [(64, 64), (192, 64), (2304, 64),
                                 (64, 3072), (192, 3072), (2304, 3072),
                                 (64, 40), (192, 200)])
def test_gemm_matches_plain(dev, dtype, m, n, k):
    # ragged M and K edges arrive as TMA zeros (K = 40 is under one 64-wide
    # k-tile, 200 ends in a partial one) and M is masked on store; the tile
    # (64 or 128 rows x 8 to 192 columns) follows the shape
    rn = _rand(dev, m + n + k)
    a = rn(m, k, dtype=dtype)
    w = rn(n, k, std=k ** -0.5, dtype=dtype)
    scale = (1 + rn(k, std=0.1)).to(dtype)
    resid = rn(m, n, dtype=dtype)
    for epi, kw in (("round", dict(scale=scale)), ("relu", dict(scale=scale)),
                    ("residual", dict(resid=resid))):
        got = kd.gemm(a, w, epi, **kw)
        assert got.shape == (m, n) and got.dtype == dtype
        _close(got, kd.gemm_plain(a, w, epi, **kw), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gemm_writes_only_its_output(dev, dtype):
    # the rows around C hold NaN canaries: the masked epilogue of a ragged
    # tile must leave them alone, whether the tile's last split or its only
    # unit writes it, and whichever persistent block walks it
    m, n, k = 65, 200, 96
    rn = _rand(dev, 11)
    a, w = rn(m, k, dtype=dtype), rn(n, k, std=k ** -0.5, dtype=dtype)
    scale, resid = (1 + rn(k, std=0.1)).to(dtype), rn(m, n, dtype=dtype)
    lib, code = kd._lib(), build.DTYPES[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    plans = [None]
    if dtype == torch.bfloat16:          # 2 k-tiles: split 2 ways
        plans += [kd.GemmPlan(1, 64, 6, 2, 0, 3), kd.GemmPlan(2, 128, 4, 2, 0, 1),
                  kd.GemmPlan(1, 8, 8, 1, 0, 5)]
    else:                                # 3 k-tiles of 32: cut 2 and 3 ways
        plans += [kd.ws_plan(m, n, k, 128, 96, 2, 2),
                  kd.ws_plan(m, n, k, 64, 192, 2, 264, stages=2),
                  kd.ws_plan(m, n, k, 64, 192, 1, 132),
                  kd.ws_plan(m, n, k, 128, 96, 3, 5),
                  kd.ws_plan(m, n, k, 64, 192, 3, 4, stages=1),
                  kd.ws_plan(m, n, k, 128, 96, 1, 1, stages=4)]
    for plan in plans:
        buf = torch.full((m + 2, n), float("nan"), dtype=dtype, device=dev)
        out = buf[1:m + 1]
        for epi, sc, rs, want in (
                (kd.EPI_ROUND, scale, None,
                 kd.gemm_plain(a, w, "round", scale=scale)),
                (kd.EPI_RESIDUAL, None, resid,
                 kd.gemm_plain(a, w, "residual", resid=resid))):
            kd._gemm(lib, code, a, sc, w, rs, out, epi, 1e-6, stream, "gemm",
                     plan)
            torch.cuda.synchronize()
            assert bool(buf[0].isnan().all()) and bool(buf[m + 1].isnan().all())
            _close(out, want, dtype)


# the FFN's products on the main path: (N, K) of wi and wo at t5-base width
FFN_GEMMS = {"wi": (3072, 768), "wo": (768, 3072)}


@pytest.mark.parametrize("m", [1, 33, 991, 3200])
@pytest.mark.parametrize("k", [776, 3072, 3080])
def test_gemm_split_and_persistent_plans_match_plain(dev, m, k):
    # k-tiles 13, 48 and 49 (776 and 3,080 end in a partial one); 5 and 11
    # splits divide none of them; fewer blocks than units make each block
    # walk several units through one ring
    n = 200
    rn = _rand(dev, m + k)
    a = rn(m, k, dtype=torch.bfloat16)
    w = rn(n, k, std=k ** -0.5, dtype=torch.bfloat16)
    scale = (1 + rn(k, std=0.1)).to(torch.bfloat16)
    resid = rn(m, n, dtype=torch.bfloat16)
    plans = [None, kd.GemmPlan(2, 128, 4, 5, 0, 7), kd.GemmPlan(1, 32, 8, 11, 0, 132),
             kd.GemmPlan(2, 160, 4, 1, 0, 2), kd.GemmPlan(1, 96, 6, 11, 0, 1)]
    for plan in plans:
        for epi, kw in (("relu", dict(scale=scale)), ("residual", dict(resid=resid))):
            got = kd.gemm(a, w, epi, plan=plan, **kw)
            _close(got, kd.gemm_plain(a, w, epi, **kw), torch.bfloat16)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [1, 33, 320, 991, 3200])
@pytest.mark.parametrize("k", [768, 3072])
def test_gemm_f32_split_plans_match_plain(dev, m, k):
    # the f32 GEMM at the main path's depths: its own plan and forced plans
    # of the warp-specialised ring (both tiles cut at every k-tile, in 2 to
    # 13 units (none divides 24 or 96 k-tiles but 2) or whole, one block
    # walking every unit, 3 to 264 blocks, rings of 1 to 7 stages); N = 200
    # ends in a partial tile of every width
    n = 200
    rn = _rand(dev, 2 * m + k)
    a = rn(m, k)
    w = rn(n, k, std=k ** -0.5)
    scale = 1 + rn(k, std=0.1)
    resid = rn(m, n)
    plans = [None, kd.ws_plan(m, n, k, 128, 96, 2, 3),
             kd.ws_plan(m, n, k, 64, 192, 7, 131, stages=7),
             kd.ws_plan(m, n, k, 128, 96, 13, 200, stages=2),
             kd.ws_plan(m, n, k, 64, 192, None, 17),
             kd.ws_plan(m, n, k, 128, 96, 1, 1, stages=5),
             kd.ws_plan(m, n, k, 128, 96, None, 264),
             kd.ws_plan(m, n, k, 128, 96, 5, 7),
             kd.ws_plan(m, n, k, 64, 192, 1, 132),
             kd.ws_plan(m, n, k, 64, 192, 11, 264, stages=1),
             kd.ws_plan(m, n, k, 128, 96, None, 132, stages=6),
             kd.ws_plan(m, n, k, 64, 192, None, 1)]
    for plan in plans:
        for epi, kw in (("round", dict(scale=scale)),
                        ("relu", dict(scale=scale)),
                        ("residual", dict(resid=resid))):
            got = kd.gemm(a, w, epi, plan=plan, **kw)
            _close(got, kd.gemm_plain(a, w, epi, **kw), torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [32, 320, 992, 3200])
@pytest.mark.parametrize("which", ["wi", "wo"])
def test_gemm_is_deterministic(dev, dtype, m, which):
    # two calls, and replays of a CUDA graph of the call, are bit-equal:
    # split partials are summed in split order, and the arrival counters
    # are zero again after every launch
    n, k = FFN_GEMMS[which]
    rn = _rand(dev, m + n)
    a = rn(m, k, dtype=dtype)
    w = rn(n, k, std=k ** -0.5, dtype=dtype)
    resid = rn(m, n, dtype=dtype)
    forced = (kd.GemmPlan(2, 128, 4, 7, 0, 132) if dtype == torch.bfloat16
              else kd.ws_plan(m, n, k, 128, 96, 9, 132))
    for plan in (None, forced):
        first = kd.gemm(a, w, "residual", resid=resid, plan=plan)
        assert torch.equal(kd.gemm(a, w, "residual", resid=resid, plan=plan),
                           first)
        out = {}

        def call():
            out["c"] = kd.gemm(a, w, "residual", resid=resid, plan=plan)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        for _ in range(3):
            out["c"].fill_(0)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out["c"], first)
        assert torch.equal(kd._counters(a.device), torch.zeros_like(
            kd._counters(a.device)))


def test_ffn_main_path_shapes_get_split_or_persistent_plans(dev):
    # R = 32: the K = 3,072 product splits its k-tiles, so that at least
    # half the SMs each read a slice of W; R = 992 and 3,200: the units
    # fill >= 90% of the SMs, and at 3,200 rows the wi product's blocks
    # each walk several units
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in (32, 992, 3200):
        for which, (n, k) in FFN_GEMMS.items():
            plan = kd.gemm_plan(m, n, k, dev)
            assert plan.blocks == min(plan.units, sms), plan
            if m == 32 and which == "wo":
                assert plan.splits > 1 and plan.units >= sms // 2, plan
            elif m > 32:
                assert plan.blocks >= 0.9 * sms, plan
    assert kd.gemm_plan(3200, *FFN_GEMMS["wi"], dev).units > sms


def test_gemm_refuses_plans_it_does_not_serve(dev):
    rn = _rand(dev, 12)
    a = rn(64, 128, dtype=torch.bfloat16)
    w = rn(64, 128, dtype=torch.bfloat16)
    resid = rn(64, 64, dtype=torch.bfloat16)
    for plan in (kd.GemmPlan(2, 96, 4, 1, 0, 1),      # no such tile
                 kd.GemmPlan(1, 64, 6, 3, 0, 1),      # 3 splits of 2 k-tiles
                 kd.GemmPlan(1, 64, 6, 1, 0, 0)):     # no blocks
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.gemm(a, w, "residual", resid=resid, plan=plan)
    a32, w32, r32 = a.float(), w.float(), resid.float()
    for plan in (kd.GemmPlan(4, 96, 3, 1, 0, 1, 3),       # no kernel 3
                 kd.ws_plan(64, 64, 128, 128, 64, 1, 1),  # no 128 x 64 tile
                 kd.ws_plan(64, 64, 128, 128, 96, 9, 1)): # 9 cuts of 4 k-tiles
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.gemm(a32, w32, "residual", resid=r32, plan=plan)
    with pytest.raises(ValueError, match="bf16 plan"):
        kd.gemm(a32, w32, "residual", resid=r32, plan=kd.GemmPlan(1, 64, 6, 1, 0, 1))


# the four f32 products of a t5-base decoder layer: QKV; self-O, cross-Q
# and cross-O; wi; wo
T5_GEMMS = {"qkv": (2304, 768), "o": (768, 768), "wi": (3072, 768),
            "wo": (768, 3072)}


@pytest.mark.parametrize("m", [1, 2, 7, 8, 31, 32, 33, 64, 100, 127, 128])
@pytest.mark.parametrize("which", list(T5_GEMMS))
def test_gemm_f32_rows_matches_plain(dev, m, which):
    # the small-row kernel at every row tiling (mt 8 / 32 / 40 / 64 / 112 /
    # 128, rows past M as TMA zeros), the chooser's plan and forced ones: a
    # ring that wraps (2 stages), the widest cluster (8 blocks of 3 or 12
    # k-tiles), one block down all of K; strips of 48 and 64 columns (the
    # ragged strip past N: test_gemm_f32_split_plans_match_plain, N = 200)
    n, k = T5_GEMMS[which]
    rn = _rand(dev, 3 * m + n + k)
    a, w = rn(m, k), rn(n, k, std=k ** -0.5)
    scale, resid = 1 + rn(k, std=0.1), rn(m, n)
    plans = [None, kd.rows_plan(m, n, 64, 3, 2), kd.rows_plan(m, n, 48, 8, 8),
             kd.rows_plan(m, n, 48, 1, 4)]
    for plan in plans:
        for epi, kw in (("round", dict(scale=scale)), ("relu", dict(scale=scale)),
                        ("residual", dict(resid=resid))):
            got = kd.gemm(a, w, epi, plan=plan, **kw)
            _close(got, kd.gemm_plain(a, w, epi, **kw), torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [1, 31, 100])
@pytest.mark.parametrize("which", ["wi", "wo"])
def test_gemm_f32_rows_is_deterministic_without_workspace(dev, monkeypatch, m,
                                                           which):
    # the cluster's partials are summed rank by rank in shared memory: two
    # calls and replays of a CUDA graph of the call are bit-equal, and no
    # workspace or arrival counter is asked for
    monkeypatch.setattr(kd, "_counters", lambda device: pytest.fail(
        "the small-row kernel touched the split-K counters"))
    n, k = T5_GEMMS[which]
    rn = _rand(dev, m + n)
    a, w, resid = rn(m, k), rn(n, k, std=k ** -0.5), rn(m, n)
    for plan in (kd.gemm_plan(m, n, k, dev, torch.float32),
                 kd.rows_plan(m, n, 48, 8, 2)):
        assert plan.kernel == kd.KERNEL_ROWS and plan.workspace(m, n) == 0, plan
        first = kd.gemm(a, w, "residual", resid=resid, plan=plan)
        assert torch.equal(kd.gemm(a, w, "residual", resid=resid, plan=plan),
                           first)
        out = {}

        def call():
            out["c"] = kd.gemm(a, w, "residual", resid=resid, plan=plan)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        for _ in range(3):
            out["c"].fill_(0)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out["c"], first)


def test_f32_chooser_takes_the_rows_kernel_up_to_128_rows(dev):
    # one query a retrieve decodes 1, 31 and 100 rows, step 0 of a batch of
    # 32 queries 32: the small-row kernel; 992 and 3,200 rows go to the
    # warp-specialised ring
    for n, k in T5_GEMMS.values():
        for m in (1, 31, 32, 100):
            plan = kd.gemm_plan(m, n, k, dev, torch.float32)
            assert plan.kernel == kd.KERNEL_ROWS and plan.rows == kd.rows_pad(m), (
                m, n, k, plan)
        for m in (992, 3200):
            plan = kd.gemm_plan(m, n, k, dev, torch.float32)
            assert plan.kernel == kd.KERNEL_WS and plan.rows in (64, 128), (m, n, k, plan)
        assert kd.gemm_plan(1, n, k, dev, torch.bfloat16).kernel == kd.KERNEL_WGMMA


@pytest.mark.parametrize("m", [1, 8, 31, 64, 100, 128])
def test_f32_chooser_picks_the_least_time_of_the_model_the_sweep_fits(dev, m):
    # kernels/f32_bench.py sweep fits the small-row model through
    # gdr_gemm_rows_time, the library's own: the chooser's plan is that
    # model's least time over its strips and clusters at 4 stages, and the
    # plans the kernel refuses have no time
    from gdr_tpu_torch.kernels import f32_bench as fb

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k in T5_GEMMS.values():
        plan = kd.gemm_plan(m, n, k, dev, torch.float32)
        assert plan.stages == 4, plan
        times = {(bn, cl): fb.rows_ms(bn, cl, 4, m, n, k, sms)
                 for bn in fb.ROWS_BN for cl in fb.ROWS_CLUSTERS}
        least = min(t for t in times.values() if t is not None)
        assert times[(plan.bn, plan.splits)] == least, (m, n, k, plan, times)
        assert fb.rows_ms(64, 9, 4, m, n, k, sms) is None      # clusters of 8 at most
        assert fb.rows_ms(32, 1, 4, m, n, k, sms) is None      # no such strip
    assert fb.rows_ms(64, 1, 4, 129, 768, 768, sms) is None    # 128 rows at most
    fitted = fb.rows_ms(64, 3, 4, m, 2304, 768, sms)
    assert fb.rows_ms(64, 3, 4, m, 2304, 768, sms,
                      (0.473, 3.72e-6, 15.6e9, 16.8e9, 140e9)) == pytest.approx(fitted)


def test_gemm_rows_kernel_refuses_what_it_does_not_serve(dev):
    rn = _rand(dev, 13)
    n, k = 256, 256
    w = rn(n, k, std=k ** -0.5)
    a129, r129 = rn(129, k), rn(129, n)
    forced = kd.rows_plan(128, n)._replace(wg=17)      # 136 rows: a tile past 128
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.gemm(a129, w, "residual", resid=r129, plan=forced)
    a, resid = rn(31, k), rn(31, n)
    for plan in (kd.rows_plan(31, n)._replace(wg=3),      # 24 rows < M
                 kd.rows_plan(100, n)._replace(wg=13),    # 104: not a 16-row tiling
                 kd.rows_plan(31, n, bn=32),              # no such strip
                 kd.rows_plan(31, n, splits=9),           # clusters of 8 at most
                 kd.rows_plan(31, n, stages=9),           # 8 stages at most
                 kd.rows_plan(31, n, splits=0)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.gemm(a, w, "residual", resid=resid, plan=plan)
    k_small = 64                                         # 2 k-tiles: 3 splits refused
    with pytest.raises(RuntimeError, match="CUDA error"):
        kd.gemm(a[:, :k_small].contiguous(), w[:, :k_small].contiguous(), "residual",
                resid=resid, plan=kd.rows_plan(31, n, splits=3))
    with pytest.raises(ValueError, match="f32 plan"):
        kd.gemm(a.bfloat16(), w.bfloat16(), "residual", resid=resid.bfloat16(),
                plan=kd.rows_plan(31, n))


def test_rows_kernel_is_counted_by_the_decoder_roofline(dev):
    # decoder_roofline.serve sums the device time of the sublayer kernels by
    # name (gdrbench/metrics, read as the benchmark reads it): the small-row
    # kernel's name has to pass its filter, or the metric's denominator loses
    # the GEMM
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    path = (Path(__file__).resolve().parents[1] / "gdrbench" / "metrics"
            / "decoder_roofline.serve.py")
    spec = importlib.util.spec_from_file_location("decoder_roofline", path)
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    rn = _rand(dev, 14)
    n, k = T5_GEMMS["o"]
    a, w, resid = rn(31, k), rn(n, k, std=k ** -0.5), rn(31, n)
    kd.gemm(a, w, "residual", resid=resid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kd.gemm(a, w, "residual", resid=resid)
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA}
    rows = [nm for nm in names if "gemm_f32_ring_rows" in nm]
    assert rows and all(roof.is_decoder_kernel(nm) for nm in rows), names


# the warp-specialised ring's tiles (rows, columns)
WS_TILES = ((128, 96), (64, 192))


def _ws_forced(m, n, k):
    # both tiles cut at every k-tile over two blocks an SM, in 5 units over
    # 132 blocks and whole over 264 (a deeper ring there), and one block
    # walking every unit of the 64-row tile
    plans = [kd.ws_plan(m, n, k, bm, bn, None, 264) for bm, bn in WS_TILES]
    return plans + [kd.ws_plan(m, n, k, 128, 96, 5, 132),
                    kd.ws_plan(m, n, k, 128, 96, 1, 264, stages=4),
                    kd.ws_plan(m, n, k, 64, 192, None, 1)]


@pytest.mark.parametrize("m", [129, 320, 992, 997, 3200])
@pytest.mark.parametrize("which", list(T5_GEMMS))
def test_gemm_f32_ws_matches_plain(dev, m, which):
    # the warp-specialised ring above 128 rows at the four t5-base products
    # and every epilogue: the chooser's plan and forced ones that cut tiles'
    # k-ranges across blocks (ragged M: 129, 320 and 997 end in a partial
    # row tile)
    n, k = T5_GEMMS[which]
    rn = _rand(dev, 5 * m + n + k)
    a, w = rn(m, k), rn(n, k, std=k ** -0.5)
    scale, resid = 1 + rn(k, std=0.1), rn(m, n)
    for plan in [None] + _ws_forced(m, n, k):
        for epi, kw in (("round", dict(scale=scale)), ("relu", dict(scale=scale)),
                        ("residual", dict(resid=resid))):
            got = kd.gemm(a, w, epi, plan=plan, **kw)
            _close(got, kd.gemm_plain(a, w, epi, **kw), torch.float32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [129, 992, 3200])
@pytest.mark.parametrize("which", list(T5_GEMMS))
def test_gemm_f32_ws_is_deterministic(dev, m, which):
    # two eager calls and replays of a CUDA graph of the call are bit-equal
    # under a plan that cuts every tile at every k-tile and one of 5 units a
    # tile: a cut tile's partials are summed in k order whichever block
    # arrives last, and the arrival counters are zero again after every
    # launch
    n, k = T5_GEMMS[which]
    rn = _rand(dev, 7 * m + n)
    a, w = rn(m, k), rn(n, k, std=k ** -0.5)
    scale = 1 + rn(k, std=0.1)
    for plan in (kd.ws_plan(m, n, k, 128, 96, None, 264),
                 kd.ws_plan(m, n, k, 64, 192, 5, 132)):
        first = kd.gemm(a, w, "relu", scale=scale, plan=plan)
        assert torch.equal(kd.gemm(a, w, "relu", scale=scale, plan=plan), first)
        out = {}

        def call():
            out["c"] = kd.gemm(a, w, "relu", scale=scale, plan=plan)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        for _ in range(3):
            out["c"].fill_(0)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out["c"], first)
        assert torch.equal(kd._counters(a.device), torch.zeros_like(
            kd._counters(a.device)))


# the row counts above 128 that kernels/f32_bench.py sweep times
SWEPT_ROWS = (129, 320, 992, 997, 3200)


def test_f32_chooser_takes_the_ws_ring_at_the_least_time_of_its_model(dev):
    # above 128 rows the chooser takes the warp-specialised ring for every
    # product, at the least time of the model that kernels/f32_bench.py
    # sweep fits (gdr_gemm_ws_time, the library's own) among the plans the
    # chooser weighs (gdr_gemm_ws_plans, the list the sweep times), with the
    # ring depth that list gives the tile; tiles and cuts the ring lacks
    # have no time
    from gdr_tpu_torch.kernels import f32_bench as fb

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m in SWEPT_ROWS:
        for n, k in T5_GEMMS.values():
            plan = kd.gemm_plan(m, n, k, dev, torch.float32)
            assert plan.kernel == kd.KERNEL_WS, (m, n, k, plan)
            listed = fb.ws_plans(m, n, k, sms)
            assert (plan.rows, plan.bn, plan.stages, plan.splits, plan.blocks) in listed
            mine = fb.ws_ms(plan.rows, plan.bn, plan.splits, plan.blocks, m, n, k, sms)
            least = min(fb.ws_ms(bm, bn, s, g, m, n, k, sms) for bm, bn, _, s, g in listed)
            assert mine == pytest.approx(least, rel=1e-12), (m, n, k, plan)
    assert fb.ws_ms(128, 128, 1, 132, 992, 768, 768, sms) is None
    assert fb.ws_ms(128, 96, 25, 132, 992, 768, 768, sms) is None      # 24 k-tiles


def test_gemm_ws_refuses_what_it_does_not_serve(dev):
    rn = _rand(dev, 16)
    a, w, resid = rn(64, 128), rn(64, 128), rn(64, 64)
    for plan in (kd.ws_plan(64, 64, 128, 96, 96, 1, 1),       # no 96-row tile
                 kd.ws_plan(64, 64, 128, 128, 128, 1, 1),     # no 128 x 128 tile
                 kd.ws_plan(64, 64, 128, 128, 96, 5, 1),      # 5 cuts of 4 k-tiles
                 kd.ws_plan(64, 64, 128, 128, 96, 1, 1, 9),   # 8 stages at most
                 kd.ws_plan(64, 64, 128, 64, 192, 1, 1, 8),   # 8 x 32 KB past 227 KB
                 kd.ws_plan(64, 64, 128, 128, 96, 1, 0)):     # no blocks
        with pytest.raises(RuntimeError, match="CUDA error"):
            kd.gemm(a, w, "residual", resid=resid, plan=plan)
    with pytest.raises(ValueError, match="f32 plan"):
        kd.gemm(a.bfloat16(), w.bfloat16(), "residual", resid=resid.bfloat16(),
                plan=kd.ws_plan(64, 64, 128))


def test_ws_kernel_is_counted_by_the_decoder_roofline(dev):
    # the warp-specialised ring's name passes decoder_roofline.serve's filter
    # (read as the benchmark reads it)
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    path = (Path(__file__).resolve().parents[1] / "gdrbench" / "metrics"
            / "decoder_roofline.serve.py")
    spec = importlib.util.spec_from_file_location("decoder_roofline", path)
    roof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roof)
    rn = _rand(dev, 15)
    n, k = T5_GEMMS["o"]
    a, w, resid = rn(3200, k), rn(n, k, std=k ** -0.5), rn(3200, n)
    assert kd.gemm_plan(3200, n, k, dev, torch.float32).kernel == kd.KERNEL_WS
    kd.gemm(a, w, "residual", resid=resid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kd.gemm(a, w, "residual", resid=resid)
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA}
    ws = [nm for nm in names if "gdr::gemm_f32_ring_ws<" in nm]
    assert ws and all(roof.is_decoder_kernel(nm) for nm in ws), names


@pytest.mark.parametrize("m", SWEPT_ROWS)
def test_f32_chooser_plan_is_within_10pct_of_the_fastest_swept_plan(dev, m):
    # on the clock, as kernels/f32_bench.py sweep times them (20 calls a
    # CUDA graph, each call reading its own copy of W from HBM), the
    # chooser's plan is within 10% of the fastest of the plans the sweep
    # runs at each product (its fitted model picked within 1-2% of the best
    # at every swept shape on the H100)
    from gdr_tpu_torch.kernels import f32_bench as fb

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rn = _rand(dev, 17 + m)
    for n, k in T5_GEMMS.values():
        a, w = rn(m, k), rn(n, k, std=k ** -0.5)
        ws = [w] + [w.clone() for _ in range(fb.CALLS - 1)]
        resid = rn(m, n)

        def clock(plan):
            return fb.time_ms(lambda i: kd.gemm(a, ws[i], "residual", resid=resid,
                                                plan=plan))
        kt = -(-k // 32)
        swept = {(bm, bn, st, s, g) for bm, bn, st, s, g in fb.ws_plans(m, n, k, sms)
                 if s in fb.SWEEP_CUTS or s == kt}
        best = min(clock(kd.ws_plan(m, n, k, bm, bn, s, g, st)) for bm, bn, st, s, g in swept)
        mine = clock(kd.gemm_plan(m, n, k, dev, torch.float32))
        assert mine <= 1.10 * best, (m, n, k, mine, best)


HEADS_W, DKV_W = 2, 64           # the main path's head width
INNER_W = HEADS_W * DKV_W


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_self_attn_core_at_l16_dkv64(dev, dtype, pos):
    lmax, r = 16, 37
    rn = _rand(dev, 100 + pos)
    x = rn(r, D, dtype=dtype)
    scale = (1 + rn(D, std=0.1)).to(dtype)
    wqkv = rn(3 * INNER_W, D, std=0.1, dtype=dtype)
    wo = rn(D, INNER_W, std=0.1, dtype=dtype)
    bias_row = rn(lmax, HEADS_W, std=0.5)
    ck, cv = rn(lmax, r, INNER_W, dtype=dtype), rn(lmax, r, INNER_W,
                                                   dtype=dtype)
    ck_p, cv_p, before = ck.clone(), cv.clone(), ck.clone()
    got, _, _ = kd.self_attn_sublayer(x, pos, scale, wqkv, wo, bias_row, ck,
                                      cv, heads=HEADS_W, d_kv=DKV_W)
    want, _, _ = kd.self_attn_sublayer_plain(x, pos, scale, wqkv, wo,
                                             bias_row, ck_p, cv_p,
                                             heads=HEADS_W, d_kv=DKV_W)
    _close(got, want, dtype)
    _close(ck, ck_p, dtype)
    _close(cv, cv_p, dtype)
    others = [l for l in range(lmax) if l != pos]
    assert torch.equal(ck[others], before[others])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [320, 3200])
@pytest.mark.parametrize("lmax", [17, 24, 40, 64])
def test_self_attn_sublayer_long_cache_every_pos(dev, dtype, r, lmax):
    """Caches longer than the register path (query generation samples at
    L = 40): t5-base widths, every position, the cache written only at
    ``pos``."""
    heads, d_kv, d = 12, 64, 768
    inner = heads * d_kv
    rn = _rand(dev, 1000 + lmax)
    scale = (1 + rn(d, std=0.1)).to(dtype)
    wqkv = rn(3 * inner, d, std=0.02, dtype=dtype)
    wo = rn(d, inner, std=0.02, dtype=dtype)
    bias_row = rn(lmax, heads, std=0.5)
    ck, cv = rn(lmax, r, inner, dtype=dtype), rn(lmax, r, inner, dtype=dtype)
    ck_p, cv_p = ck.clone(), cv.clone()
    for pos in range(lmax):
        x = rn(r, d, dtype=dtype)
        before = ck.clone()
        got, _, _ = kd.self_attn_sublayer(x, pos, scale, wqkv, wo, bias_row,
                                          ck, cv, heads=heads, d_kv=d_kv)
        want, _, _ = kd.self_attn_sublayer_plain(
            x, pos, scale, wqkv, wo, bias_row, ck_p, cv_p, heads=heads,
            d_kv=d_kv)
        _close(got, want, dtype)
        _close(ck, ck_p, dtype)
        _close(cv, cv_p, dtype)
        others = [l for l in range(lmax) if l != pos]
        assert torch.equal(ck[others], before[others])
        ck_p.copy_(ck)                 # the next step reads the same cache
        cv_p.copy_(cv)


def test_self_attn_sublayer_refuses_caches_past_its_limit(dev):
    heads, d_kv = 2, 64
    inner = heads * d_kv
    limit = kd.self_attn_max_len(d_kv, torch.float32)
    rn = _rand(dev, 5)
    x, scale = rn(1, D), 1 + rn(D, std=0.1)
    ck = torch.zeros(limit + 1, 1, inner, device=dev)
    with pytest.raises(ValueError, match=f"L <= {limit}"):
        kd.self_attn_sublayer(x, 0, scale, rn(3 * inner, D), rn(D, inner),
                              rn(limit + 1, heads), ck, ck.clone(),
                              heads=heads, d_kv=d_kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s_len", ["1", "23", "max", "64", "65"])
@pytest.mark.parametrize("beams", [1, 100])
def test_cross_attn_core_lengths(dev, dtype, s_len, beams):
    # keys padded to the MMA width (bf16) or the 64-key tile (f32) past S
    # must get probability exactly 0; 64 keys are one pass of the f32
    # cores at d_kv 64, 65 two
    s_ = kd.cross_attn_max_len(DKV_W, dtype) if s_len == "max" else int(s_len)
    batch = 2
    rn = _rand(dev, s_ + beams)
    x = rn(batch * beams, D, dtype=dtype)
    scale = (1 + rn(D, std=0.1)).to(dtype)
    wcq = rn(INNER_W, D, std=0.1, dtype=dtype)
    wco = rn(D, INNER_W, std=0.1, dtype=dtype)
    cross_k = rn(batch, HEADS_W, s_, DKV_W, std=0.3, dtype=dtype)
    cross_v = rn(batch, HEADS_W, s_, DKV_W, dtype=dtype)
    cbias = rn(batch, HEADS_W, s_, std=0.5)
    if s_ > 2:
        cbias[:, :, s_ - 2:] += -1e9                  # padded key positions
    got = kd.cross_attn_sublayer(x, scale, wcq, wco, cross_k, cross_v, cbias,
                                 beams, heads=HEADS_W, d_kv=DKV_W)
    want = kd.cross_attn_sublayer_plain(x, scale, wcq, wco, cross_k, cross_v,
                                        cbias, beams, heads=HEADS_W,
                                        d_kv=DKV_W)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,cap", [(768, 32), (40, 5)],
                         ids=["d768", "d40"])
def test_packed_scores_match_plain(dev, dtype, d, cap):
    rn = _rand(dev, d + cap)
    m, r = 400, 37
    rows = rn(m, d, std=d ** -0.5, dtype=dtype)
    starts = (torch.randint(0, (m - cap) // 8, (r,), device=dev)
              * 8).to(torch.int32)
    q = rn(r, d)
    kernels.reset_launch_counts()
    got = kr.packed_scores(rows, starts, q, cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["packed_scores"] == 1
    assert got.shape == (r, cap) and got.dtype == torch.float32
    _close(got, kr.packed_scores_plain(rows, starts, q, cap), torch.float32)


def test_packed_scores_out_of_store_beam_is_nan(dev):
    rn = _rand(dev, 3)
    m, d, cap = 64, 32, 8
    rows = rn(m, d, dtype=torch.bfloat16)
    starts = torch.tensor([0, m - cap, m - cap + 1, -8], dtype=torch.int32,
                          device=dev)
    got = kr.packed_scores(rows, starts, rn(4, d), cap)
    assert bool(got[:2].isfinite().all()) and bool(got[2:].isnan().all())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rn = _rand(dev, 0)
    x = rn(8, D)
    scale = 1 + rn(D, std=0.1)
    wi, wo = rn(DFF, D, std=0.1), rn(D, DFF, std=0.1)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="non-contiguous"):
        kd.ffn_sublayer(rn(D, 8).t(), scale, wi, wo)
    with pytest.raises(TypeError):
        kd.ffn_sublayer(x, scale, wi.to(torch.bfloat16), wo)
    with pytest.raises(TypeError, match="not supported"):
        kd.ffn_sublayer(x.half(), scale.half(), wi.half(), wo.half())
    with pytest.raises(TypeError, match="int32"):
        kr.packed_scores(rn(64, D), torch.zeros(4, dtype=torch.int64,
                                                device=dev), rn(4, D), 8)
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        kr.packed_scores(rn(64, 36, dtype=torch.bfloat16), starts, rn(4, 36), 8)
    wqkv, wo_a = rn(3 * INNER, D, std=0.1), rn(D, INNER, std=0.1)
    ck, cv = rn(LMAX, 8, INNER), rn(LMAX, 8, INNER)
    with pytest.raises(ValueError, match="cpu"):
        kd.self_attn_sublayer(x, 0, scale, wqkv, wo_a, rn(LMAX, HEADS).cpu(),
                              ck, cv, heads=HEADS, d_kv=DKV)
    s_long = kd.cross_attn_max_len(DKV, torch.float32) + 1
    kv, kv_s = rn(2, HEADS, s_long, DKV), rn(2, HEADS, S, DKV)
    with pytest.raises(ValueError, match="cpu"):
        kd.cross_attn_sublayer(x, scale, wqkv[:INNER], wo_a, kv_s, kv_s,
                               rn(2, HEADS, S).cpu(), 4, heads=HEADS,
                               d_kv=DKV)
    with pytest.raises(ValueError, match="at most"):
        kd.cross_attn_sublayer(x, scale, wqkv[:INNER], wo_a, kv, kv,
                               rn(2, HEADS, s_long), 4, heads=HEADS, d_kv=DKV)
    with pytest.raises(ValueError, match="16-byte"):     # TMA alignment
        kd.gemm(x.view(-1)[2:2 + 7 * D].view(7, D), wi, "round", scale=scale)
    with pytest.raises(ValueError, match="d_kv 24"):
        kd.self_attn_sublayer(x, 0, scale, rn(3 * 48, D), rn(D, 48),
                              rn(LMAX, 2), rn(LMAX, 8, 48), rn(LMAX, 8, 48),
                              heads=2, d_kv=24)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,cap", [(768, 64), (48, 5)], ids=["d768", "d48"])
def test_packed_scores_int8_match_plain(dev, q_dtype, d, cap):
    rn = _rand(dev, d + cap + 1)
    m, r = 32 * 12 + cap, 37
    values = (rn(m, d) * 50).clamp(-127, 127).round().to(torch.int8)
    starts = (torch.randint(0, (m - cap) // 32 + 1, (r,), device=dev)
              * 32).to(torch.int32)
    q = rn(r, d, std=0.05, dtype=q_dtype)
    kernels.reset_launch_counts()
    got = kr.packed_scores_int8(values, starts, q, cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.launch_counts(), 0), "packed_scores_int8": 1}
    assert got.shape == (r, cap) and got.dtype == torch.float32
    _close(got, kr.packed_scores_int8_plain(values, starts, q, cap),
           torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,cap", [(768, 64), (48, 5)], ids=["d768", "d48"])
def test_rerank_scores_match_plain(dev, dtype, d, cap):
    rn = _rand(dev, d + cap + 2)
    n, r = 300, 37
    store = rn(n, d, std=d ** -0.5, dtype=dtype)
    docs = torch.randint(0, n, (r, cap), device=dev, dtype=torch.int32)
    mask = torch.rand(r, cap, device=dev) < 0.7
    mask[3] = False                                  # a fully masked beam
    docs[~mask] = n + 5        # masked slots are not read: out of range is fine
    q = rn(r, d)
    kernels.reset_launch_counts()
    got = kr.rerank_scores(store, docs, q, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {**dict.fromkeys(
        kernels.launch_counts(), 0), "rerank_scores": 1}
    assert got.shape == (r, cap) and got.dtype == torch.float32
    assert bool((got[~mask] == -1e9).all())
    _close(got, kr.rerank_scores_plain(store, docs, q, mask), torch.float32)


def test_int8_and_gather_scorers_nan_cases(dev):
    rn = _rand(dev, 4)
    m, d, cap = 96, 32, 8
    values = (rn(m, d) * 40).round().clamp(-127, 127).to(torch.int8)
    starts = torch.tensor([0, m - cap, m - cap + 1, -32], dtype=torch.int32,
                          device=dev)
    got = kr.packed_scores_int8(values, starts, rn(4, d), cap)
    assert bool(got[:2].isfinite().all()) and bool(got[2:].isnan().all())
    store = rn(10, d, dtype=torch.bfloat16)
    docs = torch.tensor([[0, 9, 10, -1], [10, -1, 3, 3]], dtype=torch.int32,
                        device=dev)
    mask = torch.tensor([[True, True, True, True],
                         [False, False, True, False]], device=dev)
    got = kr.rerank_scores(store, docs, rn(2, d), mask)
    assert bool(got[0, :2].isfinite().all()) and bool(got[0, 2:].isnan().all())
    assert got[1].tolist()[:2] == [-1e9, -1e9] and got[1, 3].item() == -1e9
    assert bool(got[1, 2].isfinite())


def test_scorer_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rn = _rand(dev, 5)
    kernels.reset_launch_counts()
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    int8_rows = torch.zeros(64, 48, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="int8"):
        kr.packed_scores_int8(rn(64, 48, dtype=torch.bfloat16), starts,
                              rn(4, 48), 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kr.packed_scores(int8_rows, starts, rn(4, 48), 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        kr.packed_scores_int8(torch.zeros(64, 40, dtype=torch.int8,
                                          device=dev), starts, rn(4, 40), 8)
    with pytest.raises(TypeError, match="int32"):
        kr.packed_scores_int8(int8_rows, starts.long(), rn(4, 48), 8)
    with pytest.raises(ValueError, match="cpu"):
        kr.packed_scores_int8(int8_rows, starts, rn(4, 48).cpu(), 8)
    with pytest.raises(ValueError, match="16-byte"):
        kr.packed_scores_int8(int8_rows.view(-1)[8:8 + 63 * 48].view(63, 48),
                              starts, rn(4, 48), 8)
    store = rn(20, 48)
    docs = torch.zeros(4, 6, dtype=torch.int32, device=dev)
    mask = torch.ones(4, 6, dtype=torch.bool, device=dev)
    with pytest.raises(TypeError, match="int32"):
        kr.rerank_scores(store, docs.long(), rn(4, 48), mask)
    with pytest.raises(TypeError, match="bool"):
        kr.rerank_scores(store, docs, rn(4, 48), mask.int())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kr.rerank_scores(store.to(torch.int8), docs, rn(4, 48), mask)
    with pytest.raises(ValueError, match="multiple of 8"):
        kr.rerank_scores(rn(20, 36, dtype=torch.bfloat16), docs, rn(4, 36),
                         mask)
    with pytest.raises(ValueError, match="non-contiguous"):
        kr.rerank_scores(store, docs.t().contiguous().t(), rn(4, 48), mask)
    with pytest.raises(ValueError, match="cpu"):
        kr.rerank_scores(store, docs, rn(4, 48), mask.cpu())
    with pytest.raises(ValueError, match="mask"):
        kr.rerank_scores(store, docs, rn(4, 48), mask[:, :5].contiguous())
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_store_on_the_card_equals_cpu(dev, dtype):
    from gdr_tpu_torch.ops.quantize import quantize_store
    rn = _rand(dev, 6)
    x = rn(257, 96, dtype=dtype) * (1 + rn(257, 1).abs() * 100).to(dtype)
    got, want = quantize_store(x), quantize_store(x.cpu())
    assert torch.equal(got.values.cpu(), want.values)
    assert torch.equal(got.scales.cpu(), want.scales)


def _small_trie():
    from gdr_tpu_torch.ops.trie import build_trie
    cid_to_docs, doc = {}, 0
    for a in range(4):
        for b in range(3):
            for c in range(2):
                cid_to_docs[f"{a}-{b}-{c}"] = list(range(doc, doc + 3))
                doc += 3
    cid_to_docs["3-3"] = [doc, doc + 1]
    return build_trie(cid_to_docs, 4, max_docs_per_cluster=8), doc + 2


@pytest.mark.parametrize("layout", ["packed bf16", "packed int8",
                                    "plain bf16"])
def test_scorers_score_each_beam_against_its_own_query_row(dev, layout):
    # decoder-side reps give every beam its own query row [B, K, d]: the
    # card's re-rank equals the CPU's, and differs from scoring every beam
    # by its query's first row
    from gdr_tpu_torch.ops.packed_store import pack_layout, pack_rows
    from gdr_tpu_torch.ops.quantize import pack_quantized_rows
    from gdr_tpu_torch.ops.rerank import rerank, rerank_packed
    trie, n = _small_trie()
    g = torch.Generator().manual_seed(21)
    b, k, d = 3, 6, 64
    store = torch.randn(n, d, generator=g)
    store = (store / store.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    leaves = torch.as_tensor((trie.cluster_of_node >= 0).nonzero()[0])
    nodes = leaves[torch.randperm(len(leaves), generator=g)[:b * k]
                   ].view(b, k).to(torch.int32)
    scores = torch.randn(b, k, generator=g).sort(dim=1, descending=True).values
    valid = torch.ones(b, k, dtype=torch.bool)
    valid[2, 4:] = False
    cl = torch.as_tensor(trie.cluster_of_node)
    alphas = torch.tensor([0.0, 1.0])
    q_rows = torch.randn(b, k, d, generator=g) * 0.3
    if layout.startswith("packed"):
        *arrays, cap = pack_layout(trie, align=32 if "int8" in layout else 8)
        starts, counts, row_to_doc = map(torch.as_tensor, arrays)
        rows = (pack_quantized_rows(store, row_to_doc) if "int8" in layout
                else pack_rows(store, row_to_doc))
        tables = (starts, counts, row_to_doc, cap)
    else:
        rows = store
        tables = (torch.as_tensor(trie.cluster_docs),
                  torch.as_tensor(trie.cluster_doc_mask))

    def run(device, q):
        to = (lambda t: t.to(device) if torch.is_tensor(t) else t)
        r = (to(rows) if torch.is_tensor(rows) else
             type(rows)(values=to(rows.values), scales=to(rows.scales)))
        beams = [to(t) for t in (nodes, scores, valid)]
        if layout.startswith("packed"):
            return rerank_packed(r, *map(to, tables), to(q), *beams, to(cl),
                                 to(alphas), top_r=12)
        return rerank(r, to(q), *beams, to(cl), *map(to, tables), to(alphas),
                      top_r=12)
    kernels.reset_launch_counts()
    got = run(dev, q_rows)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 1
    want = run(torch.device("cpu"), q_rows)
    dv = want.doc_valid
    assert dv.sum() > 0 and torch.equal(got.doc_valid.cpu(), dv)
    assert torch.equal(got.doc_ids.cpu()[dv], want.doc_ids[dv])
    torch.testing.assert_close(got.scores.cpu()[dv], want.scores[dv],
                               atol=1e-5, rtol=1e-5)
    first = run(dev, q_rows[:, :1].expand(-1, k, -1).contiguous())
    assert not torch.equal(first.scores, got.scores)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("option", list(SMALL_MODES))
def test_retrieve_options_on_the_card_equal_cpu(dev, option, packed):
    # chip_smoke.py phase 3 runs the same options (one table, SMALL_MODES)
    # on a trie whose clusters all sit at depth 3; this trie adds one at
    # depth 2, so beams finish at two depths
    import numpy as np

    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
    from gdr_tpu_torch.ops.beam import gumbel_noise
    m_kw, e_kw = SMALL_MODES[option]
    cfg = ModelConfig(kary=4, max_output_length=5, d_model=64, d_kv=16,
                      d_ff=128, num_layers=2, num_decoder_layers=2,
                      num_heads=4, vocab_size=512, encoder_d_model=64,
                      adaptor_layer_num=1, adaptor_num_heads=2, **m_kw)
    trie, n = _small_trie()
    rng = np.random.default_rng(1)
    store = rng.normal(size=(n, 64)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids = rng.integers(2, 512, size=(3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    cpu_model = init_weights(GenerativeRetriever(cfg),
                             torch.Generator().manual_seed(0)).eval()
    gpu_model = GenerativeRetriever(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.to(dev).eval()
    ev_cfg = EvalConfig(num_beams=12, num_return_sequences=20,
                        max_output_length=5, **e_kw)
    ev_c = Evaluator(cpu_model, trie, store, ev_cfg, packed=packed)
    ev_g = Evaluator(gpu_model, trie, store, ev_cfg, packed=packed)
    noise = None
    if ev_cfg.gen_method == "top_k":      # one draw, given to both devices
        noise = gumbel_noise((ev_c._max_len, 3 * ev_cfg.num_beams, 5),
                             torch.Generator().manual_seed(5))
    res_c, rr_c = ev_c.retrieve(ids, mask, noise=noise)
    kernels.reset_launch_counts()
    res_g, rr_g = ev_g.retrieve(ids, mask, noise=noise)
    torch.cuda.synchronize()
    steps = ev_g._max_len * cfg.num_decoder_layers
    assert {k: kernels.launch_counts()[k] for k in kd.WRAPPERS} \
        == dict.fromkeys(kd.WRAPPERS, steps)
    valid = res_c.valid
    assert torch.equal(res_g.valid.cpu(), valid)
    assert torch.equal(res_g.nodes.cpu()[valid], res_c.nodes[valid])
    dv = rr_c.doc_valid
    assert dv.sum() > 0 and torch.equal(rr_g.doc_valid.cpu(), dv)
    assert torch.equal(rr_g.doc_ids.cpu()[dv], rr_c.doc_ids[dv])
    torch.testing.assert_close(rr_g.scores.cpu()[dv], rr_c.scores[dv],
                               atol=1e-4, rtol=0)


# --- the index path on the card: plain PyTorch, held to the CPU's run

def _unit_rows(n: int, d: int, seed: int) -> torch.Tensor:
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(seed))
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("n,d,k", [(2000, 32, 30), (5000, 768, 30)])
def test_kmeans_lloyd_on_the_card_matches_cpu(dev, n, d, k):
    from gdr_tpu_torch.ops.kmeans import kmeans_fit
    x = _unit_rows(n, d, n)
    init = x[torch.randperm(n, generator=torch.Generator().manual_seed(1))[:k]]
    c_cpu, a_cpu = kmeans_fit(x, k, 25, init=init)
    c_gpu, a_gpu = kmeans_fit(x.to(dev), k, 25, init=init.to(dev))
    assert torch.equal(a_gpu.cpu(), a_cpu)
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, atol=1e-4, rtol=0)


def test_kmeans_minibatch_on_the_card_matches_cpu(dev):
    from gdr_tpu_torch.ops.kmeans import kmeans_fit_minibatch
    x = _unit_rows(3000, 64, 2)
    g = torch.Generator().manual_seed(3)
    seed_idx = torch.randperm(3000, generator=g)[:30]
    batch_idx = torch.randint(0, 3000, (25, 1024), generator=g)
    c_cpu, a_cpu = kmeans_fit_minibatch(x, 30, 25, 1024, seed_idx=seed_idx,
                                        batch_idx=batch_idx)
    c_gpu, a_gpu = kmeans_fit_minibatch(x.to(dev), 30, 25, 1024,
                                        seed_idx=seed_idx, batch_idx=batch_idx)
    assert torch.equal(a_gpu.cpu(), a_cpu)
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, atol=1e-4, rtol=0)


def test_hierarchical_kmeans_on_the_card_keeps_its_invariants(dev):
    from gdr_tpu_torch.ops.kmeans import (hierarchical_kmeans,
                                          paths_to_cid_mapping)
    x = _unit_rows(25_000, 64, 4).to(dev)
    paths = hierarchical_kmeans(x, 30, 30, iters=10, minibatch_threshold=1000)
    assert paths == hierarchical_kmeans(x, 30, 30, iters=10,
                                        minibatch_threshold=1000)
    mapping = paths_to_cid_mapping(paths)
    assert sum(len(v) for v in mapping.values()) == 25_000
    assert all(p and max(p) < 30 for p in paths)
    assert all(len(v) <= 30 or k.count("-") == 7 for k, v in mapping.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_doc_tower_on_the_card_matches_cpu(dev, dtype):
    import numpy as np

    from gdr_tpu_torch.index.builder import embed_corpus
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)
    cpu = init_doc_encoder(DocEncoder(tiny_doc_encoder_config()),
                           torch.Generator().manual_seed(0)).to(dtype).eval()
    gpu = DocEncoder(tiny_doc_encoder_config()).to(dtype)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(2, 512, (300, 24), generator=g).int().numpy()
    mask = (torch.arange(24)[None] < torch.randint(3, 25, (300, 1),
                                                   generator=g)).int().numpy()
    got = embed_corpus(gpu, ids, mask, batch_size=64)
    want = embed_corpus(cpu, ids, mask, batch_size=64)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
