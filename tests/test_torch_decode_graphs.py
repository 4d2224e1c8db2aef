"""A retrieve's decode replayed as a chain of CUDA graphs
(``ops/decode_graphs.py``) against the same decode run eagerly.

On the card (``cuda`` marker; they skip without one): a replayed decode
gives the eager decode's beams, scores, query embedding and encoder states
bit for bit, in f32 and bf16, at batch 1 and 32, with the decoder-pooled
states on and off, on the full trie and on tries whose early exit fires
after the first piece and after the second; so do ``Evaluator.retrieve``'s
doc ids and fused scores, with the same kernel launches counted (the f32
GEMM's by kernel name in a profiler trace).  A
result survives the next replay, an in-place weight update is read by the
next replay, a new U table or parameter tensor captures anew, and a
garbage collection due while a chain captures does not free a dropped
evaluator's graphs inside the capture.

On the CPU: nothing engages a graph; the counter registry's views keep
their keys, a reset zeroes every counter and a capture puts the registry
back as it found it; the rel-bias ids kept on the device give the host ids' bias; and the
chain's pieces, positions and counts, with a stand-in for the CUDA graph
whose capture runs the code and whose replay does nothing; and the cyclic
collector off during each capture, as it was after.

The file imports neither JAX nor the reference package:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graphs.py
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.kernels import experts, kda
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import Evaluator
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.models.t5 import RelativePositionBias, _buckets
from gdr_tpu_torch.ops import decode_graphs
from gdr_tpu_torch.ops.beam import generate_cids
from gdr_tpu_torch.ops.decode_graphs import DecodeGraphs
from gdr_tpu_torch.ops.trie import TrieTensors, build_trie
from gdr_tpu_torch.utils import timing

# the widths the CUDA decoder kernels serve in f32 and bf16
SMALL = dict(kary=4, max_output_length=5, d_model=64, d_kv=16, d_ff=128,
             num_layers=2, num_decoder_layers=2, num_heads=4, vocab_size=512,
             encoder_d_model=64, adaptor_layer_num=1, adaptor_num_heads=2)
BEAMS, SEQ = 12, 10
GRAPH_KEYS = {"graph_captures", "graph_replays", "eager_decodes"}


def _cid_map(depth: int) -> dict[str, list[int]]:
    """Clusters of one depth (3: 24 of them, 2: 12, 1: 4), three docs each.
    Beam 12 widens over positions 0 and 1, so every beam of a depth-1 trie
    has ended when the first piece does, and of a depth-2 trie after the
    second."""
    spans = {1: [4], 2: [4, 3], 3: [4, 3, 2]}[depth]
    cids = [""]
    for n in spans:
        cids = [f"{c}-{d}".lstrip("-") for c in cids for d in range(n)]
    return {c: [3 * i, 3 * i + 1, 3 * i + 2] for i, c in enumerate(cids)}


def _world(dtype, dev, **model_kw):
    model = init_weights(GenerativeRetriever(ModelConfig(**SMALL,
                                                         **model_kw)),
                         torch.Generator().manual_seed(0))
    return model.to(dev, dtype).eval()


def _queries(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, SMALL["vocab_size"], size=(batch, SEQ))
    mask = np.ones_like(ids)
    mask[-1, SEQ - 3:] = 0                  # one query with padding
    return ids.astype(np.int32), mask.astype(np.int32)


def _store(trie: TrieTensors) -> np.ndarray:
    n = int(trie.cluster_docs.max()) + 1
    rng = np.random.default_rng(2)
    store = rng.normal(size=(n, SMALL["encoder_d_model"]))
    return (store / np.linalg.norm(store, axis=1, keepdims=True)
            ).astype(np.float32)


def _counts() -> dict[str, int]:
    return timing.counts()


def _same(a, b) -> None:
    """Two results (tensors, dataclasses of tensors or None, tuples of
    them) are equal bit for bit."""
    if isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _cloned(x):
    if isinstance(x, tuple):
        return tuple(_cloned(v) for v in x)
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{f: _cloned(getattr(x, f))
                          for f in x.__dataclass_fields__})
    return None if x is None else x.clone()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode's CUDA graphs replay "
                    "the port's kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decoder(model, trie, dev, hidden: bool, max_len: int):
    """``generate_cids`` of ``model`` over ``trie`` as a function of the
    token arrays and the graphs, with the trie and U table made once."""
    children = torch.as_tensor(trie.children, device=dev)
    eos = torch.as_tensor(trie.eos_allowed, device=dev)
    table = model.decode_tables(max_len)

    def decode(ids, mask, graphs):
        with torch.no_grad():
            return generate_cids(
                model, torch.as_tensor(ids, device=dev),
                torch.as_tensor(mask, device=dev), children, eos, BEAMS,
                max_len, u_table=table, accumulate_hidden=hidden,
                graphs=graphs)
    return decode


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 2, 1])
@pytest.mark.parametrize("hidden", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replayed_decode_is_the_eager_decode(dev, dtype, batch, hidden,
                                             depth):
    model = _world(dtype, dev)
    trie = build_trie(_cid_map(depth), SMALL["kary"])
    # the full trie's decode runs to its last position; the shallow ones
    # have 5 positions and stop at the check after piece ``depth`` (one
    # piece later with pooled states: their EOS input enters the pool)
    max_len = 4 + hidden if depth == 3 else 5
    decode = _decoder(model, trie, dev, hidden, max_len)
    graphs = DecodeGraphs()
    for seed in (1, 2, 3):          # runs eagerly, captures, replays
        ids, mask = _queries(batch, seed)
        kernels.reset_launch_counts()
        want = decode(ids, mask, None)
        eager = _counts()
        kernels.reset_launch_counts()
        got = decode(ids, mask, graphs)
        replayed = _counts()
        _same(want, got)
        assert eager["eager_decodes"] == 1
        assert eager["graph_captures"] == eager["graph_replays"] == 0
        assert replayed["eager_decodes"] == (seed == 1)
        assert replayed["graph_captures"] == (seed == 2) * (max_len - 1)
        assert replayed["graph_replays"] == (seed > 1) * (depth + hidden)
        assert {k: v for k, v in replayed.items() if k not in GRAPH_KEYS} \
            == {k: v for k, v in eager.items() if k not in GRAPH_KEYS}
        assert replayed["self_attn_sublayer"] == SMALL[
            "num_decoder_layers"] * (depth + hidden + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [False, True])
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replayed_retrieve_is_the_eager_retrieve(dev, dtype, batch, hidden):
    model = _world(dtype, dev)
    trie = build_trie(_cid_map(3), SMALL["kary"])
    cfg = EvalConfig(num_beams=BEAMS, num_return_sequences=20,
                     max_output_length=SMALL["max_output_length"],
                     use_query_embed_decoder_avg=hidden)
    ev = Evaluator(model, trie, _store(trie), cfg, packed=True)
    for seed in (1, 2, 3, 4):
        ids, mask = _queries(batch, seed)
        kernels.reset_launch_counts()
        want = Evaluator(model, trie, _store(trie), cfg,
                         packed=True).retrieve(ids, mask)
        eager = _counts()
        kernels.reset_launch_counts()
        got = ev.retrieve(ids, mask)
        replayed = _counts()
        _same(want, got)
        assert replayed["graph_replays"] == (seed > 1) * (3 + hidden)
        assert replayed["host_syncs"] == eager["host_syncs"] == 2 + hidden
        assert {k: v for k, v in replayed.items() if k not in GRAPH_KEYS} \
            == {k: v for k, v in eager.items() if k not in GRAPH_KEYS}


def _evaluator(dev, model=None):
    model = model or _world(torch.float32, dev)
    trie = build_trie(_cid_map(3), SMALL["kary"])
    cfg = EvalConfig(num_beams=BEAMS, num_return_sequences=20,
                     max_output_length=SMALL["max_output_length"])
    return Evaluator(model, trie, _store(trie), cfg, packed=True), trie, cfg


@pytest.mark.cuda
def test_a_result_survives_the_next_replay(dev):
    ev, _, _ = _evaluator(dev)
    a, b = _queries(8, 1), _queries(8, 2)
    ev.retrieve(*a)
    ev.retrieve(*a)                              # captured
    first = ev.retrieve(*a)
    kept = _cloned(first)
    other = ev.retrieve(*b)
    _same(first, kept)
    assert not torch.equal(other[0].sequences, first[0].sequences)


@pytest.mark.cuda
def test_an_in_place_update_is_read_by_the_next_replay(dev):
    ev, trie, cfg = _evaluator(dev)
    ids, mask = _queries(8, 1)
    ev.retrieve(ids, mask)
    before = ev.retrieve(ids, mask)              # captured
    with torch.no_grad():
        for p in ev.model.decoder.parameters():
            p.mul_(1.5)
    kernels.reset_launch_counts()
    got = ev.retrieve(ids, mask)
    assert _counts()["graph_captures"] == 0
    assert _counts()["graph_replays"] == 3
    want = Evaluator(ev.model, trie, _store(trie), cfg,
                     packed=True).retrieve(ids, mask)
    _same(want, got)
    assert not torch.equal(before[1].scores, got[1].scores)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["u_table", "parameter"])
def test_a_new_tensor_captures_anew(dev, change):
    ev, trie, cfg = _evaluator(dev)
    ids, mask = _queries(8, 1)
    ev.retrieve(ids, mask)
    ev.retrieve(ids, mask)                       # captured
    with torch.no_grad():
        if change == "u_table":     # a new version of U: a new U table
            ev.model.pawa.u.mul_(1.5)
        else:
            ffn = ev.model.decoder.blocks[0].ff.wi
            ffn.weight = torch.nn.Parameter(ffn.weight * 1.5)
    kernels.reset_launch_counts()
    first = ev.retrieve(ids, mask)
    assert _counts()["eager_decodes"] == 1
    second = ev.retrieve(ids, mask)
    assert _counts()["graph_captures"] == 3
    _same(first, second)
    want = Evaluator(ev.model, trie, _store(trie), cfg,
                     packed=True).retrieve(ids, mask)
    _same(want, second)


# ------------------------------------------------------------------- CPU


class _Collecting(torch.cuda.CUDAGraph):
    """A CUDA graph whose capture, once begun, runs the collection that
    falls due there wherever the cyclic collector is on."""

    def capture_begin(self, *a, **k):
        super().capture_begin(*a, **k)
        if gc.isenabled():
            gc.collect()


@pytest.mark.cuda
def test_a_collection_due_mid_capture_frees_no_graph(dev, monkeypatch):
    """A dropped evaluator held in a reference cycle keeps its captured
    chain until the collector runs; CUDA refuses to destroy a graph while
    a stream captures, so the next capture runs no collection."""
    ids, mask = _queries(8, 1)
    threshold = gc.get_threshold()
    gc.set_threshold(10 ** 9)             # no collection but the stand-in's
    try:
        old, _, _ = _evaluator(dev)
        old.retrieve(ids, mask)
        old.retrieve(ids, mask)            # captured
        old.cycle = old                    # only the collector frees it
        del old
        monkeypatch.setattr(torch.cuda, "CUDAGraph", _Collecting)
        ev, _, _ = _evaluator(dev)
        want = ev.retrieve(ids, mask)      # eager
        got = ev.retrieve(ids, mask)       # captured, then replayed
    finally:
        gc.set_threshold(*threshold)
    torch.cuda.synchronize()
    _same(want, got)


def test_the_collector_is_off_while_a_chain_captures(monkeypatch):
    """With the stand-in graph, each capture starts with the cyclic
    collector off, and the collector is as it was once the chain is
    captured."""
    seen = []

    class Recording(_StandIn):
        def capture_begin(self, pool=None):
            seen.append(gc.isenabled())

    for name, value in [("CUDAGraph", Recording),
                        ("graph_pool_handle", lambda: None),
                        ("Stream", lambda device=None: _Stream()),
                        ("current_stream", lambda device=None: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(DecodeGraphs, "engages",
                        staticmethod(lambda model, ids: True))
    cpu = torch.device("cpu")
    decode = _decoder(_world(torch.float32, cpu),
                      build_trie(_cid_map(3), SMALL["kary"]), cpu, False, 4)
    collecting = gc.isenabled()
    try:
        for on in (True, False):
            (gc.enable if on else gc.disable)()
            seen.clear()
            graphs = DecodeGraphs()
            for _ in range(2):                   # eager, then captured
                decode(*_queries(3, 1), graphs)
            assert seen == [False] * 3 and gc.isenabled() == on
    finally:
        (gc.enable if collecting else gc.disable)()


def test_a_cpu_retrieve_engages_no_graph():
    model = _world(torch.float32, torch.device("cpu"))
    ev, _, _ = _evaluator(torch.device("cpu"), model)
    kernels.reset_launch_counts()
    for _ in range(3):
        ev.retrieve(*_queries(2, 1))
    counts = _counts()
    assert {k: counts[k] for k in GRAPH_KEYS} == dict.fromkeys(GRAPH_KEYS, 0)
    assert counts["host_syncs"] == 6
    assert not DecodeGraphs.engages(model, torch.zeros(1))


WRAPPERS = {"self_attn_sublayer", "cross_attn_sublayer", "ffn_sublayer",
            "packed_scores", "packed_scores_int8", "rerank_scores",
            "expert_sublayer", "topk_expert_sublayer", "mla_attention",
            "kda_prefill", "kda_decode"}


def _counting_decode(ids, mask):
    """A search generator of two pieces whose code counts launches as the
    wrappers do: 2 ``ffn_sublayer`` before its check, 1 ``packed_scores``
    after."""
    timing.count("ffn_sublayer", 2)
    yield torch.tensor(True), None
    timing.count("packed_scores")
    return None, ids, mask


@pytest.mark.parametrize("case", ["views", "reset_and_capture"])
def test_the_counter_registry(monkeypatch, case):
    kernels.reset_launch_counts()
    if case == "views":
        # the default view holds exactly the wrappers (the serve drivers'
        # set-up compares that dict exactly); experts=True adds the device
        # counters (routing, KDA's); timing.counts() every host counter
        assert set(kernels.launch_counts()) == WRAPPERS
        assert set(kernels.launch_counts(experts=True)) \
            == WRAPPERS | set(experts.STATS) | set(kda.STATS)
        assert set(_counts()) == WRAPPERS | GRAPH_KEYS | {"host_syncs",
                                                          "kda_state_rows"}
        assert not any(_counts().values())
        timing.count("ffn_sublayer", 2)
        timing.count("graph_replays")
        assert kernels.launch_counts() == {**dict.fromkeys(WRAPPERS, 0),
                                           "ffn_sublayer": 2}
        assert _counts()["graph_replays"] == 1
        kernels.reset_launch_counts()
        return
    # a reset zeroes every group: launches, host counters, device counters
    for name in WRAPPERS | GRAPH_KEYS | {"host_syncs"}:
        timing.count(name, 3)
    experts.stats_tensor(torch.device("cpu")).add_(1)
    kda.stats_tensor(torch.device("cpu")).add_(1)
    kernels.reset_launch_counts()
    assert not any(_counts().values())
    assert not any(kernels.launch_counts(experts=True).values())
    # a capture on the stand-in graph puts the registry back as it found
    # it, keeps each piece's launches and adds them at each replay
    for name, value in [("CUDAGraph", _StandIn),
                        ("graph_pool_handle", lambda: None),
                        ("current_stream", lambda device=None: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, value)
    timing.count("rerank_scores", 5)
    timing.count("host_syncs", 7)
    before = _counts()
    ids, mask = torch.ones(1, 3), torch.ones(1, 3)
    chain = decode_graphs._Chain(_counting_decode, ids, mask, 2, _Stream())
    assert _counts() == {**before, "graph_captures": 2}
    assert [p.launches for p in chain.pieces] == [{"ffn_sublayer": 2},
                                                  {"packed_scores": 1}]
    for i in (1, 2):
        state, query_emb, enc = chain.replay(ids, mask)
        assert state is None and torch.equal(query_emb, ids)
        assert _counts() == {**before, "graph_captures": 2,
                             "graph_replays": 2 * i, "host_syncs": 7 + i,
                             "ffn_sublayer": 2 * i, "packed_scores": i}
    kernels.reset_launch_counts()


def _f32_gemm_launches(fn) -> dict[str, int]:
    """The f32 GEMM's launches by kernel name while ``fn`` runs, read from
    a profiler trace (it sees the kernels a replayed graph launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"gemm_f32_ring_rows": 0, "gemm_f32_ring_ws": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in out:
                if f"gdr::{name}<" in e.key:
                    out[name] += e.count
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32])
def test_replays_count_the_gemm_paths_of_the_eager_decode(dev, batch):
    # a replayed retrieve counts the eager one's launches, and launches
    # the f32 GEMM's kernels as often as the eager one, by name in the trace
    model = _world(torch.float32, dev)
    trie = build_trie(_cid_map(3), SMALL["kary"])
    cfg = EvalConfig(num_beams=BEAMS, num_return_sequences=20,
                     max_output_length=SMALL["max_output_length"])
    ev = Evaluator(model, trie, _store(trie), cfg, packed=True)
    ids, mask = _queries(batch, 1)
    for _ in range(2):                  # eager, capture
        ev.retrieve(ids, mask)
    kernels.reset_launch_counts()
    eager_gemms = _f32_gemm_launches(lambda: Evaluator(
        model, trie, _store(trie), cfg, packed=True).retrieve(ids, mask))
    eager = kernels.launch_counts()
    kernels.reset_launch_counts()
    replayed_gemms = _f32_gemm_launches(lambda: ev.retrieve(ids, mask))
    replayed = _counts()
    assert replayed["graph_replays"] == 3
    assert {k: replayed[k] for k in eager} == eager
    assert replayed_gemms == eager_gemms
    assert sum(eager_gemms.values()) == 2 * (
        eager["self_attn_sublayer"] + eager["cross_attn_sublayer"]
        + eager["ffn_sublayer"]) == 6 * eager["self_attn_sublayer"] > 0


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("qlen, klen, offset", [(1, 5, 0), (1, 5, 4),
                                                (1, 40, 3), (12, 12, 0),
                                                (7, 200, 0), (1, 300, 9)])
def test_device_bucket_ids_give_the_host_ids_bias(qlen, klen, offset,
                                                  bidirectional):
    rb = RelativePositionBias(4, 32, 128, bidirectional)
    with torch.no_grad():
        rb.rel_embedding.normal_(generator=torch.Generator().manual_seed(0))
    ids = _buckets(qlen, klen, offset, bidirectional, 32, 128)
    want = rb.rel_embedding[ids].permute(2, 0, 1)[None]
    got = rb(qlen, klen, offset)
    assert torch.equal(want, got)
    dev = rb.rel_embedding.device
    assert rb.bucket_ids(qlen, klen, offset, dev) \
        is rb.bucket_ids(qlen, klen, offset, dev)


def test_init_cache_puts_every_positions_bias_ids_on_the_device():
    model = _world(torch.float32, torch.device("cpu"))
    dec = model.decoder
    enc = torch.zeros(2, 7, SMALL["d_model"])
    dec.init_cache(2, 5, enc, 3)
    cpu = torch.device("cpu")
    for pos in range(5):
        assert (1, 5, pos, cpu) in dec.rel_bias._ids
        assert (1, 7, pos, cpu) in dec.cross_rel_bias._ids


class _StandIn:
    """A CUDA graph whose capture runs the code and whose replay does
    nothing: a replay then returns what the capture computed."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("hidden", [False, True])
def test_chain_pieces_positions_and_counts_on_the_cpu(monkeypatch, hidden):
    """With the stand-in, captures take every step (the host answers True
    at each check), so replays equal the eager decode where no beam stops
    early: the full trie at the Evaluator's length."""
    for name, value in [("CUDAGraph", _StandIn),
                        ("graph_pool_handle", lambda: None),
                        ("Stream", lambda device=None: _Stream()),
                        ("current_stream", lambda device=None: _Stream()),
                        ("stream", lambda s: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(DecodeGraphs, "engages",
                        staticmethod(lambda model, ids: True))
    cpu = torch.device("cpu")
    model = _world(torch.float32, cpu)
    trie = build_trie(_cid_map(3), SMALL["kary"])
    graphs = DecodeGraphs()
    decode = _decoder(model, trie, cpu, hidden, 4 + hidden)
    ids, mask = _queries(3, 1)
    want = decode(ids, mask, None)
    for i in range(3):
        kernels.reset_launch_counts()
        got = decode(ids, mask, graphs)
        _same(want, got)
        counts = _counts()
        assert counts["eager_decodes"] == (i == 0)
        assert counts["graph_captures"] == (i == 1) * (3 + hidden)
        assert counts["graph_replays"] == (i > 0) * (3 + hidden)
        assert counts["host_syncs"] == 2 + hidden
    (chain,) = graphs._chains.values()
    assert [p.pos for p in chain.pieces] == [0, 2, 3, 4][:3 + hidden]
    assert [p.flag is None for p in chain.pieces] == [False] * (2 + hidden) \
        + [True]
    # the query embedding and encoder states are copies of the pool's
    again = decode(ids, mask, graphs)
    out = chain.pieces[-1].out
    assert again[1].data_ptr() != out[1].data_ptr()
    assert again[2].data_ptr() != out[2].data_ptr()


def test_chains_are_bounded(monkeypatch):
    monkeypatch.setattr(decode_graphs, "_Chain",
                        lambda *a: pytest.fail("a CPU test captured"))
    graphs = DecodeGraphs()
    model = _world(torch.float32, torch.device("cpu"))
    decode = _decoder(model, build_trie(_cid_map(1), SMALL["kary"]),
                      torch.device("cpu"), False, 3)
    monkeypatch.setattr(DecodeGraphs, "engages",
                        staticmethod(lambda model, ids: True))
    for batch in range(1, 2 * decode_graphs.CHAINS + 1):
        decode(*_queries(batch, 1), graphs)
    assert len(graphs._chains) == decode_graphs.CHAINS
    assert [k[0][0] for k in graphs._chains] == list(
        range(decode_graphs.CHAINS + 1, 2 * decode_graphs.CHAINS + 1))
