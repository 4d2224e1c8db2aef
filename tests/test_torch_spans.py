"""The serving path's spans and host-sync counter (utils/timing.py): under
``torch.profiler`` one ``Evaluator.retrieve`` is a ``gdr.retrieve`` range
holding each stage's range, one ``gdr.decode.step`` (with its forward and
beam selection) per beam step or sampling step and one ``gdr.decode.sync``
per early-exit read; with no profiler ``span`` is one shared no-op and the results are
bit for bit those of a profiled retrieve."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gdr_tpu_torch import kernels
from gdr_tpu_torch.config import EvalConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops import beam
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.utils import timing
from gdr_tpu_torch.utils.timing import PhaseTimer, span
from torch_port_helpers import TINY, queries, small_cid_map

EV = dict(num_beams=10, num_return_sequences=16, max_output_length=5)
MODES = {"beam": {}, "packed": dict(packed=True),
         "decoder_avg": dict(use_query_embed_decoder_avg=True),
         "sample": dict(gen_method="sample")}
STAGES = ("gdr.encode", "gdr.decode.init", "gdr.decode.finalize",
          "gdr.rerank")


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    model = GenerativeRetriever(ModelConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(0))
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    rng = np.random.default_rng(1)
    n = sum(len(v) for v in cid_to_docs.values())
    store = rng.normal(size=(n, TINY["encoder_d_model"])).astype(np.float32)
    ids, mask = queries(rng, 3, 8, TINY["vocab_size"])
    return model.eval(), trie, store, ids, mask, cid_to_docs


def _evaluator(world, mode):
    model, trie, store = world[:3]
    kw = dict(MODES[mode])
    packed = kw.pop("packed", False)
    return Evaluator(model, trie, store, EvalConfig(**EV, **kw),
                     packed=packed)


def _profiled(fn):
    """``fn()``'s result and its trace's ``gdr.`` ranges as (name, start
    ns, end ns), in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gdr.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each range's innermost enclosing range (an index, or None)."""
    out = []
    for i, (_, s, t) in enumerate(spans):
        holders = [j for j, (_, s2, t2) in enumerate(spans)
                   if j != i and s2 <= s and t <= t2
                   and (s2, -t2) < (s, -t)]
        out.append(max(holders, key=lambda j: spans[j][1], default=None))
    return out


def _names(spans, idx):
    return [spans[i][0] for i in idx]


@pytest.mark.parametrize("mode", list(MODES))
def test_retrieve_spans_nest_under_retrieve(world, mode, monkeypatch):
    ev = _evaluator(world, mode)
    ids, mask = world[3], world[4]
    ev.retrieve(ids, mask)                      # the U table, built once
    steps = []
    real_step = beam._beam_step

    def counted(state, pos, step_fn, in_w, *a, **k):
        steps.append((pos, in_w))
        return real_step(state, pos, step_fn, in_w, *a, **k)
    monkeypatch.setattr(beam, "_beam_step", counted)
    kernels.reset_launch_counts()
    _, spans = _profiled(lambda: ev.retrieve(ids, mask))
    syncs = timing.counts()["host_syncs"]

    parents = _parents(spans)
    names = [s[0] for s in spans]
    top = [i for i, p in enumerate(parents) if p is None]
    assert _names(spans, top) == ["gdr.retrieve"]
    root = top[0]
    children = [i for i, p in enumerate(parents) if p == root]
    want = set(STAGES) | {"gdr.decode.step"}
    if mode != "sample":
        want.add("gdr.decode.sync")
    if mode == "decoder_avg":
        want.add("gdr.query")
    assert set(_names(spans, children)) == want
    for stage in STAGES + ("gdr.query",):
        assert names.count(stage) == (stage in want)

    step_idx = [i for i, n in enumerate(names) if n == "gdr.decode.step"]
    n_steps = len(steps)
    assert len(step_idx) == n_steps > 0
    for i in step_idx:
        inner = [j for j, p in enumerate(parents) if p == i]
        assert _names(spans, inner) == ["gdr.decode.forward",
                                        "gdr.beam.select"]
    full = [p for p, w in steps if w == EV["num_beams"]]
    if mode == "sample":        # every position at the samples' width
        assert steps == [(p, EV["num_beams"]) for p in range(ev._max_len)]
        assert syncs == 0
    else:
        early_exit = len(steps) < ev._max_len
        assert len(full) >= 1
        assert names.count("gdr.decode.sync") == syncs \
            == len(full) + early_exit
    assert len(spans) == 1 + len(children) + 2 * n_steps


def test_host_syncs_counter_reads_and_resets(world):
    ev = _evaluator(world, "beam")
    kernels.reset_launch_counts()
    assert timing.counts()["host_syncs"] == 0
    ev.retrieve(world[3], world[4])
    one = timing.counts()["host_syncs"]
    ev.retrieve(world[3], world[4])
    got = timing.counts()
    assert one >= 1 and got["host_syncs"] == 2 * one
    # the launch counts alone are read as before: no sync key, and on the
    # CPU every kernel ran as its plain version
    assert set(kernels.launch_counts()) < set(got)
    assert "host_syncs" not in kernels.launch_counts()
    assert not any(kernels.launch_counts().values())
    kernels.reset_launch_counts()
    assert timing.counts()["host_syncs"] == 0


def test_span_without_profiler_is_one_shared_noop():
    off = span("gdr.retrieve", "rows=3")
    assert off is span("gdr.x") is span("gdr.y", None)
    with off:
        with span("gdr.z"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("gdr.x")
        assert on is not off
        with on:
            pass
    assert span("gdr.x") is off


@pytest.mark.parametrize("mode", ["beam", "decoder_avg"])
def test_profiled_retrieve_is_bitwise_equal(world, mode):
    ev = _evaluator(world, mode)
    ids, mask = world[3], world[4]
    res, rr = ev.retrieve(ids, mask)
    (res_p, rr_p), spans = _profiled(lambda: ev.retrieve(ids, mask))
    assert spans
    for a, b in ((res, res_p), (rr, rr_p)):
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or torch.equal(x, y), f


def test_evaluate_phases_are_spans(world):
    ev = _evaluator(world, "beam")
    ids, mask, cid_to_docs = world[3], world[4], world[5]
    cid_of_doc = {d: c for c, docs in cid_to_docs.items() for d in docs}
    data = EvalData(ids, mask, [["0"], ["3"], ["5"]],
                    [[cid_of_doc[0]], [cid_of_doc[3]], [cid_of_doc[5]]])
    out, spans = _profiled(lambda: ev.evaluate(data, batch_size=2))
    assert {"retrieve_total_s", "retrieve_mean_ms", "decode_host_total_s",
            "decode_host_mean_ms"} <= set(out)
    names = [s[0] for s in spans]
    assert names.count("gdr.eval.retrieve") == 2
    assert names.count("gdr.eval.decode_host") == 2
    parents = _parents(spans)
    for i, n in enumerate(names):
        if n == "gdr.retrieve":
            assert spans[parents[i]][0] == "gdr.eval.retrieve"


def test_phase_timer_counts_a_phase_that_raises():
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with timer.phase("x"):
                raise ValueError
        with timer.phase("x"):
            pass
    assert timer.counts["x"] == 2 and timer.totals["x"] > 0
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("gdr.eval.x") == 2


def test_span_around_a_backward_pass():
    """Training code can open spans as serving does: the range is in the
    trace and the gradients are those of the unmarked step."""
    w = torch.linspace(-1, 1, 12).reshape(3, 4).requires_grad_()
    x = torch.arange(8.0).reshape(2, 4)

    def step():
        w.grad = None
        with span("gdr.train.forward"):
            loss = torch.tanh(x @ w.T).square().sum()
        with span("gdr.train.backward"):
            loss.backward()
        return w.grad.clone()
    want = step()
    got, spans = _profiled(step)
    assert torch.equal(got, want)
    assert [s[0] for s in spans] == ["gdr.train.forward",
                                     "gdr.train.backward"]
