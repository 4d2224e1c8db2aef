"""Trie-constrained beam search over CID space, mirroring
``generate_cids`` / ``beam_search`` of ``gdr_tpu/ops/beam.py``.

- the trie mask is one gather from the packed ``children`` table;
- each beam has only ``kary + 1`` options (its digit continuations plus
  EOS), so the top-k per query runs over ``beams × (kary+1)`` scores;
- finished beams keep their slot with a frozen score and one zero-cost
  "pad" continuation, so finalisation is masking;
- **progressive widening**: step p runs at width min((kary+1)^p, K) — at
  beam 100 / kary 30 the warmup widths are 1 and 31 — and the caches grow
  through the reorder gather;
- early exit: the full-width loop stops once no beam is alive.  The check
  reads ``bool(run.any())`` on the host before each full-width step, a
  sync that drains the stream (span ``gdr.decode.sync``, counted as
  ``host_syncs`` in ``utils/timing.py``'s registry; the reference package
  folds it into a
  device ``while_loop``).  The search is a generator that yields the
  device flag at each such check and takes the host's answer back, so the
  device work between two checks is one piece: :func:`generate_cids` runs
  the pieces eagerly, or on a CUDA device replays each as a CUDA graph
  (``ops/decode_graphs.py``);
- ``accumulate_hidden``: the carry pools each beam's decoder states (sum,
  count, last) and reorders them with the beams, giving the
  ``decoder_avg`` / ``decoder_special`` query reps without re-running the
  decoder over the finished sequences.  The early exit then runs one more
  step while a valid beam's pending input is EOS, so that state enters the
  pool;
- :func:`sample_cids`: constant-width trie-constrained rollouts, drawn as
  ``argmax(dist + g)`` with Gumbel noise ``g`` (:func:`gumbel_noise`) from
  an explicit generator, or noise the caller hands in.  They run through
  the search's loop with a sampling select (:func:`_sample`) in place of
  the beams' (:func:`_select`), every step without a check.

Positions are Python ints, so each step's kernels get ``pos`` as a launch
argument.  ``torch.topk`` and ``lax.top_k`` break ties differently; ties
only occur among dead candidates (all at −1e9), so the valid beams agree
and the slots of invalid ones may differ.

Scores are length-normalised ``cum / gen_len ** length_penalty``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from gdr_tpu_torch.ops.codec import EOS_ID, PAD_ID, TOKEN_OFFSET
from gdr_tpu_torch.utils.timing import count, span

NEG_INF = -1.0e9

# step_fn(cur_token [B·w], cache, pos, width) -> (candidate logits, cache),
# or (candidate logits, decoder state, cache) when the search pools states
StepFn = Callable


@dataclass
class BeamResult:
    sequences: torch.Tensor     # [B, K, L+1] int32 — start, digits, EOS, pad
    scores: torch.Tensor        # [B, K] f32 — length-normalised, sorted desc
    cum_logprobs: torch.Tensor  # [B, K] f32
    nodes: torch.Tensor         # [B, K] int32 — trie node where each beam ended
    valid: torch.Tensor         # [B, K] bool
    # pooled decoder states (accumulate_hidden): the mean over each beam's
    # decoder inputs and the last input's state, [B, K, d] f32
    hid_avg: torch.Tensor | None = None
    hid_last: torch.Tensor | None = None


def _pool_hidden(acc, cur_tok: torch.Tensor, pos: int, hidden: torch.Tensor):
    """Pool this step's decoder state (input ``cur_tok``) into the (sum,
    count, last) accumulator: the start token at position 0, every digit,
    and the EOS input of beams that finished before the last position —
    the positions the teacher-forced re-run masks in."""
    hid_sum, hid_cnt, hid_last = acc
    do = (cur_tok != PAD_ID) | (pos == 0)
    h32 = hidden.float()
    return (hid_sum + torch.where(do[:, None], h32, 0.0),
            hid_cnt + do.to(torch.int32),
            torch.where(do[:, None], h32, hid_last))


def _reorder_cache(cache: dict, src: torch.Tensor) -> dict:
    """Gather cache rows by source beam: ``cross_*`` entries are per query
    and stay; ``tm_*`` entries are time-major [L, rows, ...] (axis 1);
    ``rec_*`` entries are recurrent states that the model's next step reads
    at each row's source itself, so they stay and ``src`` goes to the
    cache as ``rec_src``."""
    out = {}
    for name, x in cache.items():
        if name.startswith(("cross_", "rec_")):
            out[name] = x
        elif name.startswith("tm_"):
            out[name] = x[:, src]
        else:
            out[name] = x[src]
    if any(name.startswith("rec_") for name in cache):
        out["rec_src"] = src.to(torch.int32)
    return out


def _trie_masked(logp, node, children, eos_allowed):
    """The step's candidate log-probs [rows, kary+1] (digits…, EOS) with the
    digits the trie lacks below ``node`` and a disallowed EOS at NEG_INF."""
    ok = torch.cat([children[node] >= 0, eos_allowed[node][:, None]], dim=1)
    return torch.where(ok, logp, NEG_INF)


def _advance(tokens, node, finished, eos_pos, option, pos: int, kary: int,
             children):
    """Every row takes ``option`` (a digit, or ``kary`` for EOS) at ``pos``;
    finished rows emit PAD and stay on their node.  Returns (tokens, node,
    finished, eos_pos, the emitted tokens); ``tokens`` is written in
    place."""
    is_eos = (option == kary) & ~finished
    digit_tok = pos * kary + TOKEN_OFFSET + option
    new_tok = torch.where(finished, PAD_ID,
                          torch.where(is_eos, EOS_ID, digit_tok))
    new_tok = new_tok.to(torch.int32)
    node = torch.where(option < kary,
                       children[node, option.clamp_max(kary - 1)], node)
    node = node.clamp_min(0)             # keep indices safe for dead beams
    eos_pos = torch.where(is_eos, pos, eos_pos).to(torch.int32)
    tokens[:, pos + 1] = new_tok
    return tokens, node, finished | is_eos, eos_pos, new_tok


def _beam_step(state, pos: int, step_fn: StepFn, in_w: int, out_w: int,
               select):
    """One constrained step at ``pos``: the decoder at ``in_w`` rows a
    query, then ``select`` (:func:`_select` or :func:`_sample`, settings
    bound) down to ``out_w``.  With an accumulator in the state (``acc``
    not None), ``step_fn`` also returns the decoder state, which is pooled
    first."""
    cur_tok, acc, cache = state[5:]
    with span("gdr.decode.step", f"pos={pos} width={in_w}"):
        with span("gdr.decode.forward"):
            if acc is not None:
                out, hidden, cache = step_fn(cur_tok, cache, pos, in_w)
            else:
                out, cache = step_fn(cur_tok, cache, pos, in_w)
        with span("gdr.beam.select"):
            if acc is not None:
                acc = _pool_hidden(acc, cur_tok, pos, hidden)
            return select(state[:6] + (acc, cache), out, pos, in_w, out_w)


def _select(state, out, pos: int, in_w: int, out_w: int, *, batch: int,
            kary: int, children, eos_allowed, candidates_mode: bool):
    """The beam search's step after the decoder: the candidates' log-probs,
    the trie mask, the top-k over the beams' options, and the beams, caches
    and pooled states reordered.  ``candidates_mode``: ``out`` holds the
    [rows, kary+1] candidate logits; else full-vocabulary logits [rows, V],
    whose log-softmax is read at the position's digit tokens and EOS."""
    tokens, node, scores, finished, eos_pos, _, acc, cache = state
    n_opt = kary + 1
    logp = torch.log_softmax(out.float(), dim=-1)             # [BK, kary+1]
    if not candidates_mode:                                   # [BK, V]
        first = pos * kary + TOKEN_OFFSET
        logp = torch.cat([logp[:, first:first + kary],
                          logp[:, EOS_ID:EOS_ID + 1]], dim=1)
    cand = _trie_masked(logp, node, children, eos_allowed)
    # finished beams: one zero-cost "pad" continuation in the EOS slot
    frozen = torch.cat([torch.full_like(logp[:, :kary], NEG_INF),
                        torch.zeros_like(logp[:, :1])], dim=1)
    cand = torch.where(finished[:, None], frozen, cand)

    flat = (scores[:, None] + cand).reshape(batch, in_w * n_opt)
    top_scores, top_idx = torch.topk(flat, out_w, dim=1)
    beam_idx = top_idx // n_opt
    option = (top_idx % n_opt).reshape(-1)
    src = (torch.arange(batch, device=flat.device)[:, None] * in_w
           + beam_idx).reshape(-1)

    tokens, node, finished, eos_pos, new_tok = _advance(
        tokens[src], node[src], finished[src], eos_pos[src], option, pos,
        kary, children)
    cache = _reorder_cache(cache, src)
    if acc is not None:
        acc = tuple(a[src] for a in acc)
    scores = top_scores.reshape(-1)
    return tokens, node, scores, finished, eos_pos, new_tok, acc, cache


def _sample(state, out, pos: int, in_w: int, out_w: int, *, kary: int,
            children, eos_allowed, noise, temperature: float, top_k: int):
    """The sampling step after the decoder: each rollout draws its option
    from the trie-masked candidates (:func:`sample_cids`) with
    ``noise[pos]``, and every row stays in its slot."""
    tokens, node, scores, finished, eos_pos, _, acc, cache = state
    logp = torch.log_softmax(out.float(), dim=-1)             # [BK, kary+1]
    cand = _trie_masked(logp, node, children, eos_allowed)
    dist = cand / max(temperature, 1e-6)
    if 0 < top_k < kary + 1:
        # the top_k-th largest value, duplicates counted
        kth = torch.topk(dist, top_k, dim=1).values[:, -1:]
        dist = torch.where(dist >= kth, dist, NEG_INF)
    option = torch.argmax(dist + noise[pos], dim=1)
    # finished rollouts are frozen on the EOS slot: a terminal node may
    # still have children, and a digit would walk past its cluster
    option = torch.where(finished, kary, option)
    step_logp = torch.gather(torch.log_softmax(cand, dim=-1), 1,
                             option[:, None])[:, 0]
    scores = scores + torch.where(finished, 0.0, step_logp)
    tokens, node, finished, eos_pos, new_tok = _advance(
        tokens, node, finished, eos_pos, option, pos, kary, children)
    return tokens, node, scores, finished, eos_pos, new_tok, acc, cache


def _finalize(tokens, node, scores, eos_pos, batch: int, num_beams: int,
              length_penalty: float, acc=None) -> BeamResult:
    gen_len = (eos_pos + 1).float()
    norm = scores / torch.pow(gen_len, length_penalty)
    valid = scores > NEG_INF / 2
    keyed = torch.where(valid, norm, torch.full_like(norm, NEG_INF))
    order = torch.argsort(-keyed.reshape(batch, num_beams), dim=1, stable=True)

    def sort2(x):
        return torch.gather(x.reshape(batch, num_beams), 1, order)

    def sort3(x):
        x = x.reshape(batch, num_beams, -1)
        return torch.gather(x, 1, order[:, :, None].expand(-1, -1,
                                                           x.shape[-1]))

    hid_avg = hid_last = None
    if acc is not None:
        hid_sum, hid_cnt, hid_raw = acc
        hid_avg = sort3(hid_sum / hid_cnt.clamp_min(1)[:, None])
        hid_last = sort3(hid_raw)
    return BeamResult(sequences=sort3(tokens), scores=sort2(norm),
                      cum_logprobs=sort2(scores), nodes=sort2(node),
                      valid=sort2(valid), hid_avg=hid_avg, hid_last=hid_last)


def _new_acc(rows: int, d: int, device):
    """A zero (sum, count, last) accumulator of ``rows`` beams."""
    return (torch.zeros((rows, d), dtype=torch.float32, device=device),
            torch.zeros((rows,), dtype=torch.int32, device=device),
            torch.zeros((rows, d), dtype=torch.float32, device=device))


def warmup_widths(num_beams: int, kary: int, max_len: int) -> list[int]:
    """Beam widths of the warmup steps: 1, kary+1, … capped at K."""
    widths = []
    w = 1
    while w < num_beams and len(widths) < max_len - 1:
        widths.append(w)
        w = min(w * (kary + 1), num_beams)
    return widths


def _search(step_fn: StepFn, cache: dict, batch: int, num_beams: int,
            kary: int, max_len: int, children: torch.Tensor,
            eos_allowed: torch.Tensor, progressive: bool = False,
            accumulate_hidden: int = 0, candidates_mode: bool = True,
            sample=None):
    """The search as a generator: before each full-width step it yields
    (a device bool, whether any beam still runs; the state so far) and is
    sent back whether to take the step.  Returns the last state.

    The steps before the first check run unchecked: the progressive
    warm-up, from one live row a query; without it the search starts at
    ``num_beams`` rows a query with beam 0 live.  ``sample``: a sampling
    select (:func:`_sample`, its settings bound) in place of
    :func:`_select`, and not ``progressive``; then every position is an
    unchecked step at ``num_beams`` rows a query, all live, and nothing is
    yielded."""
    select = sample or partial(_select, batch=batch, kary=kary,
                               children=children, eos_allowed=eos_allowed,
                               candidates_mode=candidates_mode)
    unchecked = []
    if sample is not None:
        unchecked = [(num_beams, num_beams)] * max_len
    elif progressive:
        limit = (kary + 1) ** max(max_len - 1, 0)
        if num_beams > limit:
            raise ValueError(f"progressive=True needs num_beams <= "
                             f"(kary+1)**(max_len-1) = {limit}, got "
                             f"{num_beams}")
        unchecked = [(w, min(w * (kary + 1), num_beams))
                     for w in warmup_widths(num_beams, kary, max_len)]
    dev = children.device
    bk0 = batch * (1 if progressive else num_beams)
    tokens = torch.zeros((bk0, max_len + 1), dtype=torch.int32, device=dev)
    node = torch.zeros((bk0,), dtype=torch.long, device=dev)
    if progressive or sample is not None:
        scores = torch.zeros((bk0,), dtype=torch.float32, device=dev)
    else:   # only beam 0 of each query is live at step 0
        live = torch.arange(bk0, device=dev) % num_beams == 0
        scores = torch.where(live, 0.0, NEG_INF).to(torch.float32)
    finished = torch.zeros((bk0,), dtype=torch.bool, device=dev)
    eos_pos = torch.full((bk0,), max_len - 1, dtype=torch.int32, device=dev)
    cur_tok = torch.full((bk0,), PAD_ID, dtype=torch.int32, device=dev)
    acc = _new_acc(bk0, accumulate_hidden, dev) if accumulate_hidden else None
    state = (tokens, node, scores, finished, eos_pos, cur_tok, acc, cache)

    for pos, (in_w, out_w) in enumerate(unchecked):
        state = _beam_step(state, pos, step_fn, in_w, out_w, select)
    for pos in range(len(unchecked), max_len):
        live = state[2] > NEG_INF / 2
        run = ~state[3] & live
        if acc is not None:
            # beams whose pending input is EOS still owe the pool one state
            run = run | ((state[5] == EOS_ID) & live)
        if not (yield run.any(), state):             # early exit
            break
        state = _beam_step(state, pos, step_fn, num_beams, num_beams, select)
    return state


def alive(flag: torch.Tensor) -> bool:
    """The early exit's read of a flag the search yielded: a host sync."""
    with span("gdr.decode.sync"):
        count("host_syncs")
        return bool(flag)


def drive(steps):
    """Run a search generator eagerly, answering each flag it yields with
    :func:`alive`; returns what the generator returns."""
    try:
        flag, _ = next(steps)
        while True:
            flag, _ = steps.send(alive(flag))
    except StopIteration as stop:
        return stop.value


def _finalized(state, batch: int, num_beams: int,
               length_penalty: float) -> BeamResult:
    tokens, node, scores, finished, eos_pos, _, acc, _ = state
    with span("gdr.decode.finalize"):
        return _finalize(tokens, node.to(torch.int32), scores, eos_pos,
                         batch, num_beams, length_penalty, acc)


def beam_search(step_fn: StepFn, cache: dict, batch: int, num_beams: int,
                kary: int, max_len: int, children: torch.Tensor,
                eos_allowed: torch.Tensor, length_penalty: float = 1.0,
                progressive: bool = False,
                accumulate_hidden: int = 0,
                candidates_mode: bool = True) -> BeamResult:
    """Run the constrained search.  ``children``: int [N, kary] (-1 =
    absent); ``eos_allowed``: bool [N], both on the decode device.
    ``cache`` holds batch·num_beams rows (row b·K+k = query b), or batch
    rows when ``progressive``.  ``accumulate_hidden`` > 0 (the decoder
    width d): ``step_fn`` returns ``(logits, hidden [rows, d], cache)`` and
    the result carries the pooled ``hid_avg`` / ``hid_last``.
    ``candidates_mode=False``: ``step_fn`` returns full-vocabulary logits
    (the hierarchic decoders' step)."""
    state = drive(_search(step_fn, cache, batch, num_beams, kary, max_len,
                          children, eos_allowed, progressive,
                          accumulate_hidden, candidates_mode))
    return _finalized(state, batch, num_beams, length_penalty)


def _decode_cache(model, enc: torch.Tensor, max_len: int, rows_per_query: int,
                  u_table: torch.Tensor | Callable | None,
                  prefix: dict | None = None) -> dict:
    """The decode caches at ``rows_per_query`` rows per query (over the
    prefill's per-query ``prefix`` caches, if any), with the
    efficient PAWA head's U table as the beam-invariant ``cross_ucand``
    entry: ``u_table``, or what it returns when it is a function (a
    caller's cached lookup), built here when that is None.  The slow PAWA
    head has no U table."""
    with span("gdr.decode.init"):
        cache = model.init_cache(enc, max_len, rows_per_query, prefix)
        c = model.cfg
        if c.adaptor_decode and c.adaptor_efficient:
            if callable(u_table):
                u_table = u_table()
            if u_table is None:
                u_table = model.decode_tables(max_len)
            cache["cross_ucand"] = u_table  # beam-invariant: never reordered
        return cache


def _encode(model, input_ids: torch.Tensor, attn_mask: torch.Tensor):
    """(encoder states, query embedding, the prefill's per-query caches)
    of the queries; the span's args give the prefill's rows."""
    with span("gdr.encode", f"rows={input_ids.numel()}"):
        enc, prefix = model.prefill(input_ids, attn_mask)
        return enc, model.query_embedding(enc, attn_mask), prefix


def _decode(model, input_ids, attn_mask, children, eos_allowed,
            num_beams: int, max_len: int, progressive: bool, u_table,
            accumulate_hidden: bool, sample=None):
    """The device work of :func:`generate_cids` (or, with ``sample``, of
    :func:`sample_cids`) as a search generator (:func:`_search`) that
    encodes first; it returns (the last state, the query embedding, the
    encoder states)."""
    batch = input_ids.shape[0]
    enc, query_emb, prefix = _encode(model, input_ids, attn_mask)
    cache = _decode_cache(model, enc, max_len, 1 if progressive else num_beams,
                          u_table, prefix)

    def step_fn(cur_tok, cache, pos, width):
        return model.decode_step_candidates(cur_tok, cache, attn_mask, pos,
                                            width, accumulate_hidden)

    state = yield from _search(step_fn, cache, batch, num_beams,
                               model.cfg.kary, max_len, children, eos_allowed,
                               progressive,
                               model.cfg.d_model if accumulate_hidden else 0,
                               sample=sample)
    return state, query_emb, enc


def generate_cids(model, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                  children: torch.Tensor, eos_allowed: torch.Tensor,
                  num_beams: int, max_len: int, length_penalty: float = 1.0,
                  progressive: bool = True,
                  u_table: torch.Tensor | Callable | None = None,
                  accumulate_hidden: bool = False, graphs=None):
    """Encode the queries once and run the constrained search with
    progressive widening.  ``u_table``: the model's ``decode_tables``
    when it has the efficient PAWA head, or a function that returns them,
    built here when not given (callers that retrieve repeatedly build it
    once per weight set).
    ``accumulate_hidden``: pool the decoder states into the result's
    ``hid_avg`` / ``hid_last``.  ``graphs``: an
    ``ops/decode_graphs.py::DecodeGraphs`` that replays the device work as
    CUDA graphs where it can (a CUDA model in eval mode, autograd off).
    Returns (BeamResult, query embedding [B, d'], encoder states [B, S,
    d]), none of them held by the graphs."""
    if progressive and num_beams > (model.cfg.kary + 1) ** max(max_len - 1, 0):
        progressive = False

    def decode(ids, mask):
        return _decode(model, ids, mask, children, eos_allowed, num_beams,
                       max_len, progressive, u_table, accumulate_hidden)

    if graphs is not None and graphs.engages(model, input_ids):
        if callable(u_table):           # the graphs read it by address
            u_table = u_table()
        state, query_emb, enc = graphs.run(
            model, decode, input_ids, attn_mask, max_len,
            (num_beams, max_len, progressive, accumulate_hidden),
            (children, eos_allowed, u_table))
    else:
        if input_ids.is_cuda:
            count("eager_decodes")
        state, query_emb, enc = drive(decode(input_ids, attn_mask))
    return (_finalized(state, input_ids.shape[0], num_beams, length_penalty),
            query_emb, enc)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, f32 on the generator's
    device, with ``u`` uniform in [tiny, 1) as ``jax.random.gumbel`` draws
    it.  The only source of randomness of :func:`sample_cids`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_cids(model, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                children: torch.Tensor, eos_allowed: torch.Tensor,
                num_samples: int, max_len: int,
                generator: torch.Generator | None = None,
                temperature: float = 1.0, top_k: int = 0,
                length_penalty: float = 1.0, accumulate_hidden: bool = False,
                u_table: torch.Tensor | Callable | None = None,
                noise: torch.Tensor | None = None):
    """Stochastic CID decoding (``gen_method`` ``sample`` / ``top_k``):
    ``num_samples`` independent trie-constrained rollouts per query, at
    that constant width from position 0 over all ``max_len`` steps (no
    early exit, so no host sync).  Each step masks the candidates by the
    trie, divides by ``temperature``, keeps the ``top_k`` largest (ties
    kept, as the reference's sort-based threshold) and draws
    ``argmax(dist + g)`` — the form of ``jax.random.categorical``.
    Finished rollouts stay frozen on the EOS slot.  A rollout's score is the
    log-softmax of the trie-masked model logits, not of the sampling
    distribution; duplicate rollouts are possible.

    ``noise``: Gumbel noise [max_len, B·num_samples, kary+1]; when None it
    is drawn once by :func:`gumbel_noise` from ``generator``.  Returns
    (BeamResult, query embedding, encoder states) like
    :func:`generate_cids`, rollouts sorted by score per query."""
    shape = (max_len, input_ids.shape[0] * num_samples, model.cfg.kary + 1)
    if noise is None:
        if generator is None:
            raise ValueError("sample_cids: needs a generator or noise")
        noise = gumbel_noise(shape, generator)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"sample_cids: noise {tuple(noise.shape)}, need "
                         f"{shape}")
    sample = partial(_sample, kary=model.cfg.kary, children=children,
                     eos_allowed=eos_allowed,
                     noise=noise.to(children.device, torch.float32),
                     temperature=temperature, top_k=top_k)
    state, query_emb, enc = drive(_decode(
        model, input_ids, attn_mask, children, eos_allowed, num_samples,
        max_len, False, u_table, accumulate_hidden, sample))
    return (_finalized(state, input_ids.shape[0], num_samples,
                       length_penalty), query_emb, enc)
