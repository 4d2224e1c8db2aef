#!/usr/bin/env python3
"""Smoke test of gdr_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, is right and serves retrieval on the card.

    python3 chip_smoke.py [profile]   # from the repository root, one CUDA device

Every phase always runs; ``profile`` adds a torch.profiler table of one
full-width retrieve in phase 4, of each mode in phase 5, in phase 6 of
one doc-tower batch per dtype and one k-means recursion, in phase 7 of
one full-width train step, and in phase 8 of one query-generation batch
and one hierarchic decode + re-rank.  Any other
argument is refused.

Phases (each prints its elapsed seconds; any failure exits non-zero before
the last line):

1. device — the card's name and power limit (nvidia-smi) and the nvcc build
   of every kernel under ``gdr_tpu_torch/csrc`` (one nvcc per source, all
   at once), naming each function that ptxas gives a stack frame or
   spills, then the host C++ library (``gdr_tpu_torch/native.py``);
2. kernel vs plain — each kernel against its plain PyTorch version on the
   card: the decoder sublayers at the row counts the main path gives them
   (32, 992 and 3,200 rows of t5-base: 32 queries × widths 1, 31, 100, at
   positions 0, 1 and 3) and at the shapes the other options give them
   (3,200 rows at position 0, and at position 4 of a 5-position cache)
   and query generation gives them (320 and 3,200 rows, one beam each
   over a 64-token doc, at position 39 of a 40-position cache, the self
   core's streaming path; timed there in both dtypes) in bf16 and f32;
   the three re-rank scorers at 32 and 3,200
   beams, each beam with its own query row (the packed scorer also with
   one row per query), over stores of the operating point's size (the packed
   bf16 / f32 store, the int8 packed store with the query in bf16 and f32,
   the plain bf16 / f32 store with candidates from the bench trie's padded
   cluster table).  Device times (CUDA-graph replay) beside the plain
   version's, a library yardstick and the bound: the decoder sublayers at
   each row count and summed per retrieve (6·t32 + 6·t992 + 12·t3200), their
   GEMM alone at its four (N, K) shapes at each row count against
   torch.matmul, each in bf16 and in f32 (no TF32: the f32 bound is at 67
   TFLOP/s, the yardstick at "highest" precision), and the scorers at
   3,200 rows.  The GEMM shapes and the FFN rows print the plan the
   dtype's cost model gave them (tile, ring stages, splits, units and
   blocks).  In f32 also at one query a retrieve, serve-b1's rows (1, 31
   and 100 at positions 0, 1 and 3), where the f32 GEMM takes its small-row
   kernel: the sublayers held to plain and timed 20 calls a graph, per
   retrieve (6·t1 + 6·t31 + 12·t100), and the GEMM alone at its four
   shapes, each call of a graph reading its own copy of W, beside
   torch.matmul and the bound, with the plan's kernel (rows or ring).
   Last, the routed-expert sublayer (``expert_sublayer``, the
   four ``gdr::moe_`` kernels) at Switch-Base-128's widths (128 experts,
   d 768, d_ff 3,072, capacity 64) and the Switch cell's calls: a query's
   40 encoder tokens as one sequence, then decode steps of 1, 31 and 100
   beam rows over counts of earlier tokens: the same experts, kept rows,
   counts and routing counters as the plain version, router logits within
   1e-4 and outputs within 2e-5 (no TF32); its device time, the plain
   version's wall time (it reads the experts hit back to the host, so no
   graph holds it) and the bound of the experts it hit, at each row count
   and summed per retrieve (6·t40 + 3·t1 + 3·t31 + 6·t100).  Then
   Moonlight-16B-A3B's top-k experts (``topk_expert_sublayer``, five
   ``gdr::moe_`` kernels: 64 experts, d 2,048, d_ff 1,408, top-6) and MLA
   decode (``mla_attention``, ``gdr::mla_decode``: 16 heads, a 40-position
   prefix) at serve-b1-moonlight's calls (40 prefill rows, then 1, 31 and
   100 beam rows): held to their plain versions within 2e-5, timed beside
   them and their bounds, their launches counted by kernel name in a
   profiler trace, and summed over one layer's calls a retrieve; and the
   f32 GEMM at the stack's eight shapes and those row counts (the
   chooser's plan, the fastest small-row plan, the bound).  Then Kimi
   Linear's KDA kernels (``kda_prefill``, ``kda_decode``: 32 heads of 128,
   4 taps) at serve-b1-kimi-linear's calls (the prefill of one query of 40
   positions, 14 real; the decode steps at 1 row from the prefix state, 31
   and 100 rows from a step's random sources, 100 from the last 100):
   held to their plain versions within 3e-5 in the output and, of a
   decode step, the new state and window it writes (its buffers filled
   with NaN first), their device counters of one call checked (the
   distinct source rows, the real tokens), timed beside them and their
   bounds (``costs_kimi_linear.py``: each source row read once), their
   launches counted by name;
3. whole path, small — a small f32 model retrieves on the CPU (plain
   versions) and on the card (kernels) from the same seeded weights, on
   the four store layouts (plain, packed, plain int8, packed int8): valid
   doc ids equal, fused scores within 1e-4, int8 stores bit-equal,
   ``evaluate`` metrics equal; then, on the plain and packed layouts, the
   other options of a retrieve: decoder_avg query reps with average
   fusion, decoder_special with concate fusion, top_k sampling (the Gumbel
   noise drawn once on the CPU and given to both runs) and the slow PAWA
   head, each with valid doc ids equal and fused scores within 1e-4; last,
   the small model with a routed FFN in every other layer (8 experts,
   capacity 2, so the encoder drops tokens) on the packed layout, twice
   (the second retrieve replays the decode's CUDA graphs): valid doc ids
   equal, fused scores within 1e-4, the routing counters equal on the CPU
   and the card, and the card's launches of one retrieve (the expert
   kernels once a sparse layer and step); last, Moonlight-16B-A3B at its
   published widths (MLA 512 / 128 / 64 / 128 over 16 heads, 64 top-6
   experts and 2 shared, vocabulary 163,840) cut to 1 dense + 2 expert
   layers, with the benchmark's weight scales, on the packed layout over
   the small trie, on the CPU and twice on the card in the same way: the
   same checks, the smallest k-th / (k+1)-th selection-score gap of the
   CPU's routing printed beside them, and the card's launches of one
   retrieve (``mla_attention`` at every layer a step,
   ``topk_expert_sublayer`` at every expert layer for the prefill and a
   step); then Kimi-Linear-48B-A3B at its published widths (d 2,304, KDA
   32 heads of 128, NoPE MLA, card 0's 32 of 256 experts top-8, 1 shared)
   cut to one period, KDA with the dense FFN, two KDA and one MLA layer,
   in the same way: the routing and KDA's device counters (source rows,
   prefill tokens) equal on the CPU and the card, and the card's launches
   of one retrieve counted after a reset (``kda_prefill`` a KDA layer,
   ``kda_decode`` a KDA layer a step, ``mla_attention`` a step,
   ``topk_expert_sublayer`` at every expert layer for the prefill and a
   step);
4. whole path, full width — ``Evaluator.retrieve`` with t5-base in bf16
   (seeded random weights), beam 100, top-R 100, 32 queries × 40 tokens,
   over a 334,314-doc store in three layouts (packed bf16, plain bf16,
   packed int8): per layout the exact launch counts of one retrieve (24 per
   decoder kernel, 1 of the layout's scorer, 0 of the others), valid beams
   and doc ids, then timed retrieves; plain bf16 must return packed bf16's
   top documents, and packed int8's store size and top-1 agreement with
   packed bf16 are printed; then the model and store in f32, as ``cli
   retrieve --packed`` serves them (packed f32: 24 launches of each decoder
   kernel, one packed scorer; the f32 GEMM's launches by kernel, 36 on the
   small-row kernel at step 0's 32 rows and 108 on the warp-specialised
   ring), timed
   over 3 retrieves after a warm one, with its peak; then one query a
   retrieve, as serve-b1 sends (all 144 f32 GEMM launches on the small-row
   kernel, none on the ring), timed;
5. the other options at full width — on the packed bf16 layout, four
   modes of ``Evaluator.retrieve``: (a) beam + decoder_avg + average
   fusion, (b) beam + decoder_special + concate fusion (one t5-base model
   with the fusion layer), (c) top_k sampling (temperature 1.0, top-k 10,
   100 rollouts, seed 0) and (d) beam with the slow PAWA head (a second
   model): per mode the exact launch counts of one retrieve (30 per
   decoder kernel in (a) and (b), whose pooled reps take a fifth step; 24
   in (c) and (d); one packed scorer), 3,200 valid beams or rollouts, top-R
   valid doc ids, finite scores, then timed retrieves and peak memory; the
   default path's decode on the same model beside (a)'s, and the slow
   head's transform alone at 3,200 rows;
6. index build and expansion — IndexConfig's defaults (kary 30, leaf cap
   30, 25 iterations, minibatch at >= 1,000 points with batch 1,024, seed
   7): (a) a tiny f32 doc tower with seeded weights embeds 2,000 docs on
   the CPU and the card (within 1e-4) and Lloyd from one CPU-drawn init
   runs on both (assignments equal, centroids within 1e-4); the CLI's
   ``index`` → ``expand`` (+200 docs) → ``retrieve`` run as subprocesses on
   the card over a 2,000-doc TSV; (b) the BERT-base tower embeds 4,096 docs
   in f32 and 32,768 docs × 128 tokens in bf16 at batch 512: docs/s and
   the time between CUDA events beside the FLOPs bound; (c) hierarchical
   k-means of phase 4's 334,314 × 768 unit store, twice, then the
   recursion alone (its share of the build): seconds, nodes,
   clusters, leaves by depth, the largest leaf, and the checks that every
   doc has a path of digits < 30 and every leaf above depth 8 at most 30
   docs; (d) a t5-base bf16 retrieve over that index's packed bf16 layout:
   launches 6 × the steps taken (at most 6 · (depth + 1)) per decoder
   kernel and one packed scorer, valid beams and doc ids, retrieve ms; (e)
   2,048 new unit rows inserted: insert seconds, the trie's structure
   unchanged, each new id in one cluster (the best by node embedding), old
   CIDs unchanged, the packed layout rebuilt with its grown cap, the packed
   scorer on each new doc's block (its own row the query) giving it the
   block's top score and matching its plain version, and a retrieve over
   the grown store;
7. training — (a) a small f32 model with every loss on (denoising, both
   distillations, hard negatives) takes 3 stage-1 and 2 stage-2 steps (a
   tiny live doc tower) on the CPU and on the card from the same weights
   and batches, TF32 off, dropout 0: losses and grad norm within 1e-4
   relative at each step, f32 masters within 1e-5 after them (the doc
   tower's attention key biases, whose gradient is zero and so rounding
   noise, within Adam's 2 × Σ lr); (b) t5-base
   (376.1M parameters, bf16 over f32 masters) at TrainConfig's defaults:
   batch 64 (128 rows after R-Drop) × 40 tokens, 11 candidates from phase
   4's store, labels from the bench trie, dropout 0.1, input dropout 0.5,
   R-Drop 0.1 Contrast: 3 warm and 20 timed steps (step ms, examples/s,
   peak GiB, the bound from the shapes), then 30 steps on one batch, whose
   loss must fall; (c) stage 2 with the BERT-base tower at batch 32 (384
   docs × 128 tokens per step): 3 warm and 5 timed steps, peak GiB; (d)
   ``TrainLoop`` at full width for one epoch of 512 queries (8 steps) and
   its eval of 32 queries over the packed f32 store (the launches of one
   retrieve: 24 per decoder kernel, one packed scorer), its two checkpoint
   saves timed and sized; at small size on the card two epochs in one run
   equal one epoch and a resumed one bit for bit (dropout on), and a
   mid-epoch stop resumes by running that epoch again; the CLI's ``train``
   → ``eval`` as subprocesses on the card over phase 6's 2,000-doc index,
   ``eval`` reading the trained ``params.npz``.  ``profile`` adds the
   device busy share and kernel families of one full-width step;
8. the secondary modes and query generation — (a) a small f32 world on
   the CPU and the card from the same weights: ``generate_queries``
   tokens from one Gumbel draw over a 40-position cache equal, one
   ensemble step (N = 2, R-Drop 0.1, dropout 0) and its eval, hierarchic
   decode + re-rank, the classifier's logits and one step, within 1e-4;
   (b) ``generate_queries`` at t5-base in f32, as ``cli qg`` runs it:
   64 docs × 64 tokens, 5 queries each (320 rows), top-k 10, 40 steps:
   240 launches of each decoder kernel, time, row-steps/s, peak; then
   the same in bf16 beside it; (c) the ensemble at t5-base
   (3 members, f32, R-Drop 0.1): its two extra k-means assignments of
   phase 4's store on the card, 2 warm + 5 timed steps at batch 64, peak,
   then ``eval_ensemble`` of 32 queries × 40 tokens at beam 100 over each
   member's own trie and the plain store (one ``rerank_scores`` per
   member, 6 × steps of each decoder kernel; every member's beams and doc
   ids checked); (d) the hierarchic mode at t5-base over the bench trie
   (3 decoder stacks): timed steps, then decode + re-rank of 32 queries at
   beam 100 (one ``rerank_scores``); (e) the softmax classifier over the
   bench trie's 11,144 clusters: timed steps and the top-100 ranking of 32
   queries; (f) the CLI on the card over phase 6's index: ``qg`` →
   ``train --qg`` and ``train --ensemble 2`` → ``eval --ensemble 2``;
9. pretrained starts and ingest — checkpoint directories in HuggingFace's
   layout, written by hand with seeded weights (config.json without the
   fields at their class defaults): (a) a small T5 (bf16 safetensors) and
   BERT (pytorch_model.bin) load through ``models/convert.py`` on the CPU
   and on the card, bit-equal to each other and to the files' tensors; the
   tower's CLS rows on the card within 1e-4 of the CPU's; a seeded state
   dict under the reference fork's names through ``load_gdr_reference``
   into phase 3's small model, retrieving on the packed layout on the card
   (through the kernels) as on the CPU: valid doc ids equal, fused scores
   within 1e-4; (b) a t5-base encoder directory (safetensors f32, shared
   [32128, 768]) and a BERT-base one (pytorch_model.bin f32), each with a
   WordPiece vocab.txt of its vocabulary's size (the tokenizer where
   transformers is installed): their bytes
   and load seconds (read + map + move to the card), then the warm-started
   t5-base in f32 over phase 4's packed f32 store: the exact launches of
   one retrieve (24 per decoder kernel, one packed scorer), 3,200 valid
   beams, 3 timed retrieves after a warm one, peak; (c) the CLI on the card
   as subprocesses: ``ingest`` of ``tests/fixtures/nq_tiny_*.jsonl.gz``
   (12 docs, 24 train, 6 dev) → ``index --bert-ckpt`` → ``train --t5-ckpt
   --bert-ckpt`` (one epoch, stage 2 with the live BERT-base tower) →
   ``eval`` of the trained ``params.npz``: every step exits 0, the counts
   printed are right, the metrics finite; each process's seconds;
10. serving over a sharded store — four ranks share the one card over
   ``gloo`` (NCCL refuses two ranks on one device), or take one card each
   over ``nccl`` on a machine of four or more cards; spawned processes
   that each send their launch counts, times and peak back: (a) phase 3's
   small f32 model, ``Evaluator(mesh=)`` at dp=4 and dp=2 × mp=2 on the
   plain, packed and packed int8 layouts, on the card and on the CPU:
   every rank's merged result equals the one-device retrieve (valid doc
   ids equal, fused scores within 1e-5), and each card rank launches its
   layout's scorer once and the decoder kernels as often as the one-card
   retrieve; (b) t5-base in f32 as ``cli retrieve`` serves it, over phase
   4's store (written once, memory-mapped by the ranks) on packed f32,
   plain f32 and packed int8 at dp=4: per rank the store bytes it holds,
   the launches of one retrieve (24 per decoder kernel, one scorer), 3
   timed retrieves after a warm one beside the one-card ones, the merge
   alone and the peak; the merged result equal to the one-card retrieve;
   (c) the CLI under ``torch.distributed.run`` with ``nccl``, one rank per
   card: ``retrieve --packed --mesh N`` and ``eval --packed --mesh N``
   over phase 6's index print what the unsharded runs print;
11. training over a mesh — the same four ranks (gloo on one card, nccl a
   card each on four): (a) phase 3's small f32 model from seeded weights,
   ``TrainLoop(mesh=)`` at dp=4 and dp=2 × mp=2, plain and packed eval, two
   epochs of ``gdr_tpu``'s own mesh-test world (input dropout on, module
   dropout 0): each rank's step losses within 1e-5 (relative) of the
   one-card loop's, its masters (mp column slices at 2 × 2) within 1e-5
   after each epoch (up to 0.1% of elements, Adam's rounding-level steps,
   within one step), recall1 equal, each epoch's eval launching the decoder
   kernels as often as the one-card eval and the layout's scorer once a
   retrieve on its shard; the one-card loop against the CPU's (losses
   within 1e-4 relative, recall1 equal); (b) t5-base at TrainConfig's
   defaults (batch 64 global, bf16 over f32 masters, dropout 0.1, R-Drop
   0.1 Contrast, 11 candidates from phase 4's store, written once and
   memory-mapped, a quarter of its rows a rank) at dp=2 × mp=2: 1 warm and
   2 timed steps a rank, the gradient all-reduce alone, peak GiB, the
   bytes of masters and moments held beside one process's, the store rows
   held; losses and grad norms finite and equal on every rank;
12. one JSON line ``{"kernels": [...]}`` with each kernel's launches on its
   layout's main path (and over phase 6's built index, in phase 7's
   TrainLoop eval, in phase 8's query generation, ensemble eval and
   hierarchic eval, in phase 9's warm-started retrieve, per rank in
   phase 10's sharded retrieves and per rank in phase 11's mesh
   TrainLoop eval), max |Δ|, kernel / plain / library ms and its bound
   (the decoder rows also by row count, per retrieve, per GEMM shape and
   at query generation's shape, in f32 at one query a retrieve too, and the
   f32 GEMM's launches by kernel in phase 4's f32 retrieves of 32 queries
   and of one); the expert rows give their launches on
   phase 4's dense main path (0) and in phase 3's small Switch or
   Moonlight retrieve, and their phase-2 numbers at 100 rows, by row count
   and per retrieve; the KDA rows (``kda_prefill``, ``kda_decode``) their
   launches on phase 4's path (0) and in phase 3's small Kimi Linear
   retrieve, and their phase-2 numbers by call.

The last line is ``{"ok": true, "device": {...}}``.  The script imports
torch, numpy and gdr_tpu_torch only (its phases 6 to 10 also run the
port's CLI in subprocesses).  Files go to one temporary directory, removed
at the end.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from statistics import fmean

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12       # outside the tensor cores
H100_BYTES = 3.35e12         # HBM3
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-5)}   # atol, rtol

# t5-base at the serving operating point
D, H, DKV, DFF, S, B = 768, 12, 64, 3072, 40, 32
WIDTHS = (1, 31, 100)
CAP = 32
N_DOCS = 334_314             # the bench's NQ-scale corpus
PACKED_ROWS = 356_632        # its packed layout (8-aligned blocks, cap 32)
PACKED_ROWS_INT8 = 356_640   # its int8 packed layout (32-aligned blocks)
# the decode steps of one retrieve: width → the step's position, and how
# many sublayer calls of each kind run at that width (6 decoder layers; the
# width-100 step runs twice, at positions 2 and 3)
POS_OF_WIDTH = {1: 0, 31: 1, 100: 3}
RETRIEVE_WEIGHT = {1: 6, 31: 6, 100: 12}
# (position, cache length) of the other retrieve options at 3,200 rows:
# sampling starts at full width at position 0; pooled decoder reps take a
# fifth step, position 4 of a 5-position cache
OPTION_POS_LMAX = ((0, 4), (4, 5))
# query generation (phase 8): a 40-position self-attention cache (the
# streaming path of the self core), 64 docs x 64 tokens x 5 queries = 320
# rows, each its own query (one beam); phase 2 holds the sublayers at that
# shape at the last position, and also at 3,200 rows
QG_L, QG_ROWS = 40, (320, 3200)
QG_DOCS, QG_DOC_LEN, QG_PER_DOC = 64, 64, 5
DECODER = ("self_attn_sublayer", "cross_attn_sublayer", "ffn_sublayer")
# the GEMM's (N, K) shapes on the main path, with the epilogue each gets
GEMM_SHAPES = ((3 * D, D, "round"), (D, D, "residual"), (DFF, D, "relu"),
               (D, DFF, "residual"))
DECODER_GEMMS = {"self_attn_sublayer": {(3 * D, D), (D, D)},
                 "cross_attn_sublayer": {(D, D)},
                 "ffn_sublayer": {(DFF, D), (D, DFF)}}
# Switch-Base-128's routed FFN at serve-b1-switch128's calls, one query a
# retrieve: (rows, sequence length) of the encoder's 40 tokens, then of the
# decode steps at widths 1, 31 and 100 (one token a beam row), and how many
# calls of each a retrieve makes (6 sparse encoder layers; 3 sparse decoder
# layers a step, the width-100 step twice)
SW_EXPERTS, SW_CAPACITY = 128, 64
SW_CALLS = ((S, S), (1, 1), (31, 1), (100, 1))
SW_WEIGHT = {S: 6, 1: 3, 31: 3, 100: 6}
# router logits ~N(0, 28²) and outputs ~1: f32 sums of 768 and 3,072
# products in another order than cuBLAS's differ by a few ulps, TF32 by 1e-3
SW_TOL = {"logits": 1e-4, "out": 2e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def _time_ms(fn, n: int = 20) -> float:
    """Device ms of one call of ``fn``: the call is captured once in a CUDA
    graph and the graph replayed ``n`` times between CUDA events, so the
    wrappers' host-side work (checks, allocation, ctypes) is not timed."""
    return _time_each_ms(lambda i: fn(), calls=1, n=n)


def _time_each_ms(fn, calls: int = 20, n: int = 10) -> float:
    """Device ms of one call of ``fn(i)``: ``fn(0)`` ... ``fn(calls - 1)``
    captured back to back in one CUDA graph, as the replayed decode runs its
    kernels, and the graph replayed ``n`` times between CUDA events (a graph
    of one call of a few us is paced by the host's graph launches)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                                   # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * calls)


def _timed(fn, warm: int, timed: int) -> list[float]:
    """Wall ms of ``timed`` calls of ``fn`` after ``warm`` ones, each
    between two synchronisations."""
    import torch
    for _ in range(warm):
        fn()
    out = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def _bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decoder_cost(name: str, r: int, pos: int, lmax: int, el: int,
                 queries: int = B, enc_len: int = S) -> tuple[float, float]:
    """FLOPs and the bytes a decoder sublayer must move at r rows: each
    input read once (x, weights, the cache rows at positions < pos, the
    ``queries``' encoder K/V of ``enc_len`` tokens, biases, norm scale) and
    each output written once (x', the new K/V row)."""
    inner = H * DKV
    if name == "self_attn_sublayer":
        flops = 2 * r * D * 3 * inner + 2 * r * inner * D \
            + 2 * 2 * r * H * (pos + 1) * DKV
        nbytes = (2 * r * D + 4 * inner * D) * el + 2 * pos * r * inner * el \
            + 2 * r * inner * el + lmax * H * 4 + D * 4
    elif name == "cross_attn_sublayer":
        flops = 2 * 2 * r * D * inner + 2 * 2 * r * H * enc_len * DKV
        nbytes = (2 * r * D + 2 * inner * D) * el \
            + 2 * queries * H * enc_len * DKV * el \
            + queries * H * enc_len * 4 + D * 4
    else:
        flops = 2 * 2 * r * D * DFF
        nbytes = (2 * r * D + 2 * D * DFF) * el + D * 4
    return flops, nbytes


def core_bytes(name: str, r: int, pos: int, el: int, queries: int = B,
               enc_len: int = S) -> float:
    """The bytes an attention core alone must move at r rows: the
    self-attention core reads q/k/v and the cache rows at positions < pos
    and writes the attention output and the new K/V row; the
    cross-attention core reads q and the queries' encoder K/V and bias and
    writes its output."""
    inner = H * DKV
    if name == "self_attn_sublayer":
        return (3 * r * inner + 2 * pos * r * inner + 3 * r * inner) * el \
            + 4 * H * 4
    return (2 * r * inner + 2 * queries * H * enc_len * DKV) * el \
        + queries * H * enc_len * 4


def plan_kind(plan) -> str:
    """The kernel a GEMM plan runs: the f32 small-row kernel ("rows"), the
    warp-specialised f32 ring ("ring_ws") or the bf16 wgmma GEMM
    ("wgmma")."""
    return ("wgmma", "rows", "ring_ws")[plan.kernel]


def plan_text(plan) -> str:
    """A GEMM plan as phase 2 prints it: kernel, tile, ring, splits (the
    small-row kernel's: blocks a cluster), blocks."""
    if plan_kind(plan) == "rows":
        return (f"rows: {plan.rows}x{plan.bn} strips, {plan.stages} stages, "
                f"clusters of {plan.splits}, {plan.blocks} blocks")
    return (f"{plan_kind(plan)}: {plan.rows}x{plan.bn} tile, {plan.stages} "
            f"stages, {plan.splits} split{'s' if plan.splits > 1 else ''}, "
            f"{plan.units} units on {plan.blocks} blocks")


def _close(name, got, want, dtype_name) -> float:
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    bad = diff > atol + rtol * want.float().abs()
    if bad.any() or not bool(got.float().isfinite().all()):
        raise Failed(f"{name}: max |d| {err:.3g} breaches atol {atol} + "
                     f"rtol {rtol}·|plain| at {int(bad.sum())} elements")
    return err


def sublayers_vs_plain(rn, stats: dict, r: int, beams: int, pos: int,
                       lmax: int, dtype, enc_len: int = S):
    """The three decoder sublayers at r rows (``beams`` per query, so
    r / beams queries, each with ``enc_len`` encoder positions) and
    position ``pos`` of an ``lmax``-position cache, on random t5-base
    inputs from ``rn``, each held to its plain version: logs the max |d|,
    folds it into ``stats[name]["err"]`` and returns the inputs."""
    import types

    import torch

    from gdr_tpu_torch.kernels import decode as KD

    dn = str(dtype).split(".")[-1]
    queries = r // beams
    at = f"{dn} R={r} pos {pos} L {lmax} S {enc_len}"
    x = rn(r, D, dtype=dtype)
    scale = (1 + rn(D, std=0.1)).to(dtype)
    wqkv = rn(3 * D, D, std=0.02, dtype=dtype)
    wo = rn(D, D, std=0.02, dtype=dtype)
    bias_row = rn(lmax, H, std=0.5)
    ck, cv = rn(lmax, r, D, dtype=dtype), rn(lmax, r, D, dtype=dtype)
    ck2, cv2 = ck.clone(), cv.clone()
    got, ck, cv = KD.self_attn_sublayer(
        x, pos, scale, wqkv, wo, bias_row, ck, cv, heads=H, d_kv=DKV)
    want, ck2, cv2 = KD.self_attn_sublayer_plain(
        x, pos, scale, wqkv, wo, bias_row, ck2, cv2, heads=H, d_kv=DKV)
    e_self = max(_close(f"self_attn {at}", got, want, dn),
                 _close(f"self_attn K cache {at}", ck, ck2, dn),
                 _close(f"self_attn V cache {at}", cv, cv2, dn))

    wcq = rn(D, D, std=0.02, dtype=dtype)
    wco = rn(D, D, std=0.02, dtype=dtype)
    cross_k = rn(queries, H, enc_len, DKV, dtype=dtype)
    cross_v = rn(queries, H, enc_len, DKV, dtype=dtype)
    cbias = rn(queries, H, enc_len, std=0.5)
    cbias[:, :, enc_len - 8:] += -1e9                    # padded key positions
    got = KD.cross_attn_sublayer(x, scale, wcq, wco, cross_k, cross_v, cbias,
                                 beams, heads=H, d_kv=DKV)
    want = KD.cross_attn_sublayer_plain(x, scale, wcq, wco, cross_k, cross_v,
                                        cbias, beams, heads=H, d_kv=DKV)
    e_cross = _close(f"cross_attn {at}", got, want, dn)

    wi = rn(DFF, D, std=0.02, dtype=dtype)
    wo2 = rn(D, DFF, std=0.02, dtype=dtype)
    got = KD.ffn_sublayer(x, scale, wi, wo2)
    want = KD.ffn_sublayer_plain(x, scale, wi, wo2)
    e_ffn = _close(f"ffn {at}", got, want, dn)
    torch.cuda.synchronize()
    atol, rtol = TOL[dn]
    log(f"  {dn:8s} R={r:5d} beams {beams} pos {pos} L {lmax} S {enc_len}  "
        f"max|d| self {e_self:.3g}  cross {e_cross:.3g}  ffn {e_ffn:.3g}  "
        f"(tol {atol} + {rtol}·|plain|)")
    for name, e in zip(DECODER, (e_self, e_cross, e_ffn)):
        stats[name]["err"] = max(stats[name].get("err", 0.0), e)
    return types.SimpleNamespace(
        dn=dn, beams=beams, x=x, scale=scale, wqkv=wqkv, wo=wo, bias_row=bias_row, ck=ck,
        cv=cv, ck2=ck2, cv2=cv2, wcq=wcq, wco=wco, cross_k=cross_k,
        cross_v=cross_v, cbias=cbias, wi=wi, wo2=wo2)


def sublayer_calls(c, pos: int) -> dict:
    """name → (kernel, plain, library) calls of the three sublayers on the
    inputs ``c`` of :func:`sublayers_vs_plain` at position ``pos``; the
    library call is the sublayer's two GEMMs through torch.matmul, with no
    attention core."""
    import torch

    from gdr_tpu_torch.kernels import decode as KD

    x, scale = c.x, c.scale
    attn_in = torch.empty_like(x)
    hid = x.new_empty(x.shape[0], DFF)
    return {
        "self_attn_sublayer": (
            lambda: KD.self_attn_sublayer(
                x, pos, scale, c.wqkv, c.wo, c.bias_row, c.ck, c.cv,
                heads=H, d_kv=DKV),
            lambda: KD.self_attn_sublayer_plain(
                x, pos, scale, c.wqkv, c.wo, c.bias_row, c.ck2, c.cv2,
                heads=H, d_kv=DKV),
            lambda: (x @ c.wqkv.t(), attn_in @ c.wo.t())),
        "cross_attn_sublayer": (
            lambda: KD.cross_attn_sublayer(
                x, scale, c.wcq, c.wco, c.cross_k, c.cross_v, c.cbias,
                c.beams, heads=H, d_kv=DKV),
            lambda: KD.cross_attn_sublayer_plain(
                x, scale, c.wcq, c.wco, c.cross_k, c.cross_v, c.cbias,
                c.beams, heads=H, d_kv=DKV),
            lambda: (x @ c.wcq.t(), attn_in @ c.wco.t())),
        "ffn_sublayer": (
            lambda: KD.ffn_sublayer(x, scale, c.wi, c.wo2),
            lambda: KD.ffn_sublayer_plain(x, scale, c.wi, c.wo2),
            lambda: (x @ c.wi.t(), hid @ c.wo2.t())),
    }


# ------------------------------------------------------------ phase 2

GEMM_CALLS = 20             # calls a timed graph of the GEMM alone at b1's rows


def f32_one_query(rn, stats: dict, lmax: int, dev) -> None:
    """The f32 sublayers and GEMM at one query a retrieve, serve-b1's rows
    (1 / 31 / 100 at positions 0 / 1 / 3, where the GEMM takes its small-row
    kernel), each held to its plain version at the f32 tolerance.  Device
    ms: a sublayer 20 calls a graph on one set of weights (warm in L2); the
    GEMM 20 calls a graph, each reading its own copy of W (from HBM, as the
    decode's layers read theirs), beside f32 torch.matmul the same way and
    the bound.  Adds to ``stats[name]``: ``rows_f32_b1`` (by rows),
    ``per_retrieve_f32_b1`` (6·t1 + 6·t31 + 12·t100) and ``gemms_f32_b1``
    (its GEMM shapes, with the plan's kernel)."""
    import torch

    from gdr_tpu_torch.kernels import decode as KD

    gemms = []
    for w in WIDTHS:
        r, pos = w, POS_OF_WIDTH[w]
        c = sublayers_vs_plain(rn, stats, r, w, pos, lmax, torch.float32)
        for name, (kern, plain, lib) in sublayer_calls(c, pos).items():
            flops, nbytes = decoder_cost(name, r, pos, lmax, 4, queries=1)
            bound, by = _bound_ms(flops, nbytes, H100_F32_FLOPS)
            row = stats[name].setdefault("rows_f32_b1", {})[r] = dict(
                ms=_time_each_ms(lambda i: kern()),
                plain_ms=_time_ms(plain, n=5),
                library_ms=_time_each_ms(lambda i: lib()), bound_ms=bound,
                bound_by=by, flops=flops, bytes=nbytes, pos=pos)
            log(f"  {name:20s} float32  R={r:5d} one query (pos {pos}): "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"library {row['library_ms']:.4f} ms, bound {bound:.4f} ms "
                f"({by})")
        for n, k, epi in GEMM_SHAPES:
            a = rn(r, k)
            wt = rn(n, k, std=k ** -0.5)
            wts = [wt] + [wt.clone() for _ in range(GEMM_CALLS - 1)]
            kw = (dict(resid=rn(r, n)) if epi == "residual"
                  else dict(scale=c.scale))            # norm GEMMs read x [r, D]
            err = _close(f"gemm float32 {epi} M={r} N={n} K={k} (one query)",
                         KD.gemm(a, wt, epi, **kw),
                         KD.gemm_plain(a, wt, epi, **kw), "float32")
            nbytes = (r * k + n * k + r * n * (2 if epi == "residual" else 1)
                      ) * 4
            bound, by = _bound_ms(2 * r * n * k, nbytes, H100_F32_FLOPS)
            plan = KD.gemm_plan(r, n, k, dev, torch.float32)
            g_ = dict(
                m=r, n=n, k=k, epi=epi, dtype="float32", max_abs_err=err,
                ms=_time_each_ms(lambda i: KD.gemm(a, wts[i], epi, **kw),
                                 GEMM_CALLS),
                matmul_ms=_time_each_ms(lambda i: a @ wts[i].t(), GEMM_CALLS),
                bound_ms=bound, bound_by=by, kind=plan_kind(plan),
                plan=plan_text(plan))
            gemms.append(g_)
            log(f"  gemm float32  {epi:8s} M={r:5d} N={n:5d} K={k:5d} (one "
                f"query, W from HBM): {g_['ms']:.4f} ms, torch.matmul "
                f"{g_['matmul_ms']:.4f} ms, bound {bound:.4f} ms ({by}); "
                f"max|d| {err:.3g}; plan {g_['plan']}")
            del wts
    for name in DECODER:
        st = stats[name]
        st["per_retrieve_f32_b1"] = pr = {
            key: sum(RETRIEVE_WEIGHT[w] * st["rows_f32_b1"][w][key]
                     for w in WIDTHS)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        st["gemms_f32_b1"] = [g_ for g_ in gemms
                              if (g_["n"], g_["k"]) in DECODER_GEMMS[name]]
        log(f"  {name:20s} float32  one query, per retrieve (6·t1 + 6·t31 + "
            f"12·t100): kernel {pr['ms']:.4f} ms, plain {pr['plain_ms']:.4f} "
            f"ms, library {pr['library_ms']:.4f} ms, bound "
            f"{pr['bound_ms']:.4f} ms")
    # a layer's step runs the 768 x 768 product three times (self O, cross
    # Q, cross O), timed with the residual epilogue
    per = {key: sum(RETRIEVE_WEIGHT[g_["m"]] * g_[key]
                    * (3 if (g_["n"], g_["k"]) == (D, D) else 1)
                    for g_ in gemms)
           for key in ("ms", "matmul_ms", "bound_ms")}
    log(f"  gemm float32  one query, per retrieve (the 144 launches: 6 "
        f"layers x 4 steps x QKV, O, cross Q, cross O, wi, wo): "
        f"{per['ms']:.4f} ms, torch.matmul {per['matmul_ms']:.4f} ms, bound "
        f"{per['bound_ms']:.4f} ms; kernels "
        f"{sorted({g_['kind'] for g_ in gemms})}")


def expert_cost(stats: dict) -> tuple[float, float]:
    """FLOPs and the bytes the routed-expert calls that the routing
    counters ``stats`` count must move: the router [E, d] and norm scale a
    call, each expert hit (wi and wo, 2·d·d_ff f32) once, each row in and
    out; 2·d·E FLOPs a row in the router and 4·d·d_ff a kept row."""
    rows, kept = stats["moe_rows"], stats["moe_rows"] - stats["moe_dropped"]
    flops = 2 * rows * D * SW_EXPERTS + 4 * kept * D * DFF
    nbytes = (stats["moe_experts_hit"] * 2 * D * DFF
              + stats["moe_calls"] * (SW_EXPERTS * D + D) + rows * 2 * D) * 4
    return float(flops), float(nbytes)


# Moonlight-16B-A3B's top-k experts and MLA decode at serve-b1-moonlight's
# calls: the prefill's 40 rows, then the steps at widths 1, 31 and 100
# (26 expert layers and 27 MLA layers a call; the width-100 step twice)
ML_D, ML_F, ML_E, ML_K, ML_HEADS = 2048, 1408, 64, 6, 16
ML_ROWS = (40, 1, 31, 100)
ML_WEIGHT = {40: 1, 1: 1, 31: 1, 100: 2}
# the kernels of each, counted by name in a profiler trace of one call
ML_KERNELS = {"topk_expert_sublayer": (
    "moe_router", "moe_topk_group", "moe_swiglu_up", "moe_topk_down",
    "moe_combine"), "mla_attention": ("mla_decode",)}


# Kimi Linear's KDA calls at serve-b1-kimi-linear's: (rows, step, input
# rows); step None is the prefill of one query of 40 positions (14 real);
# the beam steps read random source rows of their inputs
KL = dict(kda_layers=list(range(1, 21)), kda_num_heads=32, kda_head_dim=128,
          kda_conv_size=4, d_model=2304, kary=30)
KL_CALLS = ((40, None, 1), (1, 0, 1), (31, 1, 1), (100, 2, 31),
            (100, 3, 100))
KL_REAL = 14
KDA_TOL = 3e-5


def kda_vs_plain(rn) -> dict:
    """``kda_prefill`` and ``kda_decode`` on the card against their plain
    versions at the cell's calls (``KL_CALLS``): the output, and of the
    decode the new state and window written to their buffers, each within
    ``KDA_TOL``; timed (the kernel replayed in a graph, the plain version
    on the card) beside their bounds (``costs_kimi_linear``: each distinct
    source row read once, the prefill's real tokens), with the device
    counters of one call and the launches by kernel name."""
    import torch

    from gdrbench import costs_kimi_linear as CK
    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.kernels import kda as KK

    h, k = KL["kda_num_heads"], KL["kda_head_dim"]
    w = (rn(h * k, k, std=0.02), rn(h * k, k, std=0.02),
         rn(3 * h * k, 4, std=0.3), 1 + rn(h, std=0.3),
         rn(h * k, std=0.5) - 4.0, 1 + rn(k, std=0.1))
    out = {"by_call": {}, "err": 0.0}
    for rows, pos, n_in in KL_CALLS:
        qkv, fgb = rn(rows, 3 * h * k), rn(rows, 2 * k + h)
        if pos is None:
            lens = torch.tensor([KL_REAL], dtype=torch.int32, device="cuda")
            kern = lambda: KK.kda_prefill(                 # noqa: E731
                qkv, fgb, *w, lens, batch=1, heads=h, eps=1e-5)
            plain = lambda: KK.kda_prefill_plain(          # noqa: E731
                qkv, fgb, *w, lens, batch=1, heads=h, eps=1e-5)
            flops, nbytes = CK.kda_prefill_cost(KL, 1, KL_REAL)
            name, key, sources = "kda_prefill", "prefill", None
        else:
            s_in = rn(n_in, h, k, k, std=0.1)
            c_in = rn(n_in, 3, 3 * h * k)
            src = (None if pos == 0 else torch.randint(
                0, n_in, (rows,), device="cuda", dtype=torch.int32))
            sources = n_in if src is None else int(src.unique().numel())
            s_out, c_out = torch.empty(rows, h, k, k, device="cuda"), \
                torch.empty(rows, 3, 3 * h * k, device="cuda")
            s_want, c_want = torch.empty_like(s_out), torch.empty_like(c_out)
            kern = lambda: (KK.kda_decode(                 # noqa: E731
                qkv, fgb, *w, s_in, c_in, src, s_out, c_out, heads=h,
                eps=1e-5), s_out, c_out)
            plain = lambda: (KK.kda_decode_plain(          # noqa: E731
                qkv, fgb, *w, s_in, c_in, src, s_want, c_want, heads=h,
                eps=1e-5), s_want, c_want)
            flops, nbytes = CK.kda_decode_cost(KL, rows, sources)
            name, key = "kda_decode", f"R={rows} step {pos}"
        if pos is not None:     # a row the kernel leaves unwritten fails
            s_out.fill_(float("nan"))
            c_out.fill_(float("nan"))
        kernels.reset_launch_counts()
        got = kern()
        counted = {n: v for n, v in kernels.launch_counts(experts=True).items()
                   if n in KK.STATS}
        want = plain()
        err = max(float(torch.nan_to_num((a - b).abs().max(), nan=math.inf))
                  for a, b in zip(got, want))
        if not err < KDA_TOL:
            raise Failed(f"{name} {key}: max |d| {err:.3g} over the output"
                         f"{'' if pos is None else ', state and window'}")
        if counted != ({"kda_source_rows": 0, "kda_prefill_tokens": KL_REAL}
                       if pos is None else
                       {"kda_source_rows": sources, "kda_prefill_tokens": 0}):
            raise Failed(f"{name} {key}: device counters {counted}")
        bound, by = _bound_ms(flops, nbytes, H100_F32_FLOPS)
        row = out["by_call"][key] = dict(
            ms=_time_ms(kern), plain_ms=_time_ms(plain, n=5), bound_ms=bound,
            bound_by=by, flops=flops, bytes=nbytes, max_abs_err=err,
            sources=sources, launches=_launches_by_name(kern, (name,)))
        row["share_of_bound"] = bound / row["ms"]
        out["err"] = max(out["err"], err)
        read = (f"{KL_REAL} real tokens" if pos is None
                else f"{sources} source rows")
        log(f"  {name:12s} float32  {key:14s}: max|d| {err:.3g}; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {100 * row['share_of_bound']:.1f}%; "
            f"{read}); launches {row['launches']}")
    layers = len(KL["kda_layers"])
    out["per_retrieve"] = {
        key: layers * sum(r[key] for r in out["by_call"].values())
        for key in ("ms", "plain_ms", "bound_ms")}
    log(f"  KDA at these calls x {layers} layers: kernels "
        f"{out['per_retrieve']['ms']:.3f} ms, plain "
        f"{out['per_retrieve']['plain_ms']:.3f} ms, bound "
        f"{out['per_retrieve']['bound_ms']:.3f} ms")
    return out


# the top-k products alone, timed at forced rows an expert: 60 experts of
# 64 hit with n rows each (10·n rows at top-6)
ML_FORCED = (1, 4, 8, 16)
ML_PRODUCTS = ("moe_swiglu_up", "moe_topk_down")


def forced_rows(loads, k: int, experts: int) -> list[list[int]]:
    """Rows of ``k`` distinct experts each (ascending) in which expert i
    takes ``loads[i]`` rows: as many rows as the loads need (at least the
    largest load), the slots left over spread over the experts past
    ``len(loads)``, one or two rows each; the largest remaining loads go
    first, row by row."""
    rows = max(max(loads), -(-sum(loads) // k))
    left = dict(enumerate(loads))
    extra, spare = rows * k - sum(loads), experts - len(loads)
    if extra > 2 * spare or max(loads) > rows or k > experts:
        raise ValueError(f"loads {loads} at top-{k} of {experts} experts")
    for i in range(extra):
        e = len(loads) + i % spare
        left[e] = left.get(e, 0) + 1
    out = []
    for _ in range(rows):
        pick = sorted(left, key=lambda e: (-left[e], e))[:k]
        for e in pick:
            left[e] -= 1
            if not left[e]:
                del left[e]
        out.append(sorted(pick))
    return out


def forced_inputs(rows, d: int, experts: int, gen, device):
    """x [R, d] and a router [E, d] under which row r's top-k experts
    (sigmoid of the logit plus a bias of ~1e-2) are ``rows[r]``: router row
    e the unit vector of coordinate e (d ≥ E), x noise of 0.3 plus 4 at the
    row's experts' coordinates and −4 at the other experts', so that the
    chosen experts' sigmoids lie near 1 and the others' near 0 (d 768-2,048:
    logits ~±5)."""
    import torch
    x = 0.3 * torch.randn(len(rows), d, generator=gen, device=device)
    x[:, :experts] -= 4.0
    for r, es in enumerate(rows):
        x[r, es] += 8.0
    router = torch.zeros(experts, d, device=device)
    router[torch.arange(experts), torch.arange(experts)] = 1.0
    return x, router


def _kernel_ms(fn, names, n: int = 10) -> dict:
    """Device ms a launch of each ``gdr::<name>`` kernel over ``n`` calls of
    ``fn`` (after one), from a torch.profiler trace."""
    fn()
    got = _kernels_by_name(fn, names, n)
    return {name: us / 1e3 / max(count, 1) for name, (count, us) in got.items()}


def _products(kern, st) -> dict:
    """The two top-k products' device ms a call (``_kernel_ms``), each
    against its bytes (the hit experts' wi, then wo, at 3.35 TB/s), and the
    rows a chunk (``moe_assignments / moe_chunks`` of the call's counters
    ``st``)."""
    ms = _kernel_ms(kern, ML_PRODUCTS)
    nbytes = {"moe_swiglu_up": st["moe_experts_hit"] * 2 * ML_F * ML_D * 4,
              "moe_topk_down": st["moe_experts_hit"] * ML_D * ML_F * 4}
    chunks = st.get("moe_chunks")      # a checkout before the counter: None
    out = {"rows_a_chunk": st["moe_assignments"] / chunks if chunks else None}
    for name in ML_PRODUCTS:
        bound = nbytes[name] / H100_BYTES * 1e3
        out[name] = dict(ms=ms[name], bound_ms=bound,
                         bytes_share=bound / ms[name] if ms[name] else None)
    return out


def _kernels_by_name(fn, names, calls: int = 1) -> dict:
    """(launches, device µs) of each ``gdr::<name>`` kernel while ``fn``
    runs ``calls`` times, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, (0, 0.0))
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, (count, us) in out.items():
                if f"gdr::{name}(" in e.key or f"gdr::{name}<" in e.key:
                    out[name] = (count + e.count,
                                 us + e.self_device_time_total)
    return out


def _launches_by_name(fn, names) -> dict:
    """The launches of ``gdr::<name>`` kernels while ``fn`` runs."""
    return {name: count
            for name, (count, _) in _kernels_by_name(fn, names).items()}


def moonlight_vs_plain(rn) -> dict:
    """``topk_expert_sublayer`` and ``mla_attention`` on the card against
    their plain versions at Moonlight's widths and serve-b1-moonlight's
    calls (``ML_ROWS``), then timed, with their launches by kernel name;
    returns their ``stats`` entries (the numbers at 100 rows, step 3 for
    MLA; ``by_rows``; ``per_retrieve`` over one layer's calls)."""
    import torch

    from gdrbench import costs_moonlight
    from gdr_tpu_torch.kernels import experts as KE
    from gdr_tpu_torch.kernels import mla as KM

    m = dict(d_model=ML_D, moe_d_ff=ML_F, num_experts=ML_E, num_heads=ML_HEADS,
             qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
             kv_lora_rank=512)
    scale = 1 + rn(ML_D, std=0.1)
    router, bias = rn(ML_E, ML_D, std=0.02), rn(ML_E, std=0.01)
    wi, wo = rn(ML_E, 2 * ML_F, ML_D, std=0.02), rn(ML_E, ML_D, ML_F, std=0.02)
    inv = KM.rope_inv_freq(64, 50000.0, "cuda")
    out = {}
    for name in ML_KERNELS:
        out[name] = dict(by_rows={}, err=0.0)
    for r in ML_ROWS:
        x = rn(r, ML_D)
        z = torch.empty(r, ML_E, device=x.device)
        route = torch.empty(r, ML_K, dtype=torch.int32, device=x.device)
        kw = dict(k=ML_K, scale=2.446, eps=1e-5)
        kern = lambda: KE.topk_expert_sublayer(       # noqa: E731
            x, x, scale, router, bias, wi, wo, **kw)
        got = KE.topk_expert_sublayer(x, x, scale, router, bias, wi, wo,
                                      route=route, logits=z, **kw)
        # the plain version held to the card's choice (a near tie of two
        # f32 sums may go either way)
        lift = bias[None].repeat(r, 1).scatter_add_(
            1, route.long(), torch.full(route.shape, 10.0, device=x.device))
        plain = lambda: KE.topk_expert_sublayer_plain(  # noqa: E731
            x, x, scale, router, lift, wi, wo, **kw)
        err = (got - plain()).abs().max().item()
        if not err < 2e-5:
            raise Failed(f"topk_expert_sublayer R={r}: max |d| {err:.3g}")
        KE.reset_stats()
        launches = _launches_by_name(kern, ML_KERNELS["topk_expert_sublayer"])
        st = dict(zip(KE.STATS, KE.stats_tensor(x.device).tolist()))
        flops, nbytes = costs_moonlight.topk_expert_cost(m, st)
        bound, by = _bound_ms(flops, nbytes, H100_F32_FLOPS)
        row = out["topk_expert_sublayer"]["by_rows"][r] = dict(
            ms=_time_ms(kern), plain_ms=fmean(_timed(plain, 1, 3)),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
            experts_hit=st["moe_experts_hit"], max_load=st["moe_max_load"],
            max_abs_err=err, launches=launches, **_products(kern, st))
        out["topk_expert_sublayer"]["err"] = max(
            out["topk_expert_sublayer"]["err"], err)
        log(f"  topk_expert_sublayer float32 R={r:4d}: {row['experts_hit']} "
            f"experts hit (most {row['max_load']}), max|d| {err:.3g}; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms (wall), "
            f"bound {bound:.4f} ms ({by}); launches {launches}")
        _log_products(row)
        w = r if r != 40 else 1                    # the prefill: no MLA call
        if r == 40:
            continue
        pos = {1: 0, 31: 1, 100: 3}[r]
        args = (rn(w, ML_HEADS * 192), rn(w, 576), rn(w, ML_HEADS * 256),
                rn(1, ML_HEADS, 40, 192), rn(1, ML_HEADS, 40, 128),
                torch.where(torch.arange(40, device="cuda") < 14, 0.0,
                            -1e9)[None].float(),
                torch.tensor([14], dtype=torch.int32, device="cuda"),
                rn(4, w, ML_HEADS, 192), rn(4, w, ML_HEADS, 128))
        kern = lambda: KM.mla_attention(*args, pos, inv, w,  # noqa: E731
                                        scale=192 ** -0.5)
        plain = lambda: KM.mla_attention_plain(  # noqa: E731
            *args[:7], args[7].clone(), args[8].clone(), pos, inv, w,
            scale=192 ** -0.5)
        err = (kern() - plain()).abs().max().item()
        if not err < 2e-5:
            raise Failed(f"mla_attention R={w} pos {pos}: max |d| {err:.3g}")
        flops, nbytes = costs_moonlight.mla_cost(m, 1, w, pos, 40)
        bound, by = _bound_ms(flops, nbytes, H100_F32_FLOPS)
        launches = _launches_by_name(kern, ML_KERNELS["mla_attention"])
        row = out["mla_attention"]["by_rows"][w] = dict(
            ms=_time_ms(kern), plain_ms=_time_ms(plain, n=5), bound_ms=bound,
            bound_by=by, flops=flops, bytes=nbytes, pos=pos, max_abs_err=err,
            launches=launches)
        out["mla_attention"]["err"] = max(out["mla_attention"]["err"], err)
        log(f"  mla_attention      float32  R={w:4d} pos {pos}: max|d| "
            f"{err:.3g}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"launches {launches}")
    out["topk_expert_sublayer"]["forced"] = _forced_products(
        rn, scale, bias, wi, wo)
    for name, st in out.items():
        rows = st["by_rows"]
        st["per_retrieve"] = {key: sum(ML_WEIGHT[r] * rows[r][key]
                                       for r in rows)
                              for key in ("ms", "plain_ms", "bound_ms")}
        st.update({k: rows[100][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "flops", "bytes")})
        log(f"  {name:20s} float32  one layer's calls a retrieve: kernel "
            f"{st['per_retrieve']['ms']:.4f} ms, plain "
            f"{st['per_retrieve']['plain_ms']:.4f} ms, bound "
            f"{st['per_retrieve']['bound_ms']:.4f} ms")
    KE.reset_stats()
    return out


def _log_products(row) -> None:
    log(f"    rows a chunk {row['rows_a_chunk']}; " + "; ".join(
        f"{n[4:]} {row[n]['ms']:.4f} ms, {100 * row[n]['bytes_share']:.1f}% "
        f"of its bytes' rate" for n in ML_PRODUCTS))


def _forced_products(rn, scale, bias, wi, wo) -> dict:
    """The top-k sublayer at ``ML_FORCED`` rows an expert (60 experts hit,
    ``forced_rows``): against the plain version held to the same experts,
    then its two products timed (``_products``)."""
    import torch

    from gdr_tpu_torch.kernels import experts as KE

    out = {}
    g = torch.Generator(device="cuda").manual_seed(11)
    for n in ML_FORCED:
        rows = forced_rows([n] * 60, ML_K, ML_E)
        x, router = forced_inputs(rows, ML_D, ML_E, g, "cuda")
        kw = dict(k=ML_K, scale=2.446, eps=1e-5)
        route = torch.empty(len(rows), ML_K, dtype=torch.int32, device="cuda")
        z = torch.empty(len(rows), ML_E, device="cuda")
        kern = lambda: KE.topk_expert_sublayer(       # noqa: E731
            x, x, scale, router, bias, wi, wo, **kw)
        got = KE.topk_expert_sublayer(x, x, scale, router, bias, wi, wo,
                                      route=route, logits=z, **kw)
        if route.tolist() != rows:
            r = next(i for i, es in enumerate(route.tolist()) if es != rows[i])
            raise Failed(f"topk_expert_sublayer forced {n} rows an expert: "
                         f"row {r} took {route[r].tolist()}, not {rows[r]}; "
                         f"its logits {z[r].tolist()}")
        lift = bias[None].repeat(len(rows), 1).scatter_add_(
            1, route.long(), torch.full(route.shape, 10.0, device="cuda"))
        err = (got - KE.topk_expert_sublayer_plain(
            x, x, scale, router, lift, wi, wo, **kw)).abs().max().item()
        if not err < 2e-5:
            raise Failed(f"topk_expert_sublayer forced {n} rows an expert: "
                         f"max |d| {err:.3g}")
        KE.reset_stats()
        kern()
        st = dict(zip(KE.STATS, KE.stats_tensor(x.device).tolist()))
        row = out[n] = dict(rows=len(rows), ms=_time_ms(kern),
                            max_abs_err=err, **_products(kern, st))
        log(f"  topk_expert_sublayer float32 {n:2d} rows an expert "
            f"(R={len(rows)}): max|d| {err:.3g}; kernel {row['ms']:.4f} ms")
        _log_products(row)
    KE.reset_stats()
    return out


# the stack's f32 GEMM shapes (N, K, epilogue) and their launches a
# retrieve at each of ML_ROWS' row counts: q, kv_a, kv_b and o at 27
# layers, the shared experts at 26, the dense FFN at 1
ML_GEMMS = ((3072, 2048, "round", 27), (576, 2048, "round", 27),
            (4096, 512, "round", 27), (2048, 2048, "residual", 27),
            (5632, 2048, "round", 26), (2048, 2816, "residual", 26),
            (22528, 2048, "round", 1), (2048, 11264, "residual", 1))


def moonlight_gemms(rn) -> dict:
    """The f32 GEMM at the Moonlight stack's shapes and serve-b1-moonlight's
    row counts: the chooser's plan, the fastest plan of the small-row
    kernel's strips and clusters (4 stages), each call of a graph reading
    its own copy of W (at least 120 MB of copies, past the L2), and the
    bound; summed per retrieve."""
    import math

    import torch

    from gdr_tpu_torch.kernels import decode as kd

    rows, per = [], dict(ms=0.0, best_ms=0.0, bound_ms=0.0)
    for n, k, epi, layers in ML_GEMMS:
        copies = max(2, math.ceil(120e6 / (4 * n * k)))
        ws = [rn(n, k, std=k ** -0.5) for _ in range(copies)]
        for m in ML_ROWS:
            a = rn(m, k)
            kw = (dict(resid=rn(m, n)) if epi == "residual"
                  else dict(scale=1 + rn(k, std=0.1)))

            def ms(plan=None):
                return _time_each_ms(lambda i: kd.gemm(
                    a, ws[i % copies], epi, plan=plan, **kw), calls=copies)
            plan = kd.gemm_plan(m, n, k, "cuda", torch.float32)
            got = ms()
            best = min(ms(kd.rows_plan(m, n, bn, cl))
                       for bn in (48, 64) for cl in (1, 2, 3, 4, 6, 8)
                       if cl <= -(-k // 32))
            bound = 1e3 * max(4.0 * (m * k + n * k + 2 * m * n) / 3.35e12,
                              2.0 * m * n * k / 67e12)
            w_ = ML_WEIGHT[m] * layers
            per["ms"] += w_ * got
            per["best_ms"] += w_ * best
            per["bound_ms"] += w_ * bound
            rows.append(dict(m=m, n=n, k=k, ms=got, best_ms=best,
                             bound_ms=bound, plan=plan._asdict()))
            log(f"  gemm float32 {m:3d} x {n:5d} x {k:5d} {epi:8s}: chooser "
                f"{got * 1e3:7.1f} us (bn {plan.bn}, cluster {plan.splits}), "
                f"best plan {best * 1e3:7.1f} us, bound {bound * 1e3:6.1f} us")
        del ws
    log(f"  gemm float32  the stack's launches a retrieve: chooser "
        f"{per['ms']:.3f} ms, best plans {per['best_ms']:.3f} ms, bound "
        f"{per['bound_ms']:.3f} ms")
    return dict(rows=rows, per_retrieve=per)


def experts_vs_plain(rn) -> dict:
    """``expert_sublayer`` on the card against its plain version at the
    Switch cell's calls (``SW_CALLS``), then timed; returns its ``stats``
    entry (the numbers at 100 rows, ``by_rows``, ``per_retrieve``)."""
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.kernels import experts as KE

    scale = 1 + rn(D, std=0.1)
    router = rn(SW_EXPERTS, D)                 # transformers' N(0, 1)
    wi = rn(SW_EXPERTS, DFF, D, std=0.02)
    wo = rn(SW_EXPERTS, D, DFF, std=0.02)

    def routing() -> dict:
        return {k: v for k, v in kernels.launch_counts(experts=True).items()
                if k.startswith("moe_")}

    by_rows, errs = {}, []
    for r, seq in SW_CALLS:
        x = rn(r, D)
        # a decode step's counts: each beam row's earlier tokens an expert
        counts = None if seq > 1 else \
            (rn(r, SW_EXPERTS).abs() * 1.5).to(torch.int32)
        got = {}
        for side, fn in (("kernel", KE.expert_sublayer),
                         ("plain", KE.expert_sublayer_plain)):
            c = None if counts is None else counts.clone()
            z = torch.empty(r, SW_EXPERTS, device=x.device)
            kernels.reset_launch_counts()
            out = fn(x, scale, router, wi, wo, capacity=SW_CAPACITY,
                     seq_len=seq, counts=c, logits=z)
            torch.cuda.synchronize()
            got[side] = (out, z, c, routing(),
                         kernels.launch_counts()["expert_sublayer"])
        (out_k, z_k, c_k, st_k, n_k), (out_p, z_p, c_p, st_p, n_p) = \
            got["kernel"], got["plain"]
        tag = f"expert_sublayer R={r} seq {seq}"
        if (n_k, n_p) != (1, 0):
            raise Failed(f"{tag}: {n_k} kernel launches and {n_p} by the "
                         f"plain version, want 1 and 0")
        if st_k != st_p or st_k["moe_rows"] != r:
            raise Failed(f"{tag}: routing counters {st_k} on the card, "
                         f"{st_p} plain")
        if not torch.equal(z_k.argmax(1), z_p.argmax(1)) or (
                counts is not None and not torch.equal(c_k, c_p)):
            raise Failed(f"{tag}: experts or counts differ from plain")
        z_err = (z_k - z_p).abs().max().item()
        err = (out_k - out_p).abs().max().item()
        if not (z_err < SW_TOL["logits"] and err < SW_TOL["out"]) \
                or not bool(out_k.isfinite().all()):
            raise Failed(f"{tag}: max |d| logits {z_err:.3g} (tol "
                         f"{SW_TOL['logits']}), outputs {err:.3g} (tol "
                         f"{SW_TOL['out']})")
        errs.append((z_err, err))
        flops, nbytes = expert_cost(st_k)
        bound, by = _bound_ms(flops, nbytes, H100_F32_FLOPS)
        c_t = None if counts is None else counts.clone()
        kern = lambda: KE.expert_sublayer(       # noqa: E731
            x, scale, router, wi, wo, capacity=SW_CAPACITY, seq_len=seq,
            counts=c_t)
        plain = lambda: KE.expert_sublayer_plain(  # noqa: E731
            x, scale, router, wi, wo, capacity=SW_CAPACITY, seq_len=seq,
            counts=None if counts is None else counts.clone())
        row = by_rows[r] = dict(
            ms=_time_ms(kern), plain_ms=fmean(_timed(plain, 1, 5)),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
            seq_len=seq, experts_hit=st_k["moe_experts_hit"],
            max_load=st_k["moe_max_load"], logit_err=z_err, max_abs_err=err)
        log(f"  expert_sublayer    float32  R={r:5d} seq {seq:2d}: "
            f"{row['experts_hit']} experts hit (most rows {row['max_load']}"
            f"), max|d| logits {z_err:.3g}, outputs {err:.3g}; kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms (wall), "
            f"bound {bound:.4f} ms ({by})")
    kernels.reset_launch_counts()
    per = {key: sum(SW_WEIGHT[r] * by_rows[r][key] for r, _ in SW_CALLS)
           for key in ("ms", "plain_ms", "bound_ms")}
    log(f"  expert_sublayer    float32  per retrieve (6·t40 + 3·t1 + 3·t31 "
        f"+ 6·t100): kernel {per['ms']:.4f} ms, plain {per['plain_ms']:.4f} "
        f"ms, bound {per['bound_ms']:.4f} ms")
    main = by_rows[100]
    return dict(err=max(e for _, e in errs),
                logit_err=max(z for z, _ in errs), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], flops=main["flops"],
                bytes=main["bytes"], by_rows=by_rows, per_retrieve=per)


def phase_kernels(dev, trie) -> dict:
    import torch

    from gdr_tpu_torch.kernels import decode as KD
    from gdr_tpu_torch.kernels import rerank as KR
    from gdr_tpu_torch.ops.quantize import quantize_store

    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    lmax = 4                  # max_len of the bench trie: depth 3 + 1
    rows_main = B * WIDTHS[-1]
    # bring the card to its working clocks before the first timed call
    warm = rn(4096, 4096, dtype=torch.bfloat16)
    t_end = time.perf_counter() + 0.5
    while time.perf_counter() < t_end:
        warm @ warm
        torch.cuda.synchronize()
    del warm
    assert torch.get_float32_matmul_precision() == "highest"  # f32 yardstick: no TF32
    stats: dict = {name: dict(rows={}, rows_f32={}) for name in DECODER}
    for name in DECODER:
        stats[name]["qg"] = {}
    gemm_rows: dict = {"bfloat16": [], "float32": []}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
        rows_key = "rows" if bf16 else "rows_f32"
        for w in WIDTHS:
            r, pos = B * w, POS_OF_WIDTH[w]
            c = sublayers_vs_plain(rn, stats, r, w, pos, lmax, dtype)

            # device times at this row count: kernel, plain, library
            x, scale, dn = c.x, c.scale, c.dn
            for name, (kern, plain, lib) in sublayer_calls(c, pos).items():
                flops, nbytes = decoder_cost(name, r, pos, lmax,
                                             x.element_size())
                bound, by = _bound_ms(flops, nbytes, peak)
                stats[name][rows_key][r] = dict(
                    ms=_time_ms(kern), plain_ms=_time_ms(plain),
                    library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
                    flops=flops, bytes=nbytes, pos=pos)
                if name != "ffn_sublayer":             # its attention core alone
                    stats[name][rows_key][r]["core_bound_ms"] = core_bytes(
                        name, r, pos, x.element_size()) / H100_BYTES * 1e3
                else:                                  # its two GEMMs' plans
                    stats[name][rows_key][r]["plans"] = {
                        f"{n_}x{k_}": plan_text(KD.gemm_plan(r, n_, k_, dev,
                                                             dtype))
                        for n_, k_ in ((DFF, D), (D, DFF))}

            # the GEMM alone at its four main-path shapes, each with the
            # epilogue the path gives it, against one torch.matmul
            for n, k, epi in GEMM_SHAPES:
                a = rn(r, k, dtype=dtype)
                wt = rn(n, k, std=k ** -0.5, dtype=dtype)
                kw = (dict(resid=rn(r, n, dtype=dtype)) if epi == "residual"
                      else dict(scale=scale))          # norm GEMMs read x [r, D]
                err = _close(f"gemm {dn} {epi} M={r} N={n} K={k}",
                             KD.gemm(a, wt, epi, **kw),
                             KD.gemm_plain(a, wt, epi, **kw), dn)
                nbytes = (r * k + n * k + r * n * (2 if epi == "residual"
                                                   else 1)) * a.element_size()
                bound, by = _bound_ms(2 * r * n * k, nbytes, peak)
                gp = KD.gemm_plan(r, n, k, dev, dtype)
                plan = plan_text(gp)
                gemm_rows[dn].append(dict(
                    m=r, n=n, k=k, epi=epi, dtype=dn, max_abs_err=err,
                    ms=_time_ms(lambda: KD.gemm(a, wt, epi, **kw)),
                    matmul_ms=_time_ms(lambda: a @ wt.t()), bound_ms=bound,
                    bound_by=by, kind=plan_kind(gp), plan=plan))
                g_ = gemm_rows[dn][-1]
                log(f"  gemm {dn:8s} {epi:8s} M={r:5d} N={n:5d} K={k:5d}: "
                    f"{g_['ms']:.4f} ms, torch.matmul {g_['matmul_ms']:.4f} "
                    f"ms, bound {bound:.4f} ms ({by}); plan {plan}")

    f32_one_query(rn, stats, lmax, dev)

    # the shapes the other retrieve options give the sublayers at 3,200 rows
    for dtype in (torch.bfloat16, torch.float32):
        for pos, lmax_o in OPTION_POS_LMAX:
            sublayers_vs_plain(rn, stats, rows_main, WIDTHS[-1], pos, lmax_o,
                               dtype)

    # query generation's shape: each of 320 rows its own query (one beam)
    # over a 64-token doc, at the last position of a 40-position cache (past
    # the self core's 16 register positions, every cache row read); also
    # 3,200 rows.  Timed in f32, the dtype `cli qg` runs, and in bf16
    pos = QG_L - 1
    for dtype in (torch.bfloat16, torch.float32):
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        for r in QG_ROWS:
            c = sublayers_vs_plain(rn, stats, r, 1, pos, QG_L, dtype,
                                   enc_len=QG_DOC_LEN)
            el = c.x.element_size()
            for name, (kern, plain, lib) in sublayer_calls(c, pos).items():
                flops, nbytes = decoder_cost(name, r, pos, QG_L, el,
                                             queries=r, enc_len=QG_DOC_LEN)
                bound, by = _bound_ms(flops, nbytes, peak)
                row = stats[name]["qg"][f"{c.dn} R={r}"] = dict(
                    ms=_time_ms(kern), plain_ms=_time_ms(plain, n=5),
                    library_ms=_time_ms(lib), bound_ms=bound, bound_by=by,
                    flops=flops, bytes=nbytes, rows=r, beams=1, pos=pos,
                    lmax=QG_L, enc_len=QG_DOC_LEN)
                core = ""
                if name != "ffn_sublayer":             # its attention core alone
                    row["core_bound_ms"] = core_bytes(
                        name, r, pos, el, queries=r, enc_len=QG_DOC_LEN
                    ) / H100_BYTES * 1e3
                    core = (f"; its core's bytes bound "
                            f"{row['core_bound_ms']:.4f} ms")
                log(f"  {name:20s} {c.dn:8s} R={r:5d} qg (1 beam, S "
                    f"{QG_DOC_LEN}, L {QG_L} pos {pos}): kernel "
                    f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                    f"library {row['library_ms']:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}){core}")

    for name in DECODER:
        st = stats[name]
        for rows_key, dn, sfx in (("rows", "bfloat16", ""),
                                  ("rows_f32", "float32", "_f32")):
            for r, row in sorted(st[rows_key].items()):
                log(f"  {name:20s} {dn:8s} R={r:5d}: kernel {row['ms']:.4f} "
                    f"ms, plain {row['plain_ms']:.4f} ms, library "
                    f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
                    f"ms ({row['bound_by']})"
                    + "".join(f"; {nk} plan {p}"
                              for nk, p in row.get("plans", {}).items()))
            st["per_retrieve" + sfx] = {
                key: sum(RETRIEVE_WEIGHT[w] * st[rows_key][B * w][key]
                         for w in WIDTHS)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "core_bound_ms") if key in st[rows_key][rows_main]}
            st["gemms" + sfx] = [g_ for g_ in gemm_rows[dn]
                                 if (g_["n"], g_["k"]) in DECODER_GEMMS[name]]
            pr = st["per_retrieve" + sfx]
            log(f"  {name:20s} {dn:8s} per retrieve (6·t32 + 6·t992 + "
                f"12·t3200): kernel {pr['ms']:.4f} ms, plain "
                f"{pr['plain_ms']:.4f} ms, library {pr['library_ms']:.4f} ms, "
                f"bound {pr['bound_ms']:.4f} ms"
                + (f"; its attention core's bytes bound "
                   f"{pr['core_bound_ms']:.4f} ms" if "core_bound_ms" in pr
                   else ""))
        st.update({k: v for k, v in st["rows"][rows_main].items()
                   if k != "pos"})

    # the scorers compute in f32 outside the tensor cores; each reads its
    # rows once.  Packed scorer at the operating point: 3,200 beams over
    # the packed layout of a 334,314-doc store (356,632 rows incl.
    # padding), cap 32
    m = PACKED_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        rows = rn(m, D, dtype=dtype)
        starts = (torch.randint(0, (m - CAP) // 8, (rows_main,), generator=g,
                                device=dev) * 8).to(torch.int32)
        # a distinct query row per beam, as decoder-side reps give them, and
        # one row per query broadcast to its beams, as the default path does
        q = rn(rows_main, D, std=0.05)
        q_bc = q.view(B, -1, D)[:, :1].expand(B, WIDTHS[-1], D
                                              ).reshape(rows_main, D)
        errs = [_close(f"packed_scores {dn} {form}",
                       KR.packed_scores(rows, starts, qq, CAP),
                       KR.packed_scores_plain(rows, starts, qq, CAP),
                       "float32")
                for form, qq in (("row per beam", q), ("row per query", q_bc))]
        err = max(errs)
        log(f"  {dn:8s} R={rows_main:5d}  max|d| packed_scores {errs[0]:.3g} "
            f"(a query row per beam), {errs[1]:.3g} (one row per query)  "
            f"(tol {TOL['float32'][0]} + {TOL['float32'][1]}·|plain|)")
        if dtype == torch.bfloat16:
            idx = starts.long()[:, None] + torch.arange(CAP, device=dev)
            qb = q.to(dtype)[:, :, None]

            def library():
                return torch.tanh(torch.bmm(rows[idx], qb))

            stats["packed_scores"] = dict(
                err=err, flops=2 * rows_main * CAP * D,
                bytes=rows_main * CAP * D * rows.element_size()
                + rows_main * D * 4 + rows_main * 4 + rows_main * CAP * 4,
                peak=H100_F32_FLOPS,
                ms=_time_ms(lambda: KR.packed_scores(rows, starts, q, CAP)),
                plain_ms=_time_ms(lambda: KR.packed_scores_plain(
                    rows, starts, q, CAP), n=5),
                library_ms=_time_ms(library, n=5))
        del rows

    # int8 packed scorer (raw dots): the int8 packed layout of the same
    # store (356,640 rows, 32-aligned starts), the query in the model dtype
    m = PACKED_ROWS_INT8
    values = quantize_store(rn(m, D)).values
    for r in (B, rows_main):
        starts = (torch.randint(0, (m - CAP) // 32 + 1, (r,), generator=g,
                                device=dev) * 32).to(torch.int32)
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q = rn(r, D, std=0.05, dtype=dtype)
            got = KR.packed_scores_int8(values, starts, q, CAP)
            want = KR.packed_scores_int8_plain(values, starts, q, CAP)
            err = _close(f"packed_scores_int8 q {dn} R={r}", got, want,
                         "float32")
            errs.append(err)
            log(f"  {dn:8s} R={r:5d}  max|d| packed_scores_int8 {err:.3g}  "
                f"(tol {TOL['float32'][0]} + {TOL['float32'][1]}·|plain|)")
        if r == rows_main:
            q = q.float()                  # timed without the wrapper's cast
            idx = starts.long()[:, None] + torch.arange(CAP, device=dev)

            def library():
                return torch.bmm(values[idx].float(), q[:, :, None])

            stats["packed_scores_int8"] = dict(
                err=max(errs), flops=2 * r * CAP * D,
                bytes=r * CAP * D + r * D * 4 + r * 4 + r * CAP * 4,
                peak=H100_F32_FLOPS,
                ms=_time_ms(lambda: KR.packed_scores_int8(values, starts, q,
                                                          CAP)),
                plain_ms=_time_ms(lambda: KR.packed_scores_int8_plain(
                    values, starts, q, CAP), n=5),
                library_ms=_time_ms(library, n=5))
    del values

    # gather scorer over the plain store: candidates from the bench trie's
    # padded cluster table (cap 64) at random clusters; a masked slot is
    # not read, so the bytes count the real documents of these clusters
    c_docs = torch.as_tensor(trie.cluster_docs, device=dev)
    c_mask = torch.as_tensor(trie.cluster_doc_mask, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        store = rn(N_DOCS, D, dtype=dtype)
        for r in (B, rows_main):
            cl = torch.randint(0, c_docs.shape[0], (r,), generator=g,
                               device=dev)
            docs, mask = c_docs[cl].contiguous(), c_mask[cl].contiguous()
            q = rn(r, D, std=0.05)
            got = KR.rerank_scores(store, docs, q, mask)
            want = KR.rerank_scores_plain(store, docs, q, mask)
            err = _close(f"rerank_scores {dn} R={r}", got, want, "float32")
            log(f"  {dn:8s} R={r:5d}  max|d| rerank_scores {err:.3g}  "
                f"(tol {TOL['float32'][0]} + {TOL['float32'][1]}·|plain|)")
            if dtype == torch.bfloat16 and r == rows_main:
                real = int(mask.sum())
                cap = docs.shape[1]
                docs_l, unmasked = docs.long(), ~mask
                qb = q.to(dtype)[:, :, None]

                def library():
                    return torch.tanh(torch.bmm(store[docs_l], qb)
                                      )[..., 0].masked_fill(unmasked, -1e9)

                log(f"  rerank_scores: {real} real of {r * cap} candidate "
                    f"rows ({real / r:.1f} per beam, cap {cap})")
                stats["rerank_scores"] = dict(
                    err=err, flops=2 * real * D,
                    bytes=real * D * store.element_size() + r * cap * 4
                    + r * cap + r * D * 4 + r * cap * 4,
                    peak=H100_F32_FLOPS,
                    ms=_time_ms(lambda: KR.rerank_scores(store, docs, q,
                                                         mask)),
                    plain_ms=_time_ms(lambda: KR.rerank_scores_plain(
                        store, docs, q, mask), n=5),
                    library_ms=_time_ms(library, n=5))
        del store
    for name in SCORERS:
        st = stats[name]
        st["bound_ms"], st["bound_by"] = _bound_ms(st["flops"], st["bytes"],
                                                   st["peak"])
        log(f"  {name:20s} R=3200: kernel {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f} ms, library {st['library_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.4f} ms ({st['bound_by']})")
    stats["expert_sublayer"] = experts_vs_plain(rn)
    stats.update(moonlight_vs_plain(rn))
    stats["gemm_f32_moonlight"] = moonlight_gemms(rn)
    stats["kda"] = kda_vs_plain(rn)
    return stats


# ------------------------------------------------------------ phase 3

# the store layouts of Evaluator: name → its keyword arguments
SMALL_LAYOUTS = {"plain": {}, "packed": dict(packed=True),
                 "plain int8": dict(quantize=True),
                 "packed int8": dict(packed=True, quantize=True)}
TIMER_KEYS = ("_total_s", "_mean_ms")


def _small_world(seed: int):
    import numpy as np

    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.eval.evaluator import EvalData
    from gdr_tpu_torch.ops.trie import build_trie

    cfg = ModelConfig(kary=4, max_output_length=5, d_model=64, d_kv=16,
                      d_ff=128, num_layers=2, num_decoder_layers=2,
                      num_heads=4, vocab_size=512, encoder_d_model=64,
                      adaptor_layer_num=1, adaptor_num_heads=2)
    cid_to_docs, doc = {}, 0
    for a in range(4):
        for b in range(3):
            for c in range(2):
                cid_to_docs[f"{a}-{b}-{c}"] = list(range(doc, doc + 3))
                doc += 3
    trie = build_trie(cid_to_docs, cfg.kary, max_docs_per_cluster=8)
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(doc, 64)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)   # tanh unsaturated
    ids = rng.integers(2, 512, size=(3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    cid_of = {d: cid for cid, docs in cid_to_docs.items() for d in docs}
    gt = [rng.choice(doc, size=12, replace=False) for _ in ids]
    data = EvalData(input_ids=ids, attn_mask=mask,
                    gt_docs=[[str(d) for d in g] for g in gt],
                    gt_cids=[sorted({cid_of[int(d)] for d in g}) for g in gt])
    return cfg, trie, store, ids, mask, data


# phase 3's other options of a retrieve: name → ModelConfig and EvalConfig
# settings; each runs on the plain and packed layouts
SMALL_MODES = {
    "decoder_avg + average": (dict(concate_fusion=True),
                              dict(use_query_embed_decoder_avg=True)),
    "decoder_special + concate": (dict(concate_fusion=True),
                                  dict(use_query_embed_decoder_special=True,
                                       fusion_strategy="concate")),
    "top_k sampling": (dict(concate_fusion=True),
                       dict(gen_method="top_k", sample_top_k=3,
                            temperature=0.9)),
    "slow PAWA": (dict(adaptor_efficient=False), {}),
}


def _small_models(cfg, dev):
    """The same seeded small model on the CPU and on the card."""
    import torch

    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    cpu_model = init_weights(GenerativeRetriever(cfg),
                             torch.Generator().manual_seed(0)).eval()
    gpu_model = GenerativeRetriever(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, gpu_model.to(dev).eval()


def _same_retrieve(tag, res_c, rr_c, res_g, rr_g):
    """Beams, valid doc ids and fused scores (within 1e-4) of a cpu and a
    gpu retrieve agree; returns (valid beams, valid docs, max |d| score)."""
    import torch

    valid = res_c.valid.cpu()
    if not torch.equal(valid, res_g.valid.cpu()):
        raise Failed(f"small {tag}: beam validity differs between cpu "
                     f"and gpu")
    if not torch.equal(res_c.nodes.cpu()[valid],
                       res_g.nodes.cpu()[valid]):
        raise Failed(f"small {tag}: beam nodes differ between cpu and "
                     f"gpu")
    dv = rr_c.doc_valid.cpu()
    if not torch.equal(dv, rr_g.doc_valid.cpu()):
        raise Failed(f"small {tag}: doc validity differs between cpu "
                     f"and gpu")
    if not torch.equal(rr_c.doc_ids.cpu()[dv], rr_g.doc_ids.cpu()[dv]):
        raise Failed(f"small {tag}: doc ids differ between cpu and gpu")
    err = (rr_c.scores.cpu()[dv] - rr_g.scores.cpu()[dv]).abs().max().item()
    if not err <= 1e-4:
        raise Failed(f"small {tag}: fused scores differ by {err:.3g} "
                     f"> 1e-4")
    return int(valid.sum()), int(dv.sum()), err


def phase_small(dev) -> dict:
    import dataclasses

    import torch

    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.ops.beam import gumbel_noise

    cfg, trie, store, ids, mask, data = _small_world(0)
    ev_cfg = EvalConfig(num_beams=12, num_return_sequences=20,
                        max_output_length=cfg.max_output_length)
    cpu_model, gpu_model = _small_models(cfg, dev)
    for layout, kw in SMALL_LAYOUTS.items():
        ev_c = Evaluator(cpu_model, trie, store, ev_cfg, **kw)
        ev_g = Evaluator(gpu_model, trie, store, ev_cfg, **kw)
        if kw.get("quantize"):
            for part in ("values", "scales"):
                if not torch.equal(getattr(ev_c.store, part),
                                   getattr(ev_g.store, part).cpu()):
                    raise Failed(f"small {layout}: int8 store {part} differ "
                                 f"between cpu and gpu")
        res_c, rr_c = ev_c.retrieve(ids, mask)
        res_g, rr_g = ev_g.retrieve(ids, mask)
        n_valid, n_docs, err = _same_retrieve(layout, res_c, rr_c, res_g,
                                              rr_g)
        m_c = ev_c.evaluate(data, batch_size=2)
        m_g = ev_g.evaluate(data, batch_size=2)
        drop = lambda m: {k: v for k, v in m.items()
                          if not k.endswith(TIMER_KEYS)}
        if set(m_c) != set(m_g) or drop(m_c) != drop(m_g):
            raise Failed(f"small {layout}: evaluate metrics differ between "
                         f"cpu and gpu")
        log(f"  f32 d=64 {layout:11s}: {n_valid} valid beams, "
            f"{n_docs} valid docs equal on cpu and gpu; max |d| fused "
            f"score {err:.3g} (tol 1e-4); {len(drop(m_c))} evaluate metrics "
            f"equal (recall100_1.0 {m_c['recall100_1.0']:.3f})")

    models = {}
    for mode, (m_kw, e_kw) in SMALL_MODES.items():
        key = tuple(sorted(m_kw.items()))
        if key not in models:
            models[key] = _small_models(dataclasses.replace(cfg, **m_kw), dev)
        cpu_m, gpu_m = models[key]
        mode_cfg = dataclasses.replace(ev_cfg, **e_kw)
        for layout in ("plain", "packed"):
            kw = SMALL_LAYOUTS[layout]
            ev_c = Evaluator(cpu_m, trie, store, mode_cfg, **kw)
            ev_g = Evaluator(gpu_m, trie, store, mode_cfg, **kw)
            noise = None
            if mode_cfg.gen_method == "top_k":     # one draw for both runs
                noise = gumbel_noise(
                    (ev_c._max_len, len(ids) * mode_cfg.num_beams,
                     cfg.kary + 1), torch.Generator().manual_seed(5))
            res_c, rr_c = ev_c.retrieve(ids, mask, noise=noise)
            res_g, rr_g = ev_g.retrieve(ids, mask, noise=noise)
            n_valid, n_docs, err = _same_retrieve(f"{mode} {layout}", res_c,
                                                  rr_c, res_g, rr_g)
            log(f"  f32 d=64 {mode:25s} {layout:6s}: {n_valid} valid beams, "
                f"{n_docs} valid docs equal on cpu and gpu; max |d| fused "
                f"score {err:.3g} (tol 1e-4)")
    out = small_switch(dev, dataclasses.replace(
        cfg, num_experts=8, expert_capacity=2, encoder_sparse_step=2,
        decoder_sparse_step=2), trie, store, ids, mask, ev_cfg)
    ml_cfg = dataclasses.replace(
        ModelConfig().scaled("moonlight-16b-a3b"), num_layers=3,
        kary=cfg.kary, max_output_length=cfg.max_output_length)
    out.update(small_moonlight(dev, ml_cfg, trie, len(store), ids, mask,
                               ev_cfg))
    kl_cfg = dataclasses.replace(
        ModelConfig().scaled("kimi-linear-48b-a3b"), num_layers=4,
        kda_layers=(1, 2, 3), full_attn_layers=(4,), kary=cfg.kary,
        max_output_length=cfg.max_output_length)
    out.update(small_kimi_linear(dev, kl_cfg, trie, len(store), ids, mask,
                                 ev_cfg))
    return out


def small_switch(dev, sw_cfg, trie, store, ids, mask, ev_cfg) -> dict:
    """Phase 3's small model with a routed FFN in every other layer of
    each stack (the Switch layout; 8 experts at capacity 2, so a 10-token
    query drops some of its tokens) on the packed layout, on the CPU and twice on
    the card, the second replaying the decode's CUDA graphs.  Returns the
    card's launches of one retrieve (``switch_launches``)."""
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.utils import timing

    cpu_m, gpu_m = _small_models(sw_cfg, dev)
    ev_c = Evaluator(cpu_m, trie, store, ev_cfg, packed=True)
    ev_g = Evaluator(gpu_m, trie, store, ev_cfg, packed=True)
    kernels.reset_launch_counts()
    res_c, rr_c = ev_c.retrieve(ids, mask)
    routing_c = kernels.launch_counts(experts=True)
    for turn in ("eager", "replayed"):    # the second replays the graphs
        kernels.reset_launch_counts()
        res_g, rr_g = ev_g.retrieve(ids, mask)
        torch.cuda.synchronize()
        got = {**timing.counts(), **kernels.launch_counts(experts=True)}
        n_valid, n_docs, err = _same_retrieve(f"switch {turn}", res_c, rr_c,
                                              res_g, rr_g)
        replays = 3 if turn == "replayed" else 0
        if (got["graph_replays"], got["eager_decodes"], got["host_syncs"]) \
                != (replays, 1 - replays // 3, 2):
            raise Failed(f"small switch {turn}: {got['graph_replays']} graph "
                         f"replays, {got['eager_decodes']} eager decodes, "
                         f"{got['host_syncs']} host syncs (want {replays}, "
                         f"{1 - replays // 3}, 2)")
        routing = {k: v for k, v in got.items() if k.startswith("moe_")}
        if routing != {k: routing_c[k] for k in routing}:
            raise Failed(f"small switch {turn}: routing counters {routing} "
                         f"on the card, {routing_c} on the cpu")
        steps = got["self_attn_sublayer"] // sw_cfg.num_decoder_layers
        want = 1 + steps              # one sparse layer in each stack
        if got["expert_sublayer"] != want or routing["moe_dropped"] == 0 \
                or got["ffn_sublayer"] != steps:
            raise Failed(f"small switch {turn}: {got['expert_sublayer']} "
                         f"expert and {got['ffn_sublayer']} ffn launches "
                         f"(want {want} and {steps}), "
                         f"{routing['moe_dropped']} tokens dropped")
        log(f"  f32 d=64 switch (8 experts, cap 2) packed {turn}: {n_valid} "
            f"valid beams, {n_docs} valid docs equal on cpu and gpu; max |d| "
            f"fused score {err:.3g} (tol 1e-4); routing {routing}; "
            f"{got['expert_sublayer']} expert launches")
    launches = {k: v for k, v in got.items() if k in kernels.launch_counts()}
    kernels.reset_launch_counts()
    return {"switch_launches": launches}


def _routing_gap(model) -> float:
    """The smallest gap between the k-th and (k+1)-th selection scores
    (sigmoid + bias) over the chosen experts that ``model``'s expert layers
    recorded (``MoE.record``)."""
    import torch

    from gdr_tpu_torch.models.deepseek import MoE

    gap = float("inf")
    for ff in model.modules():
        if isinstance(ff, MoE):
            for _, z in ff.record or ():
                s = (torch.sigmoid(z) + ff.score_bias.detach().float()
                     ).sort(dim=1, descending=True).values
                gap = min(gap, float((s[:, ff.k - 1] - s[:, ff.k]).min()))
    return gap


def small_moonlight(dev, ml_cfg, trie, n_docs, ids, mask, ev_cfg) -> dict:
    """A decoder-only DeepSeek-V3 generator (``ml_cfg``: phase 3's run
    with Moonlight-16B-A3B's widths at 1 dense + 2 expert layers) with the
    benchmark's weight scales (``gdrbench/weights_moonlight.py``) through
    :func:`_small_generator`.  Returns the card's launches of one retrieve
    (``moonlight_launches``)."""
    from gdrbench.weights_moonlight import draw_into

    moe_layers = ml_cfg.num_layers - ml_cfg.first_k_dense
    want = lambda steps: {                                 # noqa: E731
        "mla_attention": ml_cfg.num_layers * steps,
        "topk_expert_sublayer": moe_layers * (steps + 1), "packed_scores": 1}
    return {"moonlight_launches": _small_generator(
        dev, "moonlight", ml_cfg, draw_into, want, trie, n_docs, ids, mask,
        ev_cfg)}


def small_kimi_linear(dev, kl_cfg, trie, n_docs, ids, mask, ev_cfg) -> dict:
    """Kimi Linear's hybrid generator (``kl_cfg``: phase 3's run with
    Kimi-Linear-48B-A3B's widths at one period of its layers: KDA with the
    dense FFN, two KDA and one NoPE MLA layer with card 0's 32 of 256
    experts) with the benchmark's weight scales
    (``gdrbench/weights_kimi_linear.py``) through :func:`_small_generator`:
    the launches of ``kda_prefill``, ``kda_decode``, ``mla_attention`` and
    ``topk_expert_sublayer`` counted on the main path, eager and replayed,
    and the KDA device counters equal to the CPU's.  Returns the card's
    launches of one retrieve (``kimi_linear_launches``)."""
    from gdrbench.weights_kimi_linear import draw_into

    kda_layers = len(kl_cfg.kda_layers)
    moe_layers = kl_cfg.num_layers - kl_cfg.first_k_dense
    want = lambda steps: {                                 # noqa: E731
        "kda_prefill": kda_layers, "kda_decode": kda_layers * steps,
        "mla_attention": (kl_cfg.num_layers - kda_layers) * steps,
        "topk_expert_sublayer": moe_layers * (steps + 1), "packed_scores": 1}
    return {"kimi_linear_launches": _small_generator(
        dev, "kimi linear", kl_cfg, draw_into, want, trie, n_docs, ids, mask,
        ev_cfg)}


def _small_generator(dev, tag, cfg, draw_into, want, trie, n_docs, ids, mask,
                     ev_cfg) -> dict:
    """A decoder-only generator at published widths and few layers
    (``cfg``), its weights drawn by ``draw_into`` on the CPU and copied to
    the card, over phase 3's trie and a unit store of ``n_docs`` rows of
    its query width, on the packed layout, on the CPU and twice on the
    card, the second replaying the decode's CUDA graphs.  Each card run
    starts from zeroed counters and must launch ``want`` and count the
    CPU's device counters (routing, KDA's source rows and prefill tokens);
    ``want`` gives the launches of a retrieve of so many decode steps.
    The CPU's run records its routing, whose smallest k-th / (k+1)-th
    selection-score gap is printed: a gap within the card's rounding
    (~1e-6) may route a token otherwise there.  Returns the card's
    launches of one retrieve."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.deepseek import MoE
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    from gdr_tpu_torch.utils import timing

    t = time.perf_counter()
    cpu_m = GenerativeRetriever(cfg).eval()
    draw_into(cpu_m, 11)
    with dev:
        gpu_m = GenerativeRetriever(cfg).eval()
    gpu_m.load_state_dict(cpu_m.state_dict())
    store = np.random.default_rng(1).normal(
        size=(n_docs, cfg.encoder_d_model))
    store = (store / np.linalg.norm(store, axis=1, keepdims=True)
             ).astype(np.float32)
    ev_c = Evaluator(cpu_m, trie, store, ev_cfg, packed=True)
    ev_g = Evaluator(gpu_m, trie, store, ev_cfg, packed=True)
    log(f"  {tag} widths, {cfg.num_layers} layers: weights on the cpu and "
        f"the card in {time.perf_counter() - t:.1f} s")
    moes = [ff for ff in cpu_m.modules() if isinstance(ff, MoE)]
    for ff in moes:
        ff.record = []
    kernels.reset_launch_counts()
    t = time.perf_counter()
    res_c, rr_c = ev_c.retrieve(ids, mask)
    cpu_s = time.perf_counter() - t
    device_c = {k: v for k, v in kernels.launch_counts(experts=True).items()
                if k.startswith(("moe_", "kda_source", "kda_prefill_"))}
    gap = _routing_gap(cpu_m)
    for ff in moes:
        ff.record = None
    want = want(ev_g._max_len)
    syncs = None
    for turn in ("eager", "replayed"):    # the second replays the graphs
        kernels.reset_launch_counts()
        res_g, rr_g = ev_g.retrieve(ids, mask)
        torch.cuda.synchronize()
        got = {**timing.counts(), **kernels.launch_counts(experts=True)}
        device = {k: got[k] for k in device_c}
        if device != device_c:
            raise Failed(f"small {tag} {turn}: device counters {device} on "
                         f"the card, {device_c} on the cpu (smallest "
                         f"selection-score gap on the cpu {gap:.3g})")
        n_valid, n_found, err = _same_retrieve(f"{tag} {turn}", res_c, rr_c,
                                               res_g, rr_g)
        replays = 3 if turn == "replayed" else 0
        syncs = got["host_syncs"] if syncs is None else syncs
        if (got["graph_replays"], got["eager_decodes"], got["host_syncs"]) \
                != (replays, 1 - replays // 3, syncs):
            raise Failed(f"small {tag} {turn}: {got['graph_replays']} graph "
                         f"replays, {got['eager_decodes']} eager decodes, "
                         f"{got['host_syncs']} host syncs (want {replays}, "
                         f"{1 - replays // 3}, {syncs})")
        launches = {k: v for k, v in got.items()
                    if k in kernels.launch_counts() and v}
        if launches != want:
            raise Failed(f"small {tag} {turn}: launches {launches}, want "
                         f"{want}")
        log(f"  f32 {tag} widths ({cfg.num_layers} layers, "
            f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}) "
            f"packed {turn}: {n_valid} valid beams, {n_found} valid docs "
            f"equal on cpu and gpu; max |d| fused score {err:.3g} (tol "
            f"1e-4); device counters {device}; smallest selection-score gap "
            f"on the cpu {gap:.3g}; launches {launches}; cpu retrieve "
            f"{cpu_s:.1f} s")
    launches = {k: v for k, v in got.items() if k in kernels.launch_counts()}
    kernels.reset_launch_counts()
    del ev_g, gpu_m
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 4

def bench_cid_map(n_docs: int, kary: int, leaf_cap: int
                  ) -> dict[str, list[int]]:
    """The bench's systematic 3-level CIDs: n_docs in clusters of at most
    leaf_cap, spread evenly over kary × kary level-2 nodes."""
    cid_to_docs, doc = {}, 0
    level3 = -(-n_docs // (kary * kary * leaf_cap))
    for i in range(kary):
        for j in range(kary):
            for k in range(level3):
                if doc >= n_docs:
                    break
                take = min(leaf_cap, n_docs - doc)
                cid_to_docs[f"{i}-{j}-{k}"] = list(range(doc, doc + take))
                doc += take
    return cid_to_docs


def build_nq_scale_trie(n_docs: int, kary: int, leaf_cap: int,
                        max_docs_per_cluster: int):
    """The bench's trie over :func:`bench_cid_map`."""
    from gdr_tpu_torch.ops.trie import build_trie

    return build_trie(bench_cid_map(n_docs, kary, leaf_cap), kary,
                      max_docs_per_cluster=max_docs_per_cluster)


# the full-width layouts: name, Evaluator keyword arguments, the scorer
# each retrieve launches once
FULL_LAYOUTS = [("packed bf16", dict(packed=True), "packed_scores"),
                ("plain bf16", dict(packed=False), "rerank_scores"),
                ("packed int8", dict(packed=True, quantize=True),
                 "packed_scores_int8")]
SCORERS = ("packed_scores", "packed_scores_int8", "rerank_scores")


def _check_retrieve(name, res, rr, n_beams: int, top_r: int,
                    n_docs: int = N_DOCS) -> None:
    """Fails unless all ``n_beams`` beams or rollouts are valid, every query
    has ``top_r`` valid doc ids in [0, n_docs) and the fused scores are
    finite."""
    valid = int(res.valid.sum())
    if valid != n_beams:
        raise Failed(f"{name}: {valid} valid beams or rollouts, want "
                     f"{n_beams}")
    dv = rr.doc_valid.cpu()
    docs = rr.doc_ids.cpu()[dv]
    if dv.sum(-1).min().item() < top_r or docs.min() < 0 \
            or docs.max() >= n_docs:
        raise Failed(f"{name}: re-rank returned fewer than top-R valid "
                     f"docs or ids outside [0, {n_docs})")
    if not bool(rr.scores[rr.doc_valid].isfinite().all()):
        raise Failed(f"{name}: non-finite fused scores")


def _f32_gemm_launches(fn) -> dict[str, int]:
    """The sublayers' f32 GEMM launches by kernel name while ``fn`` runs
    (``gemm_f32_ring_rows``, the small-row kernel; ``gemm_f32_ring_ws``, the
    warp-specialised ring), from a torch.profiler trace, which sees the
    kernels that replayed CUDA graphs launch."""
    return _launches_by_name(fn, ("gemm_f32_ring_rows", "gemm_f32_ring_ws"))


def _counted_retrieve(name, ev, ids, mask, launches: dict, n_beams: int,
                      top_r: int, gemm_kernels: dict | None = None):
    """One retrieve with the launch counts set to 0 just before it: fails
    unless every kernel launched as often as ``launches`` says (0 for the
    others) and the result passes ``_check_retrieve``; where
    ``gemm_kernels`` is given, one more retrieve under the profiler fails
    unless its f32 GEMM launches by kernel name are those
    (:func:`_f32_gemm_launches`).  Returns (BeamResult, RerankResult, the
    counts)."""
    import torch

    from gdr_tpu_torch import kernels

    kernels.reset_launch_counts()
    res, rr = ev.retrieve(ids, mask)
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    want = {**dict.fromkeys(got, 0), **launches}
    log(f"  {name}: launches in one retrieve: {got}")
    if got != want:
        raise Failed(f"{name}: launch counts {got} != {want}")
    if gemm_kernels is not None:
        by_name = _f32_gemm_launches(lambda: ev.retrieve(ids, mask))
        log(f"  {name}: f32 GEMM launches by kernel in one retrieve's trace: "
            f"{by_name}")
        if by_name != gemm_kernels:
            raise Failed(f"{name}: f32 GEMM launches by kernel {by_name} != "
                         f"{gemm_kernels}")
    _check_retrieve(name, res, rr, n_beams, top_r)
    return res, rr, got


def _store_bytes(store) -> int:
    import torch
    parts = (store,) if isinstance(store, torch.Tensor) \
        else (store.values, store.scales)
    return sum(t.numel() * t.element_size() for t in parts)


def phase_full(dev, card: str, trie, timed: int = 3, profile: bool = False
               ) -> dict:
    import numpy as np
    import torch

    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    beams, seq_len, qbatch = 100, 40, 32
    cfg = ModelConfig().scaled("base")
    g = torch.Generator(device=dev).manual_seed(7)
    store32 = torch.randn(N_DOCS, cfg.encoder_d_model, generator=g, device=dev)
    store32 = store32 / store32.norm(dim=1, keepdim=True)
    store = store32.to(torch.bfloat16)
    with torch.device(dev):
        model = GenerativeRetriever(cfg)
    model = init_weights(model.to(torch.bfloat16),
                         torch.Generator(device=dev).manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    ev_cfg = EvalConfig(num_beams=beams, num_return_sequences=beams,
                        max_output_length=cfg.max_output_length,
                        length_penalty=0.8)
    evs = {name: Evaluator(model, trie, store, ev_cfg, **kw)
           for name, kw, _ in FULL_LAYOUTS}
    del store
    rng = np.random.default_rng(0)
    ids = rng.integers(2, cfg.vocab_size, size=(qbatch, seq_len)).astype(np.int32)
    mask = np.ones_like(ids)
    log(f"  t5-base bf16, {n_params / 1e6:.1f}M params; {qbatch} queries x "
        f"{seq_len} tokens, beam {beams}; stores "
        + ", ".join(f"{n} {tuple(ev.store.shape)} "
                    f"{_store_bytes(ev.store) / 1e6:.1f} MB"
                    for n, ev in evs.items()))
    tid = torch.as_tensor(ids, device=dev)
    tmask = torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        enc_ms = fmean(_timed(lambda: model.query_embedding(
            model.encode(tid, tmask)), 1, 5))
        q_emb = model.query_embedding(model.encode(tid, tmask))

    torch.cuda.reset_peak_memory_stats()
    out: dict = {"launches": {}, "layouts": {}}
    top_docs = {}
    for name, _, scorer in FULL_LAYOUTS:
        ev = evs[name]
        t = time.perf_counter()
        ev.retrieve(ids, mask)                           # warm: U table, build
        torch.cuda.synchronize()
        log(f"  {name}: warm retrieve {time.perf_counter() - t:.3f} s")

        # the counted run of this layout's main path
        res, rr, launches = _counted_retrieve(
            name, ev, ids, mask,
            dict(dict.fromkeys(DECODER, 24), **{scorer: 1}), qbatch * beams,
            beams)
        for k, v in launches.items():
            if v:
                out["launches"].setdefault(k, v)
        top_docs[name] = rr.doc_ids[:, :, 0].cpu()       # [A, B] top-1

        # timed retrieves: host clock around synchronised calls; re-rank
        # separately (host dispatch included), decode = total - both
        totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
        rr_ms = fmean(_timed(lambda: ev.rerank(q_emb, res), 1, 5))
        if profile and name == FULL_LAYOUTS[0][0]:
            _profile(lambda: ev.retrieve(ids, mask))
        total = sum(totals) / len(totals)
        lay = dict(retrieve_ms=total, retrieve_ms_each=totals,
                   encode_ms=enc_ms, rerank_ms=rr_ms,
                   decode_ms=total - enc_ms - rr_ms,
                   queries_per_s=qbatch / (total / 1e3),
                   store_bytes=_store_bytes(ev.store))
        log(f"  {name}: retrieve {total:.2f} ms "
            f"({', '.join(f'{x:.2f}' for x in totals)}): encode "
            f"{enc_ms:.2f} ms, decode {total - enc_ms - rr_ms:.2f} ms, "
            f"re-rank {rr_ms:.2f} ms; {lay['queries_per_s']:.1f} queries/s; "
            f"{card}")
        out["layouts"][name] = lay

    ref = top_docs["packed bf16"]
    if not torch.equal(top_docs["plain bf16"], ref):
        raise Failed("plain bf16 and packed bf16 return different top "
                     "documents over the same store")
    agree = (top_docs["packed int8"] == ref).float()
    lay = out["layouts"]["packed int8"]
    lay["top1_agreement"] = agree.mean().item()
    lay["top1_agreement_alpha0"] = agree[0].mean().item()
    log(f"  packed int8: store {lay['store_bytes'] / 1e6:.1f} MB vs "
        f"{out['layouts']['packed bf16']['store_bytes'] / 1e6:.1f} MB bf16; "
        f"top-1 doc agreement with packed bf16 {lay['top1_agreement']:.4f} "
        f"over {agree.numel()} (alpha, query) pairs, "
        f"{lay['top1_agreement_alpha0']:.4f} at alpha 0")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak {out['peak_gib']:.2f} GiB over the timed retrieves")

    # the dtype `cli retrieve --packed` serves: the model and the store in
    # f32 (load_model keeps the f32 weights), the f32 decoder kernels
    del evs
    with torch.device(dev):
        model32 = GenerativeRetriever(cfg)
    model32 = init_weights(model32, torch.Generator(device=dev).manual_seed(0)
                           ).eval()
    ev = Evaluator(model32, trie, store32, ev_cfg, packed=True)
    del store32
    name = "packed f32"
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ev.retrieve(ids, mask)                               # warm: U table, build
    torch.cuda.synchronize()
    log(f"  {name} (f32 model): warm retrieve {time.perf_counter() - t:.3f} s")
    # the f32 GEMM's kernels: step 0's 32 rows on the small-row kernel (6
    # layers x 6 products), the 992 and 3,200 rows of the other three steps
    # (108 launches) on the warp-specialised ring
    n_gemms = len(DECODER) * 2 * 6                    # a step's, 6 layers
    gemm_kernels = dict(gemm_f32_ring_rows=n_gemms, gemm_f32_ring_ws=3 * n_gemms)
    _, _, launches = _counted_retrieve(
        name, ev, ids, mask,
        dict(dict.fromkeys(DECODER, 24), packed_scores=1), qbatch * beams,
        beams, gemm_kernels=gemm_kernels)
    out["launches_f32"] = {k: v for k, v in launches.items() if v}
    out["gemm_kernels_f32"] = gemm_kernels
    totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
    total = sum(totals) / len(totals)
    lay = out["layouts"][name] = dict(
        retrieve_ms=total, retrieve_ms_each=totals,
        queries_per_s=qbatch / (total / 1e3), store_bytes=_store_bytes(ev.store),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, dtype="float32")
    log(f"  {name} (f32 model, as cli retrieve --packed serves): retrieve "
        f"{total:.2f} ms ({', '.join(f'{x:.2f}' for x in totals)}); "
        f"{lay['queries_per_s']:.1f} queries/s; store "
        f"{lay['store_bytes'] / 1e6:.1f} MB; peak {lay['peak_gib']:.2f} GiB; "
        f"{card}")

    # one query a retrieve, as serve-b1 sends: every f32 GEMM (1 / 31 / 100
    # rows) on the small-row kernel; the second call of the shape captures
    # the decode's graphs and replays them
    name = "packed f32 one query"
    ev.retrieve(ids[:1], mask[:1])
    torch.cuda.synchronize()
    _counted_retrieve(
        name, ev, ids[:1], mask[:1],
        dict(dict.fromkeys(DECODER, 24), packed_scores=1), beams, beams,
        gemm_kernels=dict(gemm_f32_ring_rows=4 * n_gemms, gemm_f32_ring_ws=0))
    out["gemm_kernels_f32_one_query"] = dict(
        gemm_f32_ring_rows=4 * n_gemms, gemm_f32_ring_ws=0)
    totals = _timed(lambda: ev.retrieve(ids[:1], mask[:1]), 1, timed)
    total = sum(totals) / len(totals)
    out["layouts"][name] = dict(
        retrieve_ms=total, retrieve_ms_each=totals,
        queries_per_s=1 / (total / 1e3), dtype="float32")
    log(f"  {name}: retrieve {total:.2f} ms "
        f"({', '.join(f'{x:.2f}' for x in totals)}); "
        f"{1 / (total / 1e3):.1f} queries/s; {card}")
    return out


# phase 5's modes: name, ModelConfig settings, EvalConfig settings, and the
# launches of each decoder kernel in one retrieve.  The bench trie's
# clusters all sit at depth 3, so pooled reps run a fifth step (widths 1,
# 31, 100, 100, 100: 5 steps x 6 layers); the others run 4
FULL_MODES = [
    ("(a) beam + decoder_avg + average", dict(concate_fusion=True),
     dict(use_query_embed_decoder_avg=True), 30),
    ("(b) beam + decoder_special + concate", dict(concate_fusion=True),
     dict(use_query_embed_decoder_special=True, fusion_strategy="concate"),
     30),
    ("(c) top_k sampling", dict(concate_fusion=True),
     dict(gen_method="top_k", temperature=1.0, sample_top_k=10,
          sample_seed=0), 24),
    ("(d) beam + slow PAWA", dict(adaptor_efficient=False), {}, 24),
]


def phase_modes(dev, card: str, trie, timed: int = 3, profile: bool = False
                ) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    beams, seq_len, qbatch = 100, 40, 32
    base = ModelConfig().scaled("base")
    g = torch.Generator(device=dev).manual_seed(7)
    store = torch.randn(N_DOCS, base.encoder_d_model, generator=g, device=dev)
    store = (store / store.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, base.vocab_size, size=(qbatch, seq_len)
                       ).astype(np.int32)
    mask = np.ones_like(ids)
    tid = torch.as_tensor(ids, device=dev)
    tmask = torch.as_tensor(mask, device=dev)
    ev_base = EvalConfig(num_beams=beams, num_return_sequences=beams,
                         max_output_length=base.max_output_length,
                         length_penalty=0.8)
    out: dict = {}
    model, model_kw = None, None
    for name, m_kw, e_kw, want_dec in FULL_MODES:
        if m_kw != model_kw:
            del model
            torch.cuda.empty_cache()
            with torch.device(dev):
                model = GenerativeRetriever(dataclasses.replace(base, **m_kw))
            model = init_weights(model.to(torch.bfloat16),
                                 torch.Generator(device=dev).manual_seed(0)
                                 ).eval()
            model_kw = m_kw
            with torch.no_grad():
                enc_ms = fmean(_timed(lambda: model.query_embedding(
                    model.encode(tid, tmask)), 1, 5))
                q_emb = model.query_embedding(model.encode(tid, tmask))
            log(f"  t5-base bf16 {m_kw}: "
                f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
                f"params")
        ev = Evaluator(model, trie, store, dataclasses.replace(ev_base,
                                                               **e_kw),
                       packed=True)
        t = time.perf_counter()
        ev.retrieve(ids, mask)                           # warm
        torch.cuda.synchronize()
        log(f"  {name}: warm retrieve {time.perf_counter() - t:.3f} s")

        # the counted run of this mode
        res, rr, launches = _counted_retrieve(
            name, ev, ids, mask,
            dict(dict.fromkeys(DECODER, want_dec), packed_scores=1),
            qbatch * beams, beams)

        torch.cuda.reset_peak_memory_stats()
        if name.startswith("(a)"):
            # the default beam path on the same model, timed in turns with
            # (a): what the fifth step and the pooling add to the decode
            ev_d = Evaluator(model, trie, store, ev_base, packed=True)
            ev_d.retrieve(ids, mask)
            totals, default = [], []
            for i in range(timed):
                turns = [(default, ev_d), (totals, ev)]
                for each, e in (turns if i % 2 else turns[::-1]):
                    each += _timed(lambda: e.retrieve(ids, mask), 0, 1)
            del ev_d
        else:
            totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the re-rank alone, on per-beam query rows where the mode has them
        q_rr = (q_emb[:, None, :].expand(-1, beams, -1).contiguous()
                if ev._want_dec else q_emb)
        rr_ms = fmean(_timed(lambda: ev.rerank(q_rr, res), 1, 5))
        if profile:
            _profile(lambda: ev.retrieve(ids, mask))
        total = sum(totals) / len(totals)
        mode = dict(retrieve_ms=total, retrieve_ms_each=totals,
                    encode_ms=enc_ms, rerank_ms=rr_ms,
                    decode_ms=total - enc_ms - rr_ms,
                    queries_per_s=qbatch / (total / 1e3), peak_gib=peak,
                    launches=launches[DECODER[0]], valid=qbatch * beams)
        log(f"  {name}: retrieve {total:.2f} ms "
            f"({', '.join(f'{x:.2f}' for x in totals)}): encode "
            f"{enc_ms:.2f} ms, decode {mode['decode_ms']:.2f} ms, re-rank "
            f"{rr_ms:.2f} ms; {mode['queries_per_s']:.1f} queries/s; peak "
            f"{peak:.2f} GiB; {card}")
        if name.startswith("(a)"):
            d_ms = sum(default) / len(default) - enc_ms - rr_ms
            mode.update(default_decode_ms=d_ms,
                        default_retrieve_ms_each=default)
            log(f"  {name}: decode {mode['decode_ms']:.2f} ms against the "
                f"default path's {d_ms:.2f} ms on the same model, in turns "
                f"({', '.join(f'{x:.2f}' for x in default)} ms retrieves): "
                f"the fifth step and the pooling add "
                f"{mode['decode_ms'] - d_ms:.2f} ms; {card}")
        if name.startswith("(d)"):
            rows = qbatch * beams
            a = torch.randn(rows, base.d_model, generator=g, device=dev
                            ).to(torch.bfloat16)
            s_ = torch.randn(rows, base.d_model, generator=g, device=dev
                             ).to(torch.bfloat16)
            with torch.no_grad():
                tr_ms = fmean(_timed(lambda: model.pawa.transform(a, s_),
                                     1, 3))
            # bound: the products of two bf16 values are exact and the sums
            # f32 on the tensor cores at the bf16 rate; the SIMT SGEMM the
            # f32 torch.matmul runs has a floor at the f32 rate
            d = base.d_model
            flops = 2 * rows * d * d * d + 2 * rows * d * d
            nbytes = d * d * d * 2 + 3 * rows * d * 2
            bound, by = _bound_ms(flops, nbytes, H100_BF16_FLOPS)
            simt, _ = _bound_ms(flops, nbytes, H100_F32_FLOPS)
            mode.update(transform_ms=tr_ms, transform_bound_ms=bound,
                        transform_simt_floor_ms=simt)
            log(f"  {name}: transform s·reshape(A·U2) at {rows} rows "
                f"{tr_ms:.2f} ms, {tr_ms / bound:.1f}x its bound {bound:.2f} "
                f"ms by {by} (exact bf16 products, f32 sums, at "
                f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s); the f32 SIMT "
                f"SGEMM's floor {simt:.2f} ms at "
                f"{H100_F32_FLOPS / 1e12:.0f} TFLOP/s; {card}")
        out[name] = mode
        del ev, res, rr
    return out


# ------------------------------------------------------------ phase 6

N_NEW = 2048                 # the bench's expansion batch (bench.py n_new)
SMALL_DOCS, SMALL_NEW = 2000, 200
WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega river "
         "mountain city music science history football film novel").split()


def _write_corpus(path: Path, n: int, rng) -> None:
    path.write_text("".join(
        f"doc {i}\t{' '.join(rng.choice(WORDS, int(rng.integers(4, 30))))}\n"
        for i in range(n)))


def _port_cli(argv: list[str], root: Path) -> subprocess.CompletedProcess:
    """``python -m gdr_tpu_torch.cli`` in a subprocess; fails on a non-zero
    exit.  Returns the finished process (its standard output and error)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-m", "gdr_tpu_torch.cli", *argv],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise Failed(f"cli {argv[0]} exited {out.returncode}:\n"
                     f"{out.stderr[-3000:]}")
    return out


def index_small(dev, root: Path, work: Path) -> dict:
    """(a): the tiny tower and Lloyd on the CPU and the card, then the CLI's
    index → expand → retrieve on the card over a 2,000-doc TSV; the TSV and
    the index stay in ``work`` (phase 7 trains over them)."""
    import numpy as np
    import torch

    from gdr_tpu_torch.index.builder import embed_corpus
    from gdr_tpu_torch.index.io import load_index
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)
    from gdr_tpu_torch.ops.kmeans import kmeans_fit

    rng = np.random.default_rng(3)
    ids = rng.integers(2, 512, size=(SMALL_DOCS, 32)).astype(np.int32)
    mask = (np.arange(32)[None] < rng.integers(4, 33, SMALL_DOCS)[:, None]
            ).astype(np.int32)
    ids *= mask
    cpu = init_doc_encoder(DocEncoder(tiny_doc_encoder_config()),
                           torch.Generator().manual_seed(0)).eval()
    gpu = DocEncoder(tiny_doc_encoder_config())
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    e_cpu = embed_corpus(cpu, ids, mask, batch_size=256)
    e_gpu = embed_corpus(gpu, ids, mask, batch_size=256)
    tower_err = float(np.abs(e_cpu - e_gpu).max())
    if not tower_err <= 1e-4:
        raise Failed(f"tiny doc tower: card and CPU differ by {tower_err:.3g}"
                     f" > 1e-4")
    x = torch.as_tensor(e_cpu)
    init = x[torch.randperm(SMALL_DOCS, generator=torch.Generator()
                            .manual_seed(1))[:30]]
    c_cpu, a_cpu = kmeans_fit(x, 30, 25, init=init)
    c_gpu, a_gpu = kmeans_fit(x.to(dev), 30, 25, init=init.to(dev))
    moved = int((a_cpu != a_gpu.cpu()).sum())
    cent_err = (c_cpu - c_gpu.cpu()).abs().max().item()
    if moved or not cent_err <= 1e-4:
        raise Failed(f"Lloyd: {moved} assignments differ between card and "
                     f"CPU, centroids by {cent_err:.3g} (tol 1e-4)")
    log(f"  (a) tiny tower f32, {SMALL_DOCS} docs: card vs CPU max |d| "
        f"{tower_err:.3g} (tol 1e-4); Lloyd k 30, 25 iterations from one "
        f"CPU init: assignments equal, centroids max |d| {cent_err:.3g} "
        f"(tol 1e-4)")

    tmp = work
    _write_corpus(tmp / "docs.tsv", SMALL_DOCS, rng)
    _write_corpus(tmp / "new.tsv", SMALL_NEW, rng)
    tower = ["--encoder-size", "tiny", "--encoder-max-len", "32",
             "--device", "cuda"]
    t = time.perf_counter()
    _port_cli(["index", "--corpus", str(tmp / "docs.tsv"), "--out",
               str(tmp / "index.npz"), *tower], root)
    _port_cli(["expand", "--index", str(tmp / "index.npz"), "--corpus",
               str(tmp / "new.tsv"), "--out", str(tmp / "index2.npz"),
               *tower], root)
    out = _port_cli(["retrieve", "--index", str(tmp / "index2.npz"),
                     "--workdir", str(tmp / "run"), "--model-size",
                     "tiny", "--beam", "20", "--top-k", "5", "--json",
                     "--packed", "--device", "cuda", "--query",
                     "alpha river music", "--query", "science novel"],
                    root).stdout
    cli_s = time.perf_counter() - t
    small, big = (load_index(str(tmp / f)) for f in ("index.npz",
                                                     "index2.npz"))
    hits = [h["doc_id"] for ln in out.splitlines() if ln.startswith("{")
            for h in json.loads(ln)["results"]]
    n_big = SMALL_DOCS + SMALL_NEW
    if len(small.paths) != SMALL_DOCS or len(big.paths) != n_big \
            or len(big.store) != n_big:
        raise Failed(f"cli: index holds {len(small.paths)} docs and the "
                     f"expanded one {len(big.paths)}, want {SMALL_DOCS} and "
                     f"{n_big}")
    for f in ("children", "eos_allowed", "depth"):
        if not np.array_equal(getattr(small.trie, f), getattr(big.trie, f)):
            raise Failed(f"cli expand changed the trie's {f}")
    if not hits or min(hits) < 0 or max(hits) >= n_big:
        raise Failed(f"cli retrieve: hits {hits} outside [0, {n_big})")
    log(f"  (a) cli on cuda: index {SMALL_DOCS} docs ({small.trie.num_nodes} "
        f"nodes, {small.trie.num_clusters} clusters, depth "
        f"{int(small.trie.depth.max())}) → expand +{SMALL_NEW} (structure "
        f"unchanged) → retrieve {len(hits)} hits in range; {cli_s:.1f} s for "
        f"the three processes")
    return dict(tower_max_abs_err=tower_err, lloyd_max_abs_err=cent_err,
                cli_s=cli_s, cli_nodes=int(small.trie.num_nodes))


def tower_cost(n_docs: int, length: int, cfg) -> tuple[float, int, int]:
    """FLOPs of the doc tower's forward over n_docs × length tokens (the
    projections, FFN and both attention products of every layer), its
    weights' element count and the bytes of its token ids and mask."""
    d, f = cfg.d_model, cfg.d_ff
    per_token = 2 * d * (4 * d + 2 * f) + 4 * length * d
    flops = n_docs * length * cfg.num_layers * per_token
    weights = cfg.num_layers * (4 * d * d + 2 * d * f) + cfg.vocab_size * d
    return flops, weights, n_docs * length * 8


def index_tower(dev, card: str, profile: bool = False) -> dict:
    """(b): the BERT-base doc tower at full width, f32 then bf16
    (``profile``: the kernels of one batch in each)."""
    import numpy as np
    import torch

    from gdr_tpu_torch.index.builder import embed_corpus
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   DocEncoderConfig,
                                                   init_doc_encoder)

    cfg = DocEncoderConfig()
    length, batch = 128, 512
    with torch.device(dev):
        tower = DocEncoder(cfg)
    tower = init_doc_encoder(tower, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(4)
    out = {}
    for dn, n_docs in (("float32", 4096), ("bfloat16", 32768)):
        dtype = getattr(torch, dn)
        tower = tower.to(dtype).eval()
        ids = rng.integers(1, cfg.vocab_size, size=(n_docs, length)
                           ).astype(np.int32)
        mask = np.ones_like(ids)
        embed_corpus(tower, ids[:batch], mask[:batch], batch_size=batch)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        emb = embed_corpus(tower, ids, mask, batch_size=batch)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        dev_s = e0.elapsed_time(e1) / 1e3
        if emb.shape != (n_docs, cfg.d_model) or not np.isfinite(emb).all():
            raise Failed(f"doc tower {dn}: {emb.shape} embeddings, not all "
                         f"finite")
        flops, w, tok = tower_cost(n_docs, length, cfg)
        peak = H100_BF16_FLOPS if dn == "bfloat16" else H100_F32_FLOPS
        nbytes = w * tower.tok_embed.weight.element_size() + tok \
            + n_docs * cfg.d_model * 4
        bound_ms, by = _bound_ms(flops, nbytes, peak)
        out[dn] = dict(docs=n_docs, wall_s=wall, device_s=dev_s,
                       docs_per_s=n_docs / wall, flops=flops,
                       bound_s=bound_ms / 1e3, bound_by=by)
        log(f"  (b) doc tower BERT-base {dn}: {n_docs} docs x {length} "
            f"tokens at batch {batch}: {wall:.3f} s wall, {dev_s:.3f} s "
            f"between CUDA events, {n_docs / wall:.0f} docs/s; "
            f"{flops:.3g} FLOPs, bound {bound_ms / 1e3:.3f} s ({by}, "
            f"{peak / 1e12:.0f} TFLOP/s); every embedding finite; {card}")
        if profile:
            log(f"  (b) {dn}: one batch of {batch}")
            _profile(lambda: embed_corpus(tower, ids[:batch], mask[:batch],
                                          batch_size=batch))
    return out


def index_kmeans(dev, card: str, profile: bool = False):
    """(c): hierarchical k-means over the NQ-scale unit store on the card:
    the index built twice, then the recursion alone (``profile``: its
    kernels).  Returns (the Index, its store on the card, the stats)."""
    import numpy as np
    import torch

    from gdr_tpu_torch.config import IndexConfig
    from gdr_tpu_torch.index.builder import build_index_from_embeddings
    from gdr_tpu_torch.ops.kmeans import hierarchical_kmeans

    cfg = IndexConfig()
    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, cfg.embedding_dim, generator=g, device=dev)
    store = store / store.norm(dim=1, keepdim=True)
    secs, built = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        built.append(build_index_from_embeddings(store, cfg))
        secs.append(time.perf_counter() - t)
    index = built[-1]
    trie = index.trie
    lens = np.array([len(p) for p in index.paths])
    digits = np.concatenate([np.asarray(p) for p in index.paths])
    leaf_docs = trie.doc_count[trie.cluster_node_ids]
    leaf_depth = trie.depth[trie.cluster_node_ids]
    if lens.min() < 1 or digits.max() >= cfg.kary or digits.min() < 0:
        raise Failed("k-means: a doc without a path, or a digit outside "
                     f"[0, {cfg.kary})")
    if (leaf_docs[leaf_depth < 8] > cfg.leaf_cap).any():
        raise Failed(f"k-means: a leaf above depth 8 holds more than "
                     f"{cfg.leaf_cap} docs")
    if int(trie.doc_count.sum()) != N_DOCS:
        raise Failed("k-means: the trie does not hold every doc once")
    same = built[0].paths == built[1].paths
    hist = np.bincount(leaf_depth).tolist()
    pass_ms = N_DOCS * cfg.embedding_dim * 4 / H100_BYTES * 1e3

    def recursion():
        return hierarchical_kmeans(
            store, kary=cfg.kary, leaf_cap=cfg.leaf_cap, iters=cfg.max_iters,
            seed=cfg.seed, minibatch_threshold=cfg.minibatch_threshold,
            minibatch_size=cfg.minibatch_size)

    t = time.perf_counter()
    recursion()
    kmeans_s = time.perf_counter() - t
    log(f"  (c) k-means kary {cfg.kary}, leaf cap {cfg.leaf_cap}, "
        f"{cfg.max_iters} iterations, minibatch at >= "
        f"{cfg.minibatch_threshold} (batch {cfg.minibatch_size}) over "
        f"{N_DOCS} x {cfg.embedding_dim} f32 unit rows: first call "
        f"{secs[0]:.2f} s, second {secs[1]:.2f} s (same paths: {same}), of "
        f"which the k-means recursion alone {kmeans_s:.2f} s and the trie, "
        f"its node embeddings and the host copy the rest; "
        f"{trie.num_nodes} nodes, {trie.num_clusters} clusters, leaves by "
        f"depth {hist}, largest leaf {int(leaf_docs.max())} docs; one pass "
        f"over the store is bound at {pass_ms:.3f} ms, so the host's "
        f"recursion sets the time; {card}")
    if profile:
        log("  (c) one k-means recursion")
        _profile(recursion)
    stats = dict(seconds=secs, kmeans_s=kmeans_s, same_paths=same,
                 nodes=int(trie.num_nodes),
                 clusters=int(trie.num_clusters), leaves_by_depth=hist,
                 largest_leaf=int(leaf_docs.max()),
                 max_depth=int(trie.depth.max()), pass_bound_ms=pass_ms)
    return index, store, stats


def index_serve_and_expand(dev, card: str, index, store) -> dict:
    """(d) t5-base bf16 retrieves over the built index's packed bf16 layout;
    (e) 2,048 new docs inserted, the layout rebuilt, the packed scorer held
    on their blocks, and a retrieve over the grown store."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.index.expand import expand_index
    from gdr_tpu_torch.kernels import rerank as KR
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    beams, seq_len, qbatch = 100, 40, 32
    cfg = ModelConfig().scaled("base")
    with torch.device(dev):
        model = GenerativeRetriever(cfg)
    model = init_weights(model.to(torch.bfloat16),
                         torch.Generator(device=dev).manual_seed(0)).eval()
    ev_cfg = EvalConfig(num_beams=beams, num_return_sequences=beams,
                        max_output_length=cfg.max_output_length)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, cfg.vocab_size, size=(qbatch, seq_len)
                       ).astype(np.int32)
    mask = np.ones_like(ids)
    ev = Evaluator(model, index.trie, store.to(torch.bfloat16), ev_cfg,
                   packed=True)
    ev.retrieve(ids, mask)                                 # warm
    kernels.reset_launch_counts()
    res, rr = ev.retrieve(ids, mask)
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    max_depth = int(index.trie.depth.max())
    layers = cfg.num_decoder_layers
    steps = got[DECODER[0]] // layers
    want = {**dict.fromkeys(got, 0),
            **dict.fromkeys(DECODER, layers * steps), "packed_scores": 1}
    log(f"  (d) launches in one retrieve over the built index: {got}")
    if got != want or not 0 < steps <= max_depth + 1:
        raise Failed(f"built index: launch counts {got}: want {layers} x "
                     f"the steps taken (at most {max_depth + 1}) per decoder "
                     f"kernel and one packed scorer")
    _check_retrieve("built index", res, rr, qbatch * beams, beams)
    totals = _timed(lambda: ev.retrieve(ids, mask), 0, 3)
    serve_ms = sum(totals) / len(totals)
    log(f"  (d) t5-base bf16 over the built index, packed bf16 "
        f"{tuple(ev.store.shape)} (cap {ev._p_cap}): {steps} steps (trie "
        f"depth {max_depth}), {qbatch * beams} valid beams, 100 valid doc "
        f"ids per query; retrieve {serve_ms:.2f} ms "
        f"({', '.join(f'{x:.2f}' for x in totals)}); {card}")

    # (e) expansion
    g = torch.Generator(device=dev).manual_seed(8)
    new = torch.randn(N_NEW, store.shape[1], generator=g, device=dev)
    new = (new / new.norm(dim=1, keepdim=True)).cpu().numpy()
    t = time.perf_counter()
    big = expand_index(index, new)
    insert_s = time.perf_counter() - t
    old, grown = index.trie, big.trie
    t = time.perf_counter()        # insert_docs' host product alone
    np.argmax(new @ old.node_embedding[old.cluster_node_ids].T, axis=1)
    argmax_s = time.perf_counter() - t
    for f in ("children", "eos_allowed", "depth", "cluster_node_ids"):
        if not np.array_equal(getattr(old, f), getattr(grown, f)):
            raise Failed(f"expansion changed the trie's {f}")
    n_all = N_DOCS + N_NEW

    def owner(tr):          # cluster row of each doc id
        rows = np.full(n_all, -1, np.int64)
        rows[tr.doc_indices] = np.repeat(np.arange(tr.num_clusters),
                                         tr.doc_count[tr.cluster_node_ids])
        return rows

    if not np.array_equal(np.bincount(grown.doc_indices, minlength=n_all),
                          np.ones(n_all, np.int64)):
        raise Failed("expansion: a doc id sits in no cluster or in two")
    own_old, own_new = owner(old), owner(grown)
    if not np.array_equal(own_old[:N_DOCS], own_new[:N_DOCS]) \
            or big.cid_of_doc[:N_DOCS] != index.cid_of_doc:
        raise Failed("expansion moved an old doc to another cluster")
    node_emb = torch.as_tensor(old.node_embedding[old.cluster_node_ids],
                               device=dev)
    sims = torch.as_tensor(new, device=dev) @ node_emb.T      # [M, C]
    joined = torch.as_tensor(own_new[N_DOCS:], device=dev)
    gap = (sims.max(1).values - sims.gather(1, joined[:, None])[:, 0]).max()
    if not gap.item() <= 1e-5:
        raise Failed(f"expansion: a new doc joined a cluster {gap.item():.3g}"
                     f" below its best node-embedding dot")
    ev2 = Evaluator(model, grown, torch.as_tensor(big.store, device=dev)
                    .to(torch.bfloat16), ev_cfg, packed=True)
    counts = grown.doc_count[grown.cluster_node_ids]
    want_cap = max(-(-int(counts.max()) // 8) * 8, 8)
    if ev2._p_cap != want_cap or ev2.store.shape[0] != \
            int((-(-counts // 8) * 8).sum()) + want_cap:
        raise Failed(f"expansion: packed layout cap {ev2._p_cap} / rows "
                     f"{ev2.store.shape[0]} not rebuilt for the grown "
                     f"clusters (cap {want_cap})")
    # the packed scorer on each new doc's block, its own row the query
    starts = ev2._p_starts[joined]
    q = torch.as_tensor(new, device=dev)
    scores = KR.packed_scores(ev2.store, starts, q, ev2._p_cap)
    plain = KR.packed_scores_plain(ev2.store, starts, q, ev2._p_cap)
    err = _close("packed_scores over the grown blocks", scores, plain,
                 "float32")
    slot = torch.arange(ev2._p_cap, device=dev)
    in_block = slot[None] < ev2._p_counts[joined][:, None]
    block_docs = ev2._p_row_to_doc[starts.long()[:, None] + slot[None]]
    mine = block_docs == torch.arange(N_DOCS, n_all, device=dev)[:, None]
    top = scores.masked_fill(~in_block, -2.0).argmax(1)
    if not bool(mine.gather(1, top[:, None]).all()):
        raise Failed("packed scorer: a new doc is not the top score of its "
                     "own block")
    res2, rr2 = ev2.retrieve(ids, mask)
    torch.cuda.synchronize()
    _check_retrieve("expanded index", res2, rr2, qbatch * beams, beams,
                    n_docs=n_all)
    joined_size = old.doc_count[old.cluster_node_ids][own_new[N_DOCS:]]
    log(f"  (e) inserted {N_NEW} docs in {insert_s:.2f} s ({argmax_s:.2f} s "
        f"of it the host's [{N_NEW}, {old.num_clusters}] product and "
        f"argmax): trie structure unchanged, each new id in one cluster, "
        f"the best by node embedding (gap <= {gap.item():.3g}; the joined "
        f"clusters held {int(np.median(joined_size))} docs at the median, "
        f"{int(joined_size.max())} at most), old docs' CIDs unchanged; "
        f"packed layout rebuilt, cap {ev._p_cap} -> {ev2._p_cap}, rows "
        f"{ev.store.shape[0]} -> {ev2.store.shape[0]}; packed scorer on the "
        f"new docs' blocks: each doc its block's top, max |d| vs plain "
        f"{err:.3g} (tol {TOL['float32'][0]} + {TOL['float32'][1]}·|plain|);"
        f" a retrieve over the {n_all}-doc store returns valid ids; {card}")
    return dict(launches=got, steps=steps, retrieve_ms=serve_ms,
                retrieve_ms_each=totals, insert_s=insert_s,
                insert_argmax_s=argmax_s, cap=[ev._p_cap, ev2._p_cap],
                packed_rows=[int(ev.store.shape[0]), int(ev2.store.shape[0])],
                packed_scores_max_abs_err=err)


def phase_index(dev, card: str, root: Path, work: Path,
                profile: bool = False) -> dict:
    out = {"small": index_small(dev, root, work),
           "tower": index_tower(dev, card, profile)}
    index, store, out["kmeans"] = index_kmeans(dev, card, profile)
    out.update(index_serve_and_expand(dev, card, index, store))
    return out


def _profile(fn) -> None:
    """Device time by kernel over one call, and the device's busy share of
    the call's wall time (torch.profiler with CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events    # kernels only
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    log(f"  profile: wall {wall:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
        f"({100 * dev_us / 1e3 / wall:.1f}%)")
    families: dict = {}                 # the port's kernels by name, the rest
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        name = (e.key.split("gdr::")[1].split("<")[0].split("(")[0]
                if "gdr::" in e.key else "PyTorch and cuBLAS kernels")
        us, n = families.get(name, (0.0, 0))
        families[name] = (us + e.self_device_time_total, n + e.count)
    log("  profile by kernel family: " + "; ".join(
        f"{k} {us / 1e3:.3f} ms ({n} launches)" for k, (us, n) in
        sorted(families.items(), key=lambda kv: -kv[1][0])))
    log(events.table(sort_by="self_device_time_total", row_limit=25,
                     max_name_column_width=60))


# ------------------------------------------------------------ phase 7

# phase 7's full-width step: TrainConfig's defaults (batch 64, so 128 rows
# after R-Drop; 11 candidates), 40 query tokens, the bench trie's labels
TRAIN_WARM, TRAIN_TIMED, TRAIN_FALL = 3, 20, 30
STAGE2_BATCH, STAGE2_TIMED, DOC_LEN = 32, 5, 128
LOOP_QUERIES, LOOP_DEV = 512, 32
SMALL_TOL = 1e-4             # losses and grad norm, card vs CPU (relative)
SMALL_PARAM_TOL = 1e-5       # f32 masters after the five steps (absolute)
# the doc tower's attention key biases have a zero gradient (a bias on the
# keys shifts all of a query's scores alike, which softmax ignores): their
# computed gradient is rounding noise, which Adam scales to steps of up to
# ±lr, so the masters comparison leaves them out.  In its place, on each
# device, their gradient at every stage-2 step stays at rounding level: at
# most KEY_BIAS_GRAD_TOL × the largest gradient of the same block's key
# weight (the CPU gives about 1.5e-7)
NOISE_ONLY = ".attn.key.bias"
KEY_BIAS_GRAD_TOL = 1e-5


def _paths_of(cid_to_docs: dict) -> list[list[int]]:
    n = sum(len(v) for v in cid_to_docs.values())
    paths = [None] * n
    for cid, docs in cid_to_docs.items():
        for d in docs:
            paths[d] = [int(c) for c in cid.split("-")]
    return paths


def _train_set(rng, paths, n: int, seq_len: int, vocab: int, mcfg):
    """n queries of random tokens (an EOS after the last real token, the
    tail of some rows padded), each with a random positive doc and its CID
    label."""
    import numpy as np

    from gdr_tpu_torch.data.dataset import TrainSet
    from gdr_tpu_torch.ops.codec import digits_to_label

    ids = rng.integers(2, vocab, size=(n, seq_len)).astype(np.int32)
    lens = rng.integers(seq_len // 2, seq_len + 1, n)
    mask = (np.arange(seq_len)[None] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    ids[np.arange(n), lens - 1] = 1
    pos = rng.integers(0, len(paths), n).astype(np.int32)
    lab = np.stack([digits_to_label(paths[d], mcfg.kary,
                                    mcfg.max_output_length)[0] for d in pos])
    return TrainSet(input_ids=ids, attn_mask=mask, labels=lab,
                    label_mask=(lab > 0).astype(np.int32), pos_idx=pos,
                    source=["gtq"] * n)


def _small_train_world(seed: int, dropout: float):
    """A small f32 config with every loss of the objective on (denoising,
    embedding and weight distillation, hard negatives, a tiny live doc
    tower from epoch 1), its index (24 clusters of 3 docs, node
    embeddings) and data."""
    import numpy as np

    from gdr_tpu_torch.config import (DataConfig, EvalConfig, GDRConfig,
                                      ModelConfig, TrainConfig)
    from gdr_tpu_torch.eval.evaluator import EvalData
    from gdr_tpu_torch.index.io import Index
    from gdr_tpu_torch.ops.trie import build_trie

    mcfg = ModelConfig(kary=4, max_output_length=5, d_model=64, d_kv=16,
                       d_ff=128, num_layers=2, num_decoder_layers=2,
                       num_heads=4, vocab_size=512, encoder_d_model=32,
                       adaptor_layer_num=1, adaptor_num_heads=2,
                       dropout_rate=dropout, input_dropout=5 * dropout,
                       denoising=True, embedding_distillation=0.5,
                       weight_distillation=0.5)
    cfg = GDRConfig(
        model=mcfg,
        data=DataConfig(max_intraclass_num=4, hard_negative=True,
                        sample_neg_num=2),
        train=TrainConfig(train_batch_size=4, stage2_train_batch_size=4,
                          eval_batch_size=6, stage2_eval_batch_size=6,
                          num_train_epochs=2, train_encoder_epoch=0,
                          bf16=False, log_every_steps=1000),
        eval=EvalConfig(num_beams=6, num_return_sequences=6,
                        max_output_length=5, score_rates=(0.0, 1.0)))
    cid_to_docs, doc = {}, 0
    for a in range(4):
        for b in range(3):
            for c in range(2):
                cid_to_docs[f"{a}-{b}-{c}"] = list(range(doc, doc + 3))
                doc += 3
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(doc, 32)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    trie = build_trie(cid_to_docs, 4, max_docs_per_cluster=8,
                      doc_embeddings=store)
    paths = _paths_of(cid_to_docs)
    index = Index(store=store, trie=trie, paths=paths,
                  cid_of_doc=["-".join(map(str, p)) for p in paths])
    ts = _train_set(rng, paths, 24, 10, 512, mcfg)
    gt = rng.integers(0, doc, 6)
    dev_data = EvalData(input_ids=ts.input_ids[:6], attn_mask=ts.attn_mask[:6],
                        gt_docs=[[str(d)] for d in gt],
                        gt_cids=[[index.cid_of_doc[d]] for d in gt])
    doc_tokens = rng.integers(1, 512, size=(doc, 16)).astype(np.int32)
    doc_mask = np.ones_like(doc_tokens)
    doc_mask[::3, 12:] = 0
    return cfg, index, ts, dev_data, doc_tokens, doc_mask


def _small_train_models(cfg, dev):
    """The same seeded small retriever and tiny doc tower (f32), on the CPU
    and on the card."""
    import torch

    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    out = []
    for device in ("cpu", dev):
        m = GenerativeRetriever(cfg.model)
        t = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
        init_weights(m, torch.Generator().manual_seed(0))
        init_doc_encoder(t, torch.Generator().manual_seed(1))
        out.append((m.to(device), t.to(device)))
    return out


def train_small(dev) -> dict:
    """(a): three stage-1 and two stage-2 steps of the small f32 model on
    the CPU and on the card from the same weights and batches (TF32 off,
    dropout 0, the denoising draws made once on the CPU and given to
    both)."""
    import numpy as np
    import torch

    from gdr_tpu_torch.data.dataset import (BatchIterator,
                                            cluster_docs_lookup,
                                            doc_label_arrays)
    from gdr_tpu_torch.ops.beam import gumbel_noise
    from gdr_tpu_torch.ops.trie import prefix_node_embeddings
    from gdr_tpu_torch.train.trainer import (_device_batch, compute_grads,
                                             init_train_state, make_loss_fn,
                                             make_train_step)
    from gdr_tpu_torch.utils.rng import generator

    cfg, index, ts, _, doc_tokens, doc_mask = _small_train_world(0, 0.0)
    mcfg = cfg.model
    dl, dm = doc_label_arrays(index.paths, mcfg)
    it = BatchIterator(ts, cluster_docs_lookup(index.cid_of_doc), 4,
                       cfg.data.max_intraclass_num, seed=0, sample_neg_num=2,
                       doc_labels=dl, doc_label_mask=dm)
    batches = list(it)[:5]
    g = torch.Generator().manual_seed(2)
    for i, b in enumerate(batches):
        pe, pm = prefix_node_embeddings(index.trie, b["labels"],
                                        b["label_mask"], mcfg.kary)
        b.update(prefix_emb=pe, prefix_emb_mask=pm)
        if i >= 3:                                  # stage 2: live tower
            b.update(pos_tokens=doc_tokens[b["pos_idx"]],
                     pos_tok_mask=doc_mask[b["pos_idx"]],
                     cand_tokens=doc_tokens[b["cand_idx"]],
                     cand_tok_mask=doc_mask[b["cand_idx"]])
    noises = [dict(denoise_keep=torch.rand(b["input_ids"].shape, generator=g)
                   < 0.9,
                   denoise_gumbel=gumbel_noise(
                       (*b["input_ids"].shape, mcfg.vocab_size), g))
              for b in batches]
    runs = []
    for device, (model, tower) in zip(("cpu", dev),
                                      _small_train_models(cfg, dev)):
        state, opt = init_train_state(cfg, model, tower, total_steps=100)
        steps = {s: make_train_step(model, tower, opt, cfg, stage=s)
                 for s in (1, 2)}
        loss2 = make_loss_fn(model, tower, cfg, stage=2)
        store = torch.as_tensor(index.store, device=device)
        mets, kb_ratio = [], 0.0
        for i, (b, nz) in enumerate(zip(batches, noises)):
            if i >= 3:
                # the step's own gradients, taken apart from it
                _, g = compute_grads(model, tower, loss2,
                                     _device_batch(b, device), store,
                                     generator(0, state.step, device), nz)
                for n, v in g.items():
                    if n.endswith(NOISE_ONLY):
                        w = g[n[:-len("bias")] + "weight"]
                        kb_ratio = max(kb_ratio, (v.abs().max()
                                                  / w.abs().max()).item())
            state, m = steps[1 if i < 3 else 2](state, b, store, 0, nz)
            mets.append({k: float(v) for k, v in m.items()})
        runs.append((state, mets, kb_ratio))
    (s_c, m_c, kb_c), (s_g, m_g, kb_g) = runs
    worst = 0.0
    for i, (a, b) in enumerate(zip(m_c, m_g)):
        if set(a) != set(b):
            raise Failed(f"train small step {i}: metrics {sorted(a)} vs "
                         f"{sorted(b)}")
        for k in a:
            rel = abs(a[k] - b[k]) / max(1.0, abs(a[k]))
            worst = max(worst, rel)
            if not rel <= SMALL_TOL:
                raise Failed(f"train small step {i}: {k} cpu {a[k]:.7g} vs "
                             f"card {b[k]:.7g} (tol {SMALL_TOL} relative)")
    diff = {n: (s_c.params[t][n] - s_g.params[t][n].cpu()).abs().max().item()
            for t in s_c.params for n in s_c.params[t]}
    p_err = max(v for n, v in diff.items() if not n.endswith(NOISE_ONLY))
    noise_err = max(v for n, v in diff.items() if n.endswith(NOISE_ONLY))
    if not (p_err <= SMALL_PARAM_TOL and kb_c <= KEY_BIAS_GRAD_TOL
            and kb_g <= KEY_BIAS_GRAD_TOL):
        raise Failed(f"train small: f32 masters differ by {p_err:.3g} after "
                     f"5 steps (tol {SMALL_PARAM_TOL}); the tower's key-bias "
                     f"gradients reach {kb_c:.3g} (cpu) / {kb_g:.3g} (card) "
                     f"of the key weights' (tol {KEY_BIAS_GRAD_TOL})")
    log(f"  (a) small f32 model, 3 stage-1 + 2 stage-2 steps (denoising, "
        f"both distillations, 2 hard negatives, tiny live tower): losses and "
        f"grad norm card vs CPU within {worst:.3g} relative (tol "
        f"{SMALL_TOL}); masters max |d| {p_err:.3g} (tol {SMALL_PARAM_TOL}) "
        f"without the tower's zero-gradient key biases, whose gradients are "
        f"{kb_c:.3g} (cpu) / {kb_g:.3g} (card) of the key weights' (tol "
        f"{KEY_BIAS_GRAD_TOL}; masters |d| {noise_err:.3g}, not gated); "
        f"losses " + ", ".join(f"{m['loss']:.4f}" for m in m_c))
    return dict(metric_rel_err=worst, param_max_abs_err=p_err,
                key_bias_grad_ratio=[kb_c, kb_g],
                key_bias_max_abs_err=noise_err,
                losses=[m["loss"] for m in m_c])


def train_step_cost(cfg, rows: int, seq: int, n_params: int
                    ) -> tuple[float, float]:
    """(FLOPs, bytes) of one stage-1 step at full width: 3 × the forward's
    matmul FLOPs (encoder over rows × seq tokens, decoder and PAWA layers
    over rows × L, U's candidate blocks) and AdamW's bytes (f32 parameter,
    gradient and two moments read, parameter and moments written)."""
    m = cfg.model
    d, dff, L = m.d_model, m.d_ff, m.max_output_length
    inner = m.num_heads * m.d_kv
    te, td = rows * seq, rows * L
    attn = lambda q, k: 2 * 2 * rows * m.num_heads * q * k * m.d_kv
    enc = m.num_layers * (2 * te * d * 3 * inner + 2 * te * inner * d
                          + attn(seq, seq) + 4 * te * d * dff)
    dec = m.num_decoder_layers * (
        2 * td * d * 3 * inner + 2 * td * inner * d + attn(L, L)
        + 2 * td * d * inner + 2 * te * d * 2 * inner + 2 * td * inner * d
        + attn(L, seq) + 4 * td * d * dff)
    pawa_ff = m.adaptor_d_ff or min(4 * d, 2048)
    pawa = m.adaptor_layer_num * (2 * td * d * 3 * d + 2 * td * d * d
                                  + attn(L, L) + 2 * 2 * td * d * d
                                  + 4 * td * d * pawa_ff)
    u = 2 * td * d * (m.kary + 1) * d + 2 * td * (m.kary + 1) * d
    return 3.0 * (enc + dec + pawa + u), 28.0 * n_params


def _finite(tag: str, m: dict) -> None:
    import math
    bad = {k: float(v) for k, v in m.items() if not math.isfinite(float(v))}
    if bad:
        raise Failed(f"{tag}: non-finite {bad}")


def _full_world(dev):
    """The full-width training world: t5-base's config at TrainConfig's
    defaults, the bench trie's paths over 334,314 docs and phase 4's unit
    store (bf16, on the card)."""
    import torch

    from gdr_tpu_torch.config import GDRConfig, ModelConfig

    cfg = GDRConfig(model=ModelConfig().scaled("base"))
    paths = _paths_of(bench_cid_map(N_DOCS, cfg.model.kary, 30))
    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, cfg.model.encoder_d_model, generator=g,
                        device=dev)
    store = (store / store.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return cfg, paths, store


def train_full(dev, card: str, world, profile: bool = False) -> dict:
    """(b) and (c): the full-width stage-1 step (timed, its bound, 30 steps
    on one batch), then the stage-2 step with the BERT-base tower."""
    import numpy as np
    import torch

    from gdr_tpu_torch.data.dataset import BatchIterator, cluster_docs_lookup
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   DocEncoderConfig,
                                                   init_doc_encoder)
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
    from gdr_tpu_torch.train.trainer import (_device_batch, compute_grads,
                                             init_train_state, make_loss_fn,
                                             make_train_step)
    from gdr_tpu_torch.utils.rng import generator

    cfg, paths, store = world
    bsz = cfg.train.train_batch_size
    rng = np.random.default_rng(11)
    ts = _train_set(rng, paths, bsz * (TRAIN_WARM + TRAIN_TIMED), S,
                    cfg.model.vocab_size, cfg.model)
    lookup = cluster_docs_lookup(["-".join(map(str, p)) for p in paths])
    batches = list(BatchIterator(ts, lookup, bsz,
                                 cfg.data.max_intraclass_num, seed=0))
    with torch.device(dev):
        model = GenerativeRetriever(cfg.model)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    state, opt = init_train_state(cfg, model, None, total_steps=10_000)
    step = make_train_step(model, None, opt, cfg, stage=1)
    out: dict = {"params_m": n_params / 1e6}
    for b in batches[:TRAIN_WARM]:
        state, m = step(state, b, store, 0)
    _finite("train full warm", m)
    feed = itertools.cycle(batches[TRAIN_WARM:])
    ms = _timed(lambda: step(state, next(feed), store, 0), 0, TRAIN_TIMED)
    mean = sum(ms) / len(ms)
    flops, nbytes = train_step_cost(cfg, 2 * bsz, S, n_params)
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    out.update(step_ms=mean, step_ms_each=ms,
               examples_per_s=bsz / (mean / 1e3), peak_gib=peak,
               flops=flops, optimizer_bytes=nbytes, bound_ms=t_ops + t_bytes,
               bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)
    state, m = step(state, batches[0], store, 0)
    _finite("train full", m)
    log(f"  (b) t5-base stage 1, {n_params / 1e6:.1f}M params, bf16 over "
        f"f32 masters, batch {bsz} ({2 * bsz} rows after R-Drop) x {S} "
        f"tokens, {cfg.data.max_intraclass_num + 1} candidates: step "
        f"{mean:.2f} ms (min {min(ms):.2f}, max {max(ms):.2f}; {TRAIN_TIMED} "
        f"timed after {TRAIN_WARM} warm), {out['examples_per_s']:.1f} "
        f"examples/s, peak {peak:.2f} GiB; loss {float(m['loss']):.4f}, "
        f"grad norm {float(m['grad_norm']):.4f}; {card}")
    log(f"  (b) bound: {flops / 1e12:.3f} TFLOP (3 x forward matmuls) in "
        f"{t_ops:.3f} ms at 989 TFLOP/s + AdamW {nbytes / 1e9:.2f} GB in "
        f"{t_bytes:.3f} ms at 3.35 TB/s = {t_ops + t_bytes:.3f} ms; the step "
        f"takes {mean / (t_ops + t_bytes):.1f}x it")
    if profile:
        _profile(lambda: step(state, batches[1], store, 0))
    fall = []
    for _ in range(TRAIN_FALL):
        state, m = step(state, batches[0], store, 0)
        fall.append(float(m["loss"]))
    first, last = sum(fall[:5]) / 5, sum(fall[-5:]) / 5
    out.update(fall_losses=fall, fall_ratio=last / first)
    if not (all(np.isfinite(fall)) and last < first):
        raise Failed(f"train full: the loss on one fixed batch did not fall "
                     f"in {TRAIN_FALL} steps: {fall}")
    log(f"  (b) {TRAIN_FALL} steps on one batch: loss {fall[0]:.4f} -> "
        f"{fall[-1]:.4f}; mean of the last 5 / first 5 = "
        f"{last / first:.3f}")

    # (c) stage 2: the BERT-base tower trains live
    del state, opt, step
    torch.cuda.empty_cache()
    with torch.device(dev):
        tower = DocEncoder(DocEncoderConfig())
    init_doc_encoder(tower, torch.Generator(device=dev).manual_seed(1))
    doc_tokens = rng.integers(1, tower.cfg.vocab_size,
                              size=(N_DOCS, DOC_LEN)).astype(np.int32)
    doc_mask = np.ones_like(doc_tokens)
    batches = list(BatchIterator(ts, lookup, STAGE2_BATCH,
                                 cfg.data.max_intraclass_num, seed=1))
    for b in batches:
        b.update(pos_tokens=doc_tokens[b["pos_idx"]],
                 pos_tok_mask=doc_mask[b["pos_idx"]],
                 cand_tokens=doc_tokens[b["cand_idx"]],
                 cand_tok_mask=doc_mask[b["cand_idx"]])
    torch.cuda.reset_peak_memory_stats()
    state, opt = init_train_state(cfg, model, tower, total_steps=10_000)
    step = make_train_step(model, tower, opt, cfg, stage=2)
    for b in batches[:TRAIN_WARM]:
        state, m = step(state, b, store, 0)
    _finite("train stage 2", m)
    feed = itertools.cycle(batches[TRAIN_WARM:])
    ms2 = _timed(lambda: step(state, next(feed), store, 0), 0, STAGE2_TIMED)
    mean2 = sum(ms2) / len(ms2)
    peak2 = torch.cuda.max_memory_allocated() / 2**30
    docs = STAGE2_BATCH * (cfg.data.max_intraclass_num + 2)
    out.update(stage2_step_ms=mean2, stage2_step_ms_each=ms2,
               stage2_peak_gib=peak2, stage2_docs_per_step=docs)
    tower_m = sum(p.numel() for p in tower.parameters()) / 1e6
    log(f"  (c) stage 2, t5-base + BERT-base tower ({tower_m:.1f}M), "
        f"batch {STAGE2_BATCH}: {docs} docs x {DOC_LEN} tokens per step: "
        f"step {mean2:.2f} ms ({', '.join(f'{x:.1f}' for x in ms2)}), peak "
        f"{peak2:.2f} GiB; loss {float(m['loss']):.4f}; {card}")
    del state, opt, step, model, tower
    torch.cuda.empty_cache()
    return out


def _same_state(tag: str, a, b) -> None:
    """Two train states equal bit for bit: masters, moments, counts."""
    import torch
    for t in a.params:
        for n, x in a.params[t].items():
            if not torch.equal(x, b.params[t][n]):
                raise Failed(f"{tag}: master {t}/{n} differs")
    for part in ("mu", "nu"):
        for k, x in a.opt_state[part].items():
            if not torch.equal(x, b.opt_state[part][k]):
                raise Failed(f"{tag}: AdamW {part} of {k} differs")
    if (a.step, a.opt_state["count"]) != (b.step, b.opt_state["count"]):
        raise Failed(f"{tag}: steps {a.step}/{a.opt_state['count']} vs "
                     f"{b.step}/{b.opt_state['count']}")


def train_loop(dev, card: str, root: Path, work: Path, world) -> dict:
    """(d): TrainLoop at full width for one short epoch with its eval and
    checkpoints; at small size on the card, two epochs in one run against
    one epoch and a resumed one (dropout on), and a mid-epoch preemption;
    the CLI's train → eval on phase 6's index."""
    import os

    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.eval.evaluator import EvalData
    from gdr_tpu_torch.index.io import Index
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)
    from gdr_tpu_torch.train.loop import TrainLoop
    from gdr_tpu_torch.utils.preemption import PreemptionGuard

    cfg, paths, store = world
    cid_of_doc = ["-".join(map(str, p)) for p in paths]
    trie = build_nq_scale_trie(N_DOCS, cfg.model.kary, 30, 64)
    index = Index(store=store.float().cpu().numpy(), trie=trie, paths=paths,
                  cid_of_doc=cid_of_doc)
    rng = np.random.default_rng(12)
    ts = _train_set(rng, paths, LOOP_QUERIES, S, cfg.model.vocab_size,
                    cfg.model)
    gt = rng.integers(0, N_DOCS, LOOP_DEV)
    dev_data = EvalData(
        input_ids=ts.input_ids[:LOOP_DEV], attn_mask=ts.attn_mask[:LOOP_DEV],
        gt_docs=[[str(d)] for d in gt], gt_cids=[[cid_of_doc[d]] for d in gt])
    full_cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, num_train_epochs=1,
                                  eval_batch_size=LOOP_DEV,
                                  train_encoder_epoch=99),
        eval=EvalConfig(max_output_length=cfg.model.max_output_length))
    t = time.perf_counter()
    loop = TrainLoop(full_cfg, index, ts, dev_data, str(work / "loop"),
                     seed=0, packed_eval=True, device=dev)
    init_s = time.perf_counter() - t
    kernels.reset_launch_counts()
    t = time.perf_counter()
    loop.run(max_epochs=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    got = kernels.launch_counts()
    want = {**dict.fromkeys(got, 0), **dict.fromkeys(DECODER, 24),
            "packed_scores": 1}
    log(f"  (d) TrainLoop t5-base: launches over the epoch and its eval: "
        f"{got}")
    if got != want:
        raise Failed(f"TrainLoop eval: launch counts {got} != {want} (one "
                     f"retrieve of {LOOP_DEV} queries)")
    met = loop.last_epoch_metrics
    files = [work / "loop" / "ckpt" / "0.pt",
             work / "loop" / "ckpt_preempt" / "1.pt"]
    sizes = [os.path.getsize(f) / 1e9 for f in files]
    saves = dict(loop.save_seconds)
    if loop.state.step != LOOP_QUERIES // cfg.train.train_batch_size \
            or not np.isfinite(met["avg_train_loss"]):
        raise Failed(f"TrainLoop: {loop.state.step} steps, loss "
                     f"{met['avg_train_loss']}")
    out = dict(loop_init_s=init_s, loop_run_s=run_s,
               loop_epoch_s=met["epoch_seconds"],
               loop_retrieve_ms=met["retrieve_mean_ms"],
               loop_launches=got, checkpoint_gb=sizes,
               checkpoint_s=[saves["best"], saves["resume"]])
    log(f"  (d) TrainLoop t5-base, {LOOP_QUERIES} queries = "
        f"{loop.state.step} steps: init {init_s:.1f} s, run {run_s:.1f} s "
        f"(epoch {met['epoch_seconds']:.2f} s, eval retrieve "
        f"{met['retrieve_mean_ms']:.1f} ms for {LOOP_DEV} queries, recall1 "
        f"{met['recall1']:.3f}); checkpoints best {saves['best']:.2f} s "
        f"{sizes[0]:.2f} GB, resume point {saves['resume']:.2f} s "
        f"{sizes[1]:.2f} GB; {card}")
    del loop
    for f in files:
        f.unlink()
    torch.cuda.empty_cache()

    # resume bit for bit, small, dropout on (deterministic kernels)
    scfg, sindex, sts, sdev, dtok, dmask = _small_train_world(1, 0.1)

    def small_loop(name: str) -> TrainLoop:
        tower = DocEncoder(tiny_doc_encoder_config(scfg.model.encoder_d_model))
        init_doc_encoder(tower, torch.Generator().manual_seed(1))
        return TrainLoop(scfg, sindex, sts, sdev, str(work / name), seed=3,
                         doc_tokens=dtok, doc_tok_mask=dmask,
                         doc_encoder=tower, device=dev)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = small_loop("rA")
        a.run(max_epochs=2)
        small_loop("rB").run(max_epochs=1)
        b = small_loop("rB")
        if b.start_epoch != 1:
            raise Failed(f"resume: start epoch {b.start_epoch}, want 1")
        b.run(max_epochs=2)
        _same_state("resume", a.state, b.state)
        # a preemption after the first step of epoch 1 re-runs epoch 1
        small_loop("rC").run(max_epochs=1)
        c = small_loop("rC")
        guard = PreemptionGuard(signals=())
        guard.request_stop()
        c.run(max_epochs=2, guard=guard)
        spe = len(sts) // scfg.train.train_batch_size
        c2 = small_loop("rC")
        if (c.state.step, c2.start_epoch, c2.state.step) != (spe + 1, 1,
                                                              spe + 1):
            raise Failed(f"preemption: {c.state.step} steps at the stop, "
                         f"resumed at epoch {c2.start_epoch} step "
                         f"{c2.state.step}; want {spe + 1}, 1, {spe + 1}")
        c2.run(max_epochs=2)
        if c2.state.step != 2 * spe + 1:
            raise Failed(f"preemption: {c2.state.step} steps after the "
                         f"re-run epoch, want {2 * spe + 1}")
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"  (d) small f32 on the card, dropout 0.1, input dropout 0.5, "
        f"stage 2 from epoch 1: two epochs in one run == one epoch + a "
        f"resumed one, bit for bit ({a.state.step} steps; masters and "
        f"moments); a stop after epoch 1's first step resumed at epoch 1 and "
        f"re-ran it ({c2.state.step} steps)")

    # the CLI: train → eval on phase 6's 2,000-doc index, on the card
    qrng = np.random.default_rng(13)
    for name, n in (("train.tsv", 256), ("dev.tsv", 16)):
        rows = [(" ".join(qrng.choice(WORDS, 5)),
                 int(qrng.integers(0, SMALL_DOCS))) for _ in range(n)]
        (work / name).write_text("".join(f"{q}\t{d}\n" for q, d in rows))
    common = ["--index", str(work / "index.npz"), "--dev",
              str(work / "dev.tsv"), "--workdir", str(work / "cli"),
              "--model-size", "tiny", "--beam", "20", "--max-input-length",
              "16", "--device", "cuda"]
    t = time.perf_counter()
    _port_cli(["train", *common, "--train", str(work / "train.tsv"),
               "--batch-size", "32", "--epochs", "2",
               "--train-encoder-epoch", "0", "--corpus",
               str(work / "docs.tsv"), "--encoder-size", "tiny",
               "--encoder-max-len", "32", "--packed-eval"], root)
    ev = _port_cli(["eval", *common, "--packed"], root)
    cli_s = time.perf_counter() - t
    if f"loaded {work / 'cli' / 'params.npz'}" not in ev.stderr:
        raise Failed(f"cli eval did not read the trained params.npz:\n"
                     f"{ev.stderr[-2000:]}")
    ev_m = json.loads(ev.stdout[ev.stdout.index("{"):])
    if not np.isfinite(ev_m["recall1"]):
        raise Failed(f"cli eval: recall1 {ev_m['recall1']}")
    log(f"  (d) cli on cuda: train (tiny, 2 epochs, stage 2 from epoch 1, "
        f"{SMALL_DOCS}-doc index) -> eval of its params.npz (recall1 "
        f"{ev_m['recall1']:.3f}); {cli_s:.1f} s for the two processes")
    out.update(cli_s=cli_s)
    return out


def phase_train(dev, card: str, root: Path, work: Path,
                profile: bool = False) -> dict:
    out = {"small": train_small(dev)}
    world = _full_world(dev)
    out.update(train_full(dev, card, world, profile))
    out.update(train_loop(dev, card, root, work, world))
    return out


# ------------------------------------------------------------ phase 8

# phase 8's full-width sizes: query generation (64 docs x 64 tokens, 5
# queries each, a 40-position cache), the modes' step batch and their eval
MODE_BATCH, MODE_WARM, MODE_TIMED = 64, 2, 5


def _small_secondary_world():
    """A small f32 config (dropout 0), a synthetic task of 40 docs (its
    k-means trie) as an index and dev set, and an extra assignment."""
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.data.synthetic import build_synthetic_task
    from gdr_tpu_torch.eval.evaluator import EvalData
    from gdr_tpu_torch.index.io import Index

    mcfg = ModelConfig(kary=4, max_output_length=5, d_model=64, d_kv=16,
                       d_ff=128, num_layers=2, num_decoder_layers=2,
                       num_heads=4, vocab_size=256, encoder_d_model=32,
                       adaptor_layer_num=1, adaptor_num_heads=2,
                       dropout_rate=0.0)
    task = build_synthetic_task(n_docs=40, dim=32, kary=4, leaf_cap=4,
                                seq_len=10, vocab_size=256,
                                max_output_length=5, seed=3)
    index = Index(task.store, task.trie, task.paths, task.cid_of_doc)
    dev_data = EvalData(task.input_ids[:12], task.attn_mask[:12],
                        task.gt_docs[:12], task.gt_cids[:12])
    return mcfg, task, index, dev_data


def _card_vs_cpu(tag: str, got, want) -> float:
    """max |card - cpu| of two tensors, held to the f32 tolerance."""
    return _close(tag, got.detach().float().cpu(), want.detach().float().cpu(),
                  "float32")


def secondary_small(dev, work: Path) -> dict:
    """(a): the small f32 world on the CPU and on the card from the same
    weights: qg tokens from one noise, an ensemble step (N = 2) and its
    eval, hierarchic decode + re-rank, the classifier's logits and step."""
    import numpy as np
    import torch

    from gdr_tpu_torch.models import ensemble as E
    from gdr_tpu_torch.models import hierarchic as HI
    from gdr_tpu_torch.models.classifier import EncoderClassifier
    from gdr_tpu_torch.models.seq2seq import Seq2SeqLM, generate_queries
    from gdr_tpu_torch.models.t5 import init_t5_weights
    from gdr_tpu_torch.ops.beam import gumbel_noise
    from gdr_tpu_torch.ops.rerank import rerank
    from gdr_tpu_torch.train import modes as MO

    mcfg, task, index, dev_data = _small_secondary_world()
    errs: dict = {}
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(task.input_ids[:6])
    msk = torch.as_tensor(task.attn_mask[:6])

    # qg: 6 docs x 2 queries, a 40-position cache, one Gumbel draw for both
    noise = gumbel_noise((QG_L, 12, mcfg.vocab_size),
                         torch.Generator().manual_seed(9))
    toks = []
    for device in ("cpu", dev):
        m = init_t5_weights(Seq2SeqLM(mcfg), torch.Generator().manual_seed(0))
        toks.append(generate_queries(m.to(device), ids.to(device),
                                     msk.to(device), 2, QG_L, top_k=10,
                                     noise=noise)[0].cpu())
    if not torch.equal(toks[0], toks[1]):
        raise Failed(f"qg small: card tokens differ from the cpu's at "
                     f"{int((toks[0] != toks[1]).sum())} slots")

    # ensemble: one step from the same weights and batch, then its eval
    ens_dir = work / "ensemble_small"
    ens_dir.mkdir()
    paths = MO.alternative_assignments(index, 2, 4, 4, seed=0, device="cpu")
    np.save(ens_dir / "ensemble_paths.npy", MO.paths_to_array(paths))
    labels = MO._member_labels(paths, task.pos_idx[:8], mcfg)
    batch = {"input_ids": task.input_ids[:8], "attn_mask": task.attn_mask[:8],
             "labels": labels, "label_mask": (labels != 0).astype(np.int32)}
    ens, losses, metrics = [], [], []
    for device in ("cpu", dev):
        e = E.init_ensemble(mcfg, 2, torch.Generator().manual_seed(1))
        e = e.to(device)
        step = E.make_ensemble_train_step(
            e, MO.ensemble_optimizer(e, 1e-3, 5e-4), rdrop=0.1)
        losses.append(step({k: torch.as_tensor(v, device=device)
                            for k, v in batch.items()},
                           torch.Generator(device=device).manual_seed(2))[1])
        metrics.append(MO.eval_ensemble(mcfg, index, dev_data, str(ens_dir),
                                        2, beam=6, batch_size=6,
                                        device=device, ens=e))
        ens.append(e)
    errs["ensemble_loss"] = _card_vs_cpu("ensemble per-member losses",
                                           losses[1], losses[0])
    errs["ensemble_params"] = max(
        _card_vs_cpu(f"ensemble {k}", v, ens[0].state_dict()[k])
        for k, v in ens[1].state_dict().items())
    if metrics[0] != metrics[1]:
        raise Failed(f"ensemble eval: card metrics {metrics[1]} != cpu "
                     f"{metrics[0]}")

    # hierarchic: decode + re-rank
    trie = index.trie
    out = []
    for device in ("cpu", dev):
        h = HI.init_hierarchic(mcfg, int(trie.depth.max()),
                               torch.Generator().manual_seed(3)).to(device)
        t = [torch.as_tensor(a, device=device) for a in (
            trie.children, trie.eos_allowed, trie.cluster_of_node,
            trie.cluster_docs, trie.cluster_doc_mask)]
        res, q = HI.hierarchic_generate_cids(h, ids.to(device),
                                             msk.to(device), t[0], t[1],
                                             num_beams=6, max_len=5)
        rr = rerank(torch.as_tensor(index.store, device=device), q,
                    res.nodes, res.scores, res.valid, *t[2:],
                    torch.zeros(1, device=device), top_r=6)
        out.append((res, rr))
    (rc, rrc), (rg, rrg) = out
    if not (torch.equal(rc.valid, rg.valid.cpu()) and torch.equal(
            rc.nodes[rc.valid], rg.nodes.cpu()[rc.valid])
            and torch.equal(rrc.doc_ids[rrc.doc_valid],
                            rrg.doc_ids.cpu()[rrc.doc_valid])):
        raise Failed("hierarchic small: card beams or doc ids differ from "
                     "the cpu's")
    errs["hierarchic_scores"] = max(
        _card_vs_cpu("hierarchic beam scores", rg.scores[rg.valid],
                       rc.scores[rc.valid]),
        _card_vs_cpu("hierarchic fused scores", rrg.scores[rrg.doc_valid],
                       rrc.scores[rrc.doc_valid]))

    # classifier: logits, then one step
    y = torch.as_tensor(rng.integers(0, trie.num_clusters, 6))
    cls, lg = [], []
    for device in ("cpu", dev):
        c = init_t5_weights(EncoderClassifier(mcfg, trie.num_clusters),
                            torch.Generator().manual_seed(4)).to(device)
        with torch.no_grad():
            lg.append(c(ids.to(device), msk.to(device)))
        MO.softmax_train_step(c, MO.AdamW(c, {"all": (1e-3, 1e-4)}),
                              ids.to(device), msk.to(device), y.to(device),
                              torch.Generator(device=device).manual_seed(5))
        cls.append(c)
    errs["classifier_logits"] = _card_vs_cpu("classifier logits", lg[1],
                                               lg[0])
    errs["classifier_params"] = max(
        _card_vs_cpu(f"classifier {k}", v, cls[0].state_dict()[k])
        for k, v in cls[1].state_dict().items())
    log(f"  (a) small f32, card vs cpu: qg tokens equal ({QG_L}-position "
        f"cache, 12 rows); ensemble step + eval, hierarchic decode + "
        f"re-rank, classifier logits + step: max |d| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {TOL['float32'][0]} + {TOL['float32'][1]}·|cpu|); "
        f"ensemble eval metrics equal")
    return errs


def _launches_exactly(tag: str, want: dict) -> dict:
    """The launch counts since the last reset; fails unless they are
    ``want`` (0 for kernels it does not name)."""
    import torch

    from gdr_tpu_torch import kernels

    torch.cuda.synchronize()
    got = kernels.launch_counts()
    if got != {**dict.fromkeys(got, 0), **want}:
        raise Failed(f"{tag}: launch counts {got}, want {want}")
    return got


def secondary_qg(dev, card: str, profile: bool = False) -> dict:
    """(b): query generation at t5-base: 64 docs x 64 tokens, 5 queries
    each (320 rows), top-k 10, a 40-position cache.  In f32, as ``cli qg``
    runs it: launches, tokens checked, time, peak and (``profile``) the
    profile; then the same weights cast to bf16, checked and timed beside
    it (no entry point generates in bf16)."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.seq2seq import EOS, PAD, Seq2SeqLM, \
        generate_queries
    from gdr_tpu_torch.models.t5 import init_t5_weights

    cfg = ModelConfig().scaled("base")
    with torch.device(dev):
        model = Seq2SeqLM(cfg)
    init_t5_weights(model, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(1)
    docs = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                        (QG_DOCS, QG_DOC_LEN)), device=dev)
    mask = torch.ones_like(docs)
    rows = QG_DOCS * QG_PER_DOC

    def run():
        return generate_queries(
            model, docs, mask, QG_PER_DOC, QG_L,
            torch.Generator(device=dev).manual_seed(7), top_k=10)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        model.to(dtype)
        run()                                              # warm
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        toks, src = run()
        launches = _launches_exactly(
            f"qg {dn}", dict.fromkeys(DECODER, QG_L * cfg.num_decoder_layers))
        toks, src = toks.cpu().numpy(), src.cpu().numpy()
        if toks.shape != (rows, QG_L) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise Failed(f"qg {dn}: tokens {toks.shape} in [{toks.min()}, "
                         f"{toks.max()}]")
        if not np.array_equal(src, np.repeat(np.arange(QG_DOCS),
                                             QG_PER_DOC)):
            raise Failed(f"qg {dn}: source rows are not 5 per doc in order")
        for row in toks:
            eos = np.flatnonzero(row == EOS)
            if len(eos) and (row[eos[0] + 1:] != PAD).any():
                raise Failed(f"qg {dn}: a token after EOS is not PAD")
        ms = _timed(run, 0, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if profile and dtype == torch.float32:
            _profile(run)
        out[dn] = dict(ms=fmean(ms), ms_each=ms, rows=rows, steps=QG_L,
                       row_steps_per_s=rows * QG_L / (fmean(ms) / 1e3),
                       tokens_before_eos=int(sum(
                           (np.flatnonzero(r == EOS)[:1].tolist()
                            or [QG_L])[0] for r in toks)),
                       peak_gib=peak, launches=launches)
        log(f"  (b) qg t5-base {dn}: {QG_DOCS} docs x {QG_DOC_LEN} tokens, "
            f"{QG_PER_DOC} queries each ({rows} rows), {QG_L} steps: "
            f"{fmean(ms):.2f} ms ({', '.join(f'{x:.1f}' for x in ms)}), "
            f"{out[dn]['row_steps_per_s']:.0f} row-steps/s, peak "
            f"{peak:.2f} GiB; launches {launches}; {card}")
    del model
    torch.cuda.empty_cache()
    return {**out["float32"], "bfloat16": out["bfloat16"]}


def _bench_index(dev, trie):
    """The bench trie over phase 4's unit store (host f32, as an index
    holds it)."""
    import torch

    from gdr_tpu_torch.index.io import Index

    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, 768, generator=g, device=dev)
    store = (store / store.norm(dim=1, keepdim=True)).cpu().numpy()
    paths = _paths_of(bench_cid_map(N_DOCS, trie.kary, 30))
    return Index(store, trie, paths, ["-".join(map(str, p)) for p in paths])


def _dev_queries(rng, n: int, vocab: int, index):
    """n dev queries of S random tokens, each with a random doc."""
    import numpy as np

    from gdr_tpu_torch.eval.evaluator import EvalData

    ids = rng.integers(2, vocab, size=(n, S)).astype(np.int32)
    gt = rng.integers(0, len(index.paths), n)
    return EvalData(ids, np.ones_like(ids), [[str(d)] for d in gt],
                    [[index.cid_of_doc[d]] for d in gt])


def secondary_ensemble(dev, card: str, index, work: Path) -> dict:
    """(c): ``train --ensemble 3`` at t5-base (f32, R-Drop 0.1): its two
    extra k-means assignments on the card, timed steps at batch 64, then
    ``eval_ensemble`` of 32 queries at beam 100, each member over its own
    trie and the plain store."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.eval import evaluator as EV
    from gdr_tpu_torch.models import ensemble as E
    from gdr_tpu_torch.train import modes as MO
    from gdr_tpu_torch.utils.rng import generator

    n, beams = 3, 100
    cfg = ModelConfig().scaled("base")
    t = time.perf_counter()
    paths_list = MO.alternative_assignments(index, n, cfg.kary, 30, seed=42,
                                            device=dev)
    kmeans_s = time.perf_counter() - t
    depths = [max(len(p) for p in paths) for paths in paths_list]
    ens_dir = work / "ensemble_full"
    ens_dir.mkdir()
    np.save(ens_dir / "ensemble_paths.npy", MO.paths_to_array(paths_list))
    ens = E.init_ensemble(cfg, n, torch.Generator(device=dev).manual_seed(42))
    n_params = sum(p.numel() for p in ens.parameters())
    rng = np.random.default_rng(2)
    ts = _train_set(rng, index.paths, MODE_BATCH * (MODE_WARM + MODE_TIMED),
                    S, cfg.vocab_size, cfg)
    labels = MO._member_labels(paths_list, ts.pos_idx, cfg)
    step = E.make_ensemble_train_step(
        ens, MO.ensemble_optimizer(ens, 2e-4, 1e-4), rdrop=cfg.rdrop,
        rdrop_loss=cfg.rdrop_loss)
    batches = iter(range(MODE_WARM + MODE_TIMED))
    losses = []

    def one_step():
        i = next(batches)
        sl = slice(i * MODE_BATCH, (i + 1) * MODE_BATCH)
        b = {"input_ids": ts.input_ids[sl], "attn_mask": ts.attn_mask[sl],
             "labels": labels[:, sl],
             "label_mask": (labels[:, sl] != 0).astype(np.int32)}
        loss, _ = step({k: torch.as_tensor(v, device=dev)
                        for k, v in b.items()}, generator(49, i, dev))
        losses.append(float(loss))

    torch.cuda.reset_peak_memory_stats()
    ms = _timed(one_step, MODE_WARM, MODE_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise Failed(f"ensemble: losses {losses}")
    log(f"  (c) train --ensemble {n} t5-base f32 ({n_params / 1e6:.1f}M "
        f"params, R-Drop {cfg.rdrop}): k-means of the 2 extra assignments "
        f"{kmeans_s:.1f} s (depths {depths}); step at batch {MODE_BATCH} "
        f"{fmean(ms):.1f} ms ({', '.join(f'{x:.1f}' for x in ms)}), peak "
        f"{peak:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; {card}")

    dev_data = _dev_queries(np.random.default_rng(3), B, cfg.vocab_size,
                            index)
    seen = []
    real = EV.Evaluator.retrieve

    def recording(self, *a, **k):
        out = real(self, *a, **k)
        seen.append(out)
        return out

    EV.Evaluator.retrieve = recording
    try:
        kernels.reset_launch_counts()
        t = time.perf_counter()
        metrics = MO.eval_ensemble(cfg, index, dev_data, str(ens_dir), n,
                                   beam=beams, batch_size=B, device=dev,
                                   ens=ens)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        got = kernels.launch_counts()
    finally:
        EV.Evaluator.retrieve = real
    n_dec = got[DECODER[0]]
    most = sum(6 * (d + 1) for d in depths)
    if any(got[k] != n_dec for k in DECODER) or got["rerank_scores"] != n \
            or got["packed_scores"] or got["packed_scores_int8"] \
            or n_dec % 6 or not 6 * 2 * n <= n_dec <= most:
        raise Failed(f"eval --ensemble: launches {got}; want one "
                     f"rerank_scores per member and 6 x steps (at most "
                     f"{most}) per decoder kernel")
    for i, (res, rr) in enumerate(seen):
        _check_retrieve(f"ensemble member {i}", res, rr, B * beams, beams)
    log(f"  (c) eval --ensemble {n}: {B} queries x {S} tokens, beam {beams}: "
        f"{eval_s:.2f} s (3 tries built over {N_DOCS} docs included); "
        f"launches {got}; recall100 {metrics['recall100']:.4f}; {card}")
    out = dict(step_ms=fmean(ms), step_ms_each=ms, peak_gib=peak,
               n_params=n_params, kmeans_s=kmeans_s, depths=depths,
               eval_s=eval_s, launches=got, losses=losses)
    del ens, step
    torch.cuda.empty_cache()
    return out


def secondary_hierarchic(dev, card: str, index, profile: bool = False
                         ) -> dict:
    """(d): ``train --hierarchic`` at t5-base over the bench trie (depth 3,
    f32): timed steps at batch 64, then decode + re-rank of 32 queries at
    beam 100 over the plain store."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models import hierarchic as HI
    from gdr_tpu_torch.ops.rerank import rerank
    from gdr_tpu_torch.train import modes as MO

    beams = 100
    cfg = ModelConfig().scaled("base")
    trie = index.trie
    depth = int(trie.depth.max())
    h = HI.init_hierarchic(cfg, depth,
                           torch.Generator(device=dev).manual_seed(42))
    opt = MO.AdamW(h, {"all": (2e-4, MO.OPTAX_ADAMW_WD)})
    rng = np.random.default_rng(4)
    ts = _train_set(rng, index.paths, MODE_BATCH * (MODE_WARM + MODE_TIMED),
                    S, cfg.vocab_size, cfg)
    batches = iter(range(MODE_WARM + MODE_TIMED))
    losses = []

    def one_step():
        i = next(batches)
        sl = slice(i * MODE_BATCH, (i + 1) * MODE_BATCH)
        b = {k: torch.as_tensor(getattr(ts, k)[sl], device=dev)
             for k in ("input_ids", "attn_mask", "labels", "label_mask")}
        losses.append(float(MO.hierarchic_train_step(h, opt, b)))

    torch.cuda.reset_peak_memory_stats()
    ms = _timed(one_step, MODE_WARM, MODE_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise Failed(f"hierarchic: losses {losses}")

    t = [torch.as_tensor(a, device=dev) for a in (
        trie.children, trie.eos_allowed, trie.cluster_of_node,
        trie.cluster_docs, trie.cluster_doc_mask)]
    store = torch.as_tensor(index.store, device=dev)
    alphas = torch.zeros(1, device=dev)
    ids = torch.as_tensor(np.random.default_rng(5).integers(
        2, cfg.vocab_size, (B, S)), device=dev)
    msk = torch.ones_like(ids)

    def decode():
        res, q = HI.hierarchic_generate_cids(
            h, ids, msk, t[0], t[1], num_beams=beams,
            max_len=cfg.max_output_length, length_penalty=0.8)
        return res, rerank(store, q, res.nodes, res.scores, res.valid,
                           *t[2:], alphas, top_r=beams)

    decode()                                               # warm
    kernels.reset_launch_counts()
    res, rr = decode()
    launches = _launches_exactly("hierarchic decode + re-rank",
                                 {"rerank_scores": 1})
    _check_retrieve("hierarchic", res, rr, B * beams, beams)
    dms = _timed(decode, 0, 3)
    if profile:
        _profile(decode)
    log(f"  (d) train --hierarchic t5-base f32, {depth} decoder stacks: step "
        f"at batch {MODE_BATCH} {fmean(ms):.1f} ms "
        f"({', '.join(f'{x:.1f}' for x in ms)}), peak {peak:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; decode + re-rank of {B} "
        f"queries at beam {beams}: {fmean(dms):.1f} ms "
        f"({', '.join(f'{x:.1f}' for x in dms)}); launches {launches}; "
        f"{card}")
    out = dict(step_ms=fmean(ms), step_ms_each=ms, peak_gib=peak,
               decode_rerank_ms=fmean(dms), decode_rerank_ms_each=dms,
               launches=launches, losses=losses, depth=depth)
    del h, opt, store
    torch.cuda.empty_cache()
    return out


def secondary_softmax(dev, card: str, index) -> dict:
    """(e): ``train --softmax`` at t5-base (f32): classes are the bench
    trie's clusters; timed steps at batch 64, then the top-100 ranking of
    32 queries."""
    import numpy as np
    import torch

    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.classifier import EncoderClassifier
    from gdr_tpu_torch.models.t5 import init_t5_weights
    from gdr_tpu_torch.train import modes as MO

    cfg = ModelConfig().scaled("base")
    trie = index.trie
    n_cls = trie.num_clusters
    with torch.device(dev):
        model = EncoderClassifier(cfg, n_cls)
    init_t5_weights(model, torch.Generator(device=dev).manual_seed(42))
    opt = MO.AdamW(model, {"all": (2e-4, MO.OPTAX_ADAMW_WD)})
    rng = np.random.default_rng(6)
    ids = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                       (MODE_BATCH, S)), device=dev)
    msk = torch.ones_like(ids)
    y = torch.as_tensor(rng.integers(0, n_cls, MODE_BATCH), device=dev)
    losses = []
    steps = iter(range(MODE_WARM + MODE_TIMED))

    def one_step():
        gen = torch.Generator(device=dev).manual_seed(next(steps))
        losses.append(float(MO.softmax_train_step(model, opt, ids, msk, y,
                                                  gen)))

    torch.cuda.reset_peak_memory_stats()
    ms = _timed(one_step, MODE_WARM, MODE_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise Failed(f"softmax: losses {losses}")
    cids = [trie.cid_of_node(int(nd)) for nd in trie.cluster_node_ids]
    dev_data = _dev_queries(np.random.default_rng(7), B, cfg.vocab_size,
                            index)
    preds = MO.rank_clusters(model, dev_data, cids, B)
    if len(preds) != B or any(len(v) != 100 or len(set(v)) != 100
                              for v in preds.values()):
        raise Failed("softmax: a query's ranking is not 100 distinct "
                     "clusters")
    rms = _timed(lambda: MO.rank_clusters(model, dev_data, cids, B), 1, 3)
    log(f"  (e) train --softmax t5-base f32, {n_cls} classes: step at batch "
        f"{MODE_BATCH} {fmean(ms):.1f} ms "
        f"({', '.join(f'{x:.1f}' for x in ms)}), peak {peak:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; rank of {B} queries "
        f"{fmean(rms):.2f} ms; {card}")
    out = dict(step_ms=fmean(ms), step_ms_each=ms, peak_gib=peak,
               rank_ms=fmean(rms), rank_ms_each=rms, classes=n_cls,
               losses=losses)
    del model, opt
    torch.cuda.empty_cache()
    return out


def secondary_cli(root: Path, work: Path) -> dict:
    """(f): the CLI on the card over phase 6's 2,000-doc index and phase
    7's TSVs: ``qg`` (tiny, 2 queries per doc, a 40-position cache) →
    ``train --qg``, and ``train --ensemble 2`` → ``eval --ensemble 2``."""
    import numpy as np

    model = ["--model-size", "tiny", "--device", "cuda"]
    common = ["--index", str(work / "index.npz"), "--dev",
              str(work / "dev.tsv"), "--beam", "20", "--max-input-length",
              "16", *model]
    t = time.perf_counter()
    qg = _port_cli(["qg", "--corpus", str(work / "docs.tsv"), "--out",
                    str(work / "qg.npz"), "--train", str(work / "train.tsv"),
                    "--qg-epochs", "1", "--n-per-doc", "2", "--doc-length",
                    "32", "--max-query-length", str(QG_L), *model], root)
    with np.load(work / "qg.npz") as z:
        n_q = len(z["query_tokens"])
    if n_q != 2 * SMALL_DOCS or f"{n_q} pseudo-queries" not in qg.stdout:
        raise Failed(f"cli qg: {n_q} pseudo-queries, want {2 * SMALL_DOCS}")
    tr = _port_cli(["train", *common, "--train", str(work / "train.tsv"),
                    "--workdir", str(work / "cli_qg"), "--batch-size", "64",
                    "--epochs", "1", "--qg", str(work / "qg.npz")], root)
    if f"+ {n_q} qg = " not in tr.stderr:
        raise Failed(f"cli train --qg did not mix the pseudo-queries:\n"
                     f"{tr.stderr[-2000:]}")
    qg_s = time.perf_counter() - t
    t = time.perf_counter()
    te = _port_cli(["train", *common, "--train", str(work / "train.tsv"),
                    "--workdir", str(work / "cli_ens"), "--batch-size", "32",
                    "--epochs", "1", "--ensemble", "2"], root)
    ev = _port_cli(["eval", *common, "--workdir", str(work / "cli_ens"),
                    "--ensemble", "2"], root)
    ens_s = time.perf_counter() - t
    m_tr = json.loads(te.stdout[te.stdout.index("{"):])
    m_ev = json.loads(ev.stdout[ev.stdout.index("{"):])
    if m_tr != m_ev:
        raise Failed("cli eval --ensemble 2 disagrees with the metrics of "
                     "train --ensemble 2's own eval")
    log(f"  (f) cli on cuda: qg ({n_q} pseudo-queries) -> train --qg: "
        f"{qg_s:.1f} s; train --ensemble 2 -> eval --ensemble 2 (recall100 "
        f"{m_ev['recall100']:.3f}, equal to train's): {ens_s:.1f} s")
    return dict(qg_train_s=qg_s, ensemble_s=ens_s)


def phase_secondary(dev, card: str, root: Path, work: Path, trie,
                    profile: bool = False) -> dict:
    out = {"small": secondary_small(dev, work)}
    out["qg"] = secondary_qg(dev, card, profile)
    index = _bench_index(dev, trie)
    out["ensemble"] = secondary_ensemble(dev, card, index, work)
    out["hierarchic"] = secondary_hierarchic(dev, card, index, profile)
    out["softmax"] = secondary_softmax(dev, card, index)
    out["cli"] = secondary_cli(root, work)
    return out


# ------------------------------------------------------------ phase 9

# checkpoint directories written by hand (the script needs no
# transformers to write them): config.json leaves out each field equal to
# its class's default, as a HuggingFace config may
T5_CONFIG_DEFAULTS = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048,
                          num_layers=6, num_heads=8)
BERT_CONFIG_DEFAULTS = dict(vocab_size=30522, hidden_size=768,
                            num_hidden_layers=12, num_attention_heads=12,
                            intermediate_size=3072,
                            max_position_embeddings=512)
T5_BASE = dict(vocab_size=32128, d_model=D, d_kv=DKV, d_ff=DFF,
               num_layers=12, num_heads=H)
BERT_BASE = dict(BERT_CONFIG_DEFAULTS)
T5_SMALL = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                num_heads=4)                  # phase 3's small encoder
BERT_SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=64)
NQ_FIXTURES = ("tests/fixtures/nq_tiny_train.jsonl.gz",
               "tests/fixtures/nq_tiny_dev.jsonl.gz")


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header (padded with spaces to 8 bytes) and each tensor's bytes."""
    import torch

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64"}
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little"))
        fh.write(raw)
        for t in tensors.values():
            fh.write(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                     .data)


def write_hf_checkpoint(path: Path, config: dict, tensors: dict,
                        fmt: str) -> int:
    """``config.json`` and ``model.safetensors`` (``fmt`` "safetensors") or
    ``pytorch_model.bin`` ("bin"); returns the directory's bytes."""
    import torch

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config, indent=2))
    if fmt == "safetensors":
        write_safetensors(path / "model.safetensors", tensors)
    else:
        torch.save(tensors, path / "pytorch_model.bin")
    return sum(f.stat().st_size for f in path.iterdir())


def write_vocab(path: Path, size: int) -> None:
    """A WordPiece ``vocab.txt`` of ``size`` entries and the
    ``tokenizer_config.json`` that names it, so the directory is its own
    tokenizer where ``transformers`` is installed, with the checkpoint's
    vocabulary size (a T5 directory would hold a sentencepiece model,
    which this script cannot write; the sizes are what the CLI checks)."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS]
    words += [f"w{i}" for i in range(size - len(words))]
    (path / "vocab.txt").write_text("\n".join(words) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))


def _normal(g, dtype):
    import torch

    def rn(*shape, std: float, mean: float = 0.0):
        return (torch.randn(shape, generator=g) * std + mean).to(dtype)
    return rn


def write_t5_checkpoint(path: Path, widths: dict, seed: int, fmt: str,
                        dtype=None) -> dict:
    """A T5 encoder checkpoint (shared embeddings + encoder under HF names)
    of ``widths`` with seeded weights; returns its tensors."""
    import torch

    rn = _normal(torch.Generator().manual_seed(seed), dtype or torch.float32)
    d, ff = widths["d_model"], widths["d_ff"]
    inner = widths["num_heads"] * widths["d_kv"]
    sd = {"shared.weight": rn(widths["vocab_size"], d, std=0.5),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
          "weight": rn(32, widths["num_heads"], std=0.1)}
    for i in range(widths["num_layers"]):
        hf = f"encoder.block.{i}.layer"
        for p in "qkv":
            sd[f"{hf}.0.SelfAttention.{p}.weight"] = rn(inner, d,
                                                        std=d ** -0.5)
        sd[f"{hf}.0.SelfAttention.o.weight"] = rn(d, inner, std=inner ** -0.5)
        sd[f"{hf}.0.layer_norm.weight"] = rn(d, std=0.05, mean=1.0)
        sd[f"{hf}.1.DenseReluDense.wi.weight"] = rn(ff, d, std=d ** -0.5)
        sd[f"{hf}.1.DenseReluDense.wo.weight"] = rn(d, ff, std=ff ** -0.5)
        sd[f"{hf}.1.layer_norm.weight"] = rn(d, std=0.05, mean=1.0)
    sd["encoder.final_layer_norm.weight"] = rn(d, std=0.05, mean=1.0)
    config = {"architectures": ["T5EncoderModel"], "model_type": "t5",
              **{k: v for k, v in widths.items()
                 if T5_CONFIG_DEFAULTS[k] != v}}
    write_hf_checkpoint(path, config, sd, fmt)
    return sd


def write_bert_checkpoint(path: Path, widths: dict, seed: int,
                          fmt: str) -> dict:
    """A BERT checkpoint (BertModel's names, with its int64
    ``position_ids`` buffer) of ``widths`` (BertConfig's names) with seeded
    weights; returns its tensors."""
    import torch

    rn = _normal(torch.Generator().manual_seed(seed), torch.float32)
    d, ff = widths["hidden_size"], widths["intermediate_size"]
    pos = widths["max_position_embeddings"]
    sd = {"embeddings.word_embeddings.weight": rn(widths["vocab_size"], d,
                                                  std=0.02),
          "embeddings.position_embeddings.weight": rn(pos, d, std=0.02),
          "embeddings.token_type_embeddings.weight": rn(2, d, std=0.02),
          "embeddings.LayerNorm.weight": rn(d, std=0.02, mean=1.0),
          "embeddings.LayerNorm.bias": rn(d, std=0.02),
          "embeddings.position_ids": torch.arange(pos)[None]}
    for i in range(widths["num_hidden_layers"]):
        hf = f"encoder.layer.{i}"
        for name, shape in (("attention.self.query", (d, d)),
                            ("attention.self.key", (d, d)),
                            ("attention.self.value", (d, d)),
                            ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (ff, d)),
                            ("output.dense", (d, ff))):
            sd[f"{hf}.{name}.weight"] = rn(*shape, std=0.02)
            sd[f"{hf}.{name}.bias"] = rn(shape[0], std=0.02)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{hf}.{name}.weight"] = rn(d, std=0.02, mean=1.0)
            sd[f"{hf}.{name}.bias"] = rn(d, std=0.02)
    config = {"architectures": ["BertModel"], "model_type": "bert",
              **{k: v for k, v in widths.items()
                 if BERT_CONFIG_DEFAULTS[k] != v}}
    write_hf_checkpoint(path, config, sd, fmt)
    return sd


def _bert_port_name(hf: str) -> str:
    """A BertModel parameter's name in the port's DocEncoder."""
    for a, b in (("embeddings.word_embeddings", "tok_embed"),
                 ("embeddings.position_embeddings", "pos_embed"),
                 ("embeddings.token_type_embeddings", "type_embed"),
                 ("embeddings.LayerNorm", "embed_ln"),
                 ("encoder.layer.", "blocks."),
                 ("attention.self.", "attn."),
                 ("attention.output.dense", "attn.out"),
                 ("attention.output.LayerNorm", "ln1"),
                 ("intermediate.dense", "ff1"),
                 ("output.dense", "ff2"),
                 ("output.LayerNorm", "ln2")):
        hf = hf.replace(a, b)
    return hf


def fork_state_dict(cfg, seed: int) -> dict:
    """Seeded weights of ``cfg`` under the reference fork's names: its
    ``T5ForConditionalGeneration`` (encoder, decoder with a cross-attention
    relative bias), ``decode_embeddings``, ``lm_head`` and the efficient
    PAWA adaptor (``nn.TransformerDecoderLayer``s, zero biases), as numpy
    f32 arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
    v, heads = cfg.decode_vocab_size, cfg.num_heads
    buckets = cfg.relative_attention_num_buckets
    ad_ff = cfg.adaptor_d_ff or 4 * d
    sd: dict = {}

    def put(name, *shape, std=0.1, mean=0.0):
        sd[name] = (rng.normal(size=shape) * std + mean).astype(np.float32)

    def zero(name, n):
        sd[name] = np.zeros(n, np.float32)

    put("shared.weight", cfg.vocab_size, d, std=0.5)
    put("decode_embeddings.weight", v, d, std=0.5)
    put("lm_head.weight", v, d)
    rel = "relative_attention_bias.weight"
    for side, n in (("encoder", cfg.num_layers),
                    ("decoder", cfg.num_decoder_layers)):
        subs = ["0.SelfAttention"] + (["1.EncDecAttention"]
                                      if side == "decoder" else [])
        put(f"{side}.final_layer_norm.weight", d, std=0.05, mean=1.0)
        put(f"{side}.block.0.layer.0.SelfAttention.{rel}", buckets, heads)
        for i in range(n):
            hf = f"{side}.block.{i}.layer"
            for sub in subs:
                for p in "qkv":
                    put(f"{hf}.{sub}.{p}.weight", inner, d)
                put(f"{hf}.{sub}.o.weight", d, inner)
            for j in range(len(subs) + 1):
                put(f"{hf}.{j}.layer_norm.weight", d, std=0.05, mean=1.0)
            put(f"{hf}.{len(subs)}.DenseReluDense.wi.weight", cfg.d_ff, d)
            put(f"{hf}.{len(subs)}.DenseReluDense.wo.weight", d, cfg.d_ff)
    put(f"decoder.block.0.layer.1.EncDecAttention.{rel}", buckets, heads)
    put("adaptor_embeddings", 1, 1, d)
    for i in range(cfg.adaptor_layer_num):
        hf = f"adaptor.layers.{i}"
        for attn in ("self_attn", "multihead_attn"):
            put(f"{hf}.{attn}.in_proj_weight", 3 * d, d)
            zero(f"{hf}.{attn}.in_proj_bias", 3 * d)
            put(f"{hf}.{attn}.out_proj.weight", d, d)
            zero(f"{hf}.{attn}.out_proj.bias", d)
        put(f"{hf}.linear1.weight", ad_ff, d)
        zero(f"{hf}.linear1.bias", ad_ff)
        put(f"{hf}.linear2.weight", d, ad_ff)
        zero(f"{hf}.linear2.bias", d)
        for n in (1, 2, 3):
            put(f"{hf}.norm{n}.weight", d, std=0.05, mean=1.0)
            put(f"{hf}.norm{n}.bias", d, std=0.05)
    put("adaptor_linear.weight", d * v, d, std=0.05)
    return sd


def _equal_states(tag: str, got: dict, want: dict) -> None:
    import torch
    if got.keys() != want.keys():
        raise Failed(f"{tag}: parameter names differ")
    for k in want:
        if not torch.equal(got[k].cpu(), want[k].cpu()):
            raise Failed(f"{tag}: {k} differs")


def pretrained_small(dev, work: Path) -> dict:
    """(a): a tiny T5 directory (bf16 safetensors) and a tiny BERT one
    (pytorch_model.bin) load on the card and on the CPU, bit-equal to each
    other and to the file's tensors; the tower's CLS rows on the card
    within 1e-4 of the CPU's; the reference fork's full model through
    ``load_gdr_reference`` retrieves on the card as on the CPU."""
    import numpy as np
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models import convert
    from gdr_tpu_torch.models.dual_encoder import DocEncoder, DocEncoderConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    cfg, trie, store, ids, mask, _ = _small_world(0)
    t5_sd = write_t5_checkpoint(work / "t5_small", T5_SMALL, 31,
                                "safetensors", torch.bfloat16)
    bert_sd = write_bert_checkpoint(work / "bert_small", BERT_SMALL, 32,
                                    "bin")
    cfg = dataclasses.replace(cfg, **convert.t5_model_overrides(
        str(work / "t5_small")))
    init = init_weights(GenerativeRetriever(cfg),
                        torch.Generator().manual_seed(0)).state_dict()

    def model_on(device, load):
        with torch.device(device):
            m = GenerativeRetriever(cfg)
        m.load_state_dict(init)
        return load(m).eval()

    def t5(m):
        return convert.load_t5_encoder(m, convert.state_dict_from_pretrained(
            str(work / "t5_small")), cfg.num_layers)

    cpu, gpu = model_on("cpu", t5), model_on(dev, t5)
    _equal_states("t5 small: card vs cpu", gpu.state_dict(), cpu.state_dict())
    exported = convert.export_t5_encoder(cpu.state_dict(), cfg.num_layers)
    _equal_states("t5 small: loaded vs file",
                  {k: torch.from_numpy(v) for k, v in exported.items()},
                  {k: v.float() for k, v in t5_sd.items()})

    tcfg = DocEncoderConfig(**convert.bert_model_overrides(
        str(work / "bert_small")))
    towers = []
    for device in ("cpu", dev):
        with torch.device(device):
            tower = DocEncoder(tcfg)
        towers.append(convert.load_bert_encoder(
            tower, convert.bert_state_dict_from_pretrained(
                str(work / "bert_small"))).eval())
    _equal_states("bert small: card vs cpu", towers[1].state_dict(),
                  towers[0].state_dict())
    _equal_states("bert small: loaded vs file", towers[0].state_dict(),
                  {_bert_port_name(k): v for k, v in bert_sd.items()
                   if k != "embeddings.position_ids"})
    rng = np.random.default_rng(33)
    tids = torch.as_tensor(rng.integers(1, 512, size=(64, 32)))
    tmask = (torch.arange(32)[None] < torch.as_tensor(
        rng.integers(4, 33, size=64))[:, None]).long()
    with torch.no_grad():
        cls_c = towers[0](tids, tmask)
        cls_g = towers[1](tids.to(dev), tmask.to(dev)).cpu()
    cls_err = (cls_c - cls_g).abs().max().item()
    if not cls_err <= 1e-4:
        raise Failed(f"bert small: CLS rows on the card differ from the "
                     f"CPU's by {cls_err:.3g} > 1e-4")

    fork = fork_state_dict(cfg, 34)
    cpu_f = model_on("cpu", lambda m: convert.load_gdr_reference(m, fork))
    gpu_f = model_on(dev, lambda m: convert.load_gdr_reference(m, fork))
    ev_cfg = EvalConfig(num_beams=12, num_return_sequences=20,
                        max_output_length=cfg.max_output_length)
    res_c, rr_c = Evaluator(cpu_f, trie, store, ev_cfg,
                            packed=True).retrieve(ids, mask)
    ev_g = Evaluator(gpu_f, trie, store, ev_cfg, packed=True)
    kernels.reset_launch_counts()
    res_g, rr_g = ev_g.retrieve(ids, mask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if min(launches[k] for k in (*DECODER, "packed_scores")) == 0:
        raise Failed(f"fork small: the card's retrieve did not reach every "
                     f"kernel of its path: {launches}")
    n_valid, n_docs, err = _same_retrieve("fork packed", res_c, rr_c, res_g,
                                          rr_g)
    log(f"  (a) t5 {T5_SMALL['d_model']}-wide bf16 safetensors and bert "
        f"{BERT_SMALL['hidden_size']}-wide .bin: loads on card and cpu "
        f"bit-equal to each other and to the files; CLS rows max |d| "
        f"{cls_err:.3g} (tol 1e-4); the fork's model through "
        f"load_gdr_reference: {n_valid} valid beams, {n_docs} valid docs "
        f"equal on card and cpu, fused scores max |d| {err:.3g} (tol 1e-4), "
        f"launches {launches}")
    return dict(cls_max_abs_err=cls_err, fork_max_abs_err=err)


def pretrained_full(dev, card: str, trie, work: Path, timed: int = 3
                    ) -> dict:
    """(b): a t5-base-shaped encoder checkpoint (safetensors) and a
    BERT-base one (pytorch_model.bin): bytes and load seconds (read, map,
    move to the card), then the warm-started t5-base in f32 retrieves over
    phase 4's packed f32 store as ``cli retrieve --packed`` serves it."""
    import numpy as np
    import torch

    from gdr_tpu_torch.config import EvalConfig, ModelConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.models import convert
    from gdr_tpu_torch.models.dual_encoder import DocEncoder, DocEncoderConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    t = time.perf_counter()
    t5_dir, bert_dir = work / "t5_base", work / "bert_base"
    t5_sd = write_t5_checkpoint(t5_dir, T5_BASE, 41, "safetensors")
    write_bert_checkpoint(bert_dir, BERT_BASE, 42, "bin")
    write_vocab(t5_dir, T5_BASE["vocab_size"])
    write_vocab(bert_dir, BERT_BASE["vocab_size"])
    size = {n: sum(f.stat().st_size for f in p.iterdir())
            for n, p in (("t5", t5_dir), ("bert", bert_dir))}
    write_s = time.perf_counter() - t

    cfg = dataclasses.replace(ModelConfig().scaled("base"),
                              **convert.t5_model_overrides(str(t5_dir)))
    model = init_weights(GenerativeRetriever(cfg),
                         torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t = time.perf_counter()
    sd = convert.state_dict_from_pretrained(str(t5_dir))
    read_s = time.perf_counter() - t
    convert.load_t5_encoder(model, sd, cfg.num_layers)
    model = model.to(dev).eval()
    torch.cuda.synchronize()
    t5_s = time.perf_counter() - t
    last = cfg.num_layers - 1
    qkv = model.state_dict()[f"encoder.blocks.{last}.attn.qkv.weight"].cpu()
    hf = f"encoder.block.{last}.layer.0.SelfAttention"
    if not torch.equal(model.shared.weight.cpu(), t5_sd["shared.weight"]) \
            or not torch.equal(qkv, torch.cat([t5_sd[f"{hf}.{p}.weight"]
                                               for p in "qkv"])):
        raise Failed("t5-base: the card's weights are not the file's")
    del sd, t5_sd

    tower = DocEncoder(DocEncoderConfig(**convert.bert_model_overrides(
        str(bert_dir))))
    t = time.perf_counter()
    bsd = convert.bert_state_dict_from_pretrained(str(bert_dir))
    bread_s = time.perf_counter() - t
    tower = convert.load_bert_encoder(tower, bsd).to(dev).eval()
    torch.cuda.synchronize()
    bert_s = time.perf_counter() - t
    del bsd, tower
    log(f"  (b) t5-base encoder dir {size['t5'] / 1e6:.1f} MB (safetensors "
        f"f32): load {t5_s:.2f} s (read {read_s:.2f} s); BERT-base dir "
        f"{size['bert'] / 1e6:.1f} MB (pytorch_model.bin f32): load "
        f"{bert_s:.2f} s (read {bread_s:.2f} s); writing both took "
        f"{write_s:.1f} s")

    beams, qbatch = 100, 32
    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, D, generator=g, device=dev)
    store = store / store.norm(dim=1, keepdim=True)
    ev = Evaluator(model, trie, store, EvalConfig(
        num_beams=beams, num_return_sequences=beams,
        max_output_length=cfg.max_output_length, length_penalty=0.8),
        packed=True)
    del store
    rng = np.random.default_rng(0)
    ids = rng.integers(2, cfg.vocab_size, size=(qbatch, S)).astype(np.int32)
    mask = np.ones_like(ids)
    torch.cuda.reset_peak_memory_stats()
    ev.retrieve(ids, mask)                               # warm
    _, _, launches = _counted_retrieve(
        "warm-started packed f32", ev, ids, mask,
        dict(dict.fromkeys(DECODER, 24), packed_scores=1), qbatch * beams,
        beams)
    totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
    total = fmean(totals)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  (b) t5-base f32 warm-started from the directory, packed f32 "
        f"store: retrieve {total:.2f} ms "
        f"({', '.join(f'{x:.2f}' for x in totals)}), {qbatch} queries x "
        f"{S} tokens, beam {beams}; peak {peak:.2f} GiB; {card}")
    return dict(t5_dir_bytes=size["t5"], bert_dir_bytes=size["bert"],
                t5_load_s=t5_s, t5_read_s=read_s, bert_load_s=bert_s,
                bert_read_s=bread_s, write_s=write_s, retrieve_ms=total,
                retrieve_ms_each=totals, peak_gib=peak,
                launches=launches, t5_dir=str(t5_dir),
                bert_dir=str(bert_dir))


def pretrained_cli(root: Path, work: Path, t5_dir: str, bert_dir: str
                   ) -> dict:
    """(c): the CLI on the card: ``ingest`` of the NQ fixtures → ``index
    --bert-ckpt`` (the BERT-base directory) → ``train --t5-ckpt --bert-ckpt``
    (stage 2 from the first epoch: the live BERT-base tower) → ``eval`` of
    the trained ``params.npz``, each process timed."""
    import importlib.metadata

    import numpy as np

    from gdr_tpu_torch.data.tokenize import load_tokenizer

    try:
        found = f"transformers {importlib.metadata.version('transformers')}"
    except importlib.metadata.PackageNotFoundError:
        found = "no transformers"
    toks = {n: load_tokenizer(p) for n, p in (("t5", t5_dir),
                                              ("bert", bert_dir))}
    log(f"  (c) {found}; the directories as tokenizers: " + ", ".join(
        f"{n} {type(tk).__name__} of {tk.vocab_size}"
        for n, tk in toks.items()))
    out_dir, run = work / "ingest", work / "ingest_run"
    secs = {}

    def cli(argv):
        t = time.perf_counter()
        done = _port_cli(argv, root)
        secs[argv[0]] = time.perf_counter() - t
        return done

    ing = cli(["ingest", "--nq-jsonl", str(root / NQ_FIXTURES[0]),
               "--dev-jsonl", str(root / NQ_FIXTURES[1]), "--out-dir",
               str(out_dir)])
    if "ingest: 12 docs, 24 train, 6 dev" not in ing.stdout:
        raise Failed(f"cli ingest: {ing.stdout.strip()}")
    idx = cli(["index", "--corpus", str(out_dir / "corpus.tsv"), "--out",
               str(out_dir / "index.npz"), "--kary", "4", "--leaf-cap", "4",
               "--bert-ckpt", bert_dir, "--device", "cuda"])
    if "index: 12 docs" not in idx.stdout \
            or f"doc tower from {bert_dir}" not in idx.stderr:
        raise Failed(f"cli index --bert-ckpt: {idx.stdout.strip()}\n"
                     f"{idx.stderr[-2000:]}")
    common = ["--index", str(out_dir / "index.npz"), "--dev",
              str(out_dir / "dev.tsv"), "--workdir", str(run), "--kary", "4",
              "--beam", "10", "--device", "cuda"]
    tr = cli(["train", *common, "--train", str(out_dir / "train.tsv"),
              "--batch-size", "8", "--epochs", "1", "--train-encoder-epoch",
              "0", "--corpus", str(out_dir / "corpus.tsv"), "--t5-ckpt",
              t5_dir, "--bert-ckpt", bert_dir, "--packed-eval"])
    for want in ("stage 2 enabled: live doc tower over 12 docs",
                 f"doc tower from {bert_dir}",
                 f"encoder and shared embeddings from {t5_dir}"):
        if want not in tr.stderr:
            raise Failed(f"cli train: no {want!r} in\n{tr.stderr[-2000:]}")
    m_tr = json.loads(tr.stdout.splitlines()[-1])
    # eval takes the tokenizer train took from the checkpoint directory
    ev = cli(["eval", *common, "--packed", "--tokenizer", t5_dir])
    if f"loaded {run / 'params.npz'}" not in ev.stderr:
        raise Failed(f"cli eval did not read the trained params.npz:\n"
                     f"{ev.stderr[-2000:]}")
    m_ev = json.loads(ev.stdout[ev.stdout.index("{"):])
    bad = [k for k, v in {**m_tr, **m_ev}.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad or not 0.0 <= m_ev["recall1"] <= 1.0:
        raise Failed(f"cli chain: non-finite metrics {bad}")
    shutil.rmtree(run, ignore_errors=True)
    log(f"  (c) cli on cuda: ingest (12 docs, 24 train, 6 dev) -> index "
        f"--bert-ckpt -> train --t5-ckpt --bert-ckpt (1 epoch, stage 2, "
        f"train loss {m_tr['avg_train_loss']:.4f}) -> eval (recall1 "
        f"{m_ev['recall1']:.3f}, {len(m_ev)} metrics, all finite); "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return dict(cli_s=sum(secs.values()), cli_s_each=secs,
                recall1=m_ev["recall1"])


def phase_pretrained(dev, card: str, root: Path, work: Path, trie) -> dict:
    # phase 7's full-width checkpoints are read no more: their disk goes to
    # this phase's t5-base run
    shutil.rmtree(work / "loop", ignore_errors=True)
    out = {"small": pretrained_small(dev, work)}
    full = pretrained_full(dev, card, trie, work)
    out["cli"] = pretrained_cli(root, work, full.pop("t5_dir"),
                                full.pop("bert_dir"))
    out.update(full)
    return out


# ------------------------------------------------------------ phase 10

# the sharded store: four ranks share the one card over gloo (NCCL refuses
# two ranks on one device), or take a card each over nccl where the machine
# has four; the mesh shapes of (a), and the layouts of (b)
# with the scorer each rank launches once a retrieve
MESH_RANKS = 4
MESH_CFGS = {"dp4": dict(dp=4), "dp2xmp2": dict(dp=2, mp=2)}
MESH_SMALL_LAYOUTS = ("plain", "packed", "packed int8")
MESH_LAYOUTS = [("packed f32", dict(packed=True), "packed_scores"),
                ("plain f32", {}, "rerank_scores"),
                ("packed int8", dict(packed=True, quantize=True),
                 "packed_scores_int8")]
SCORER_OF = {"plain": "rerank_scores", "packed": "packed_scores",
             "packed int8": "packed_scores_int8"}
RANK_TIMEOUT = 900           # seconds for every rank's whole run
MESH_TOL = 1e-5


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _arrays(res, rr) -> dict:
    """The parts of a retrieve that the comparisons read, on the host."""
    return dict(valid=res.valid.cpu().numpy(), nodes=res.nodes.cpu().numpy(),
                doc_ids=rr.doc_ids.cpu().numpy(),
                scores=rr.scores.cpu().numpy(),
                doc_valid=rr.doc_valid.cpu().numpy())


def _same_merged(tag: str, got: dict, want: dict, tol: float,
                 beams: bool = True) -> float:
    """A sharded retrieve against a one-device one: beams (where asked),
    valid doc ids equal, fused scores within ``tol``; returns max |d|.
    Docs whose fused scores tie exactly may come in either order (the
    layouts list candidates in other orders), and a tie at the end of a
    full row may keep either doc."""
    import numpy as np

    if beams:
        v = want["valid"]
        if not (np.array_equal(got["valid"], v)
                and np.array_equal(got["nodes"][v], want["nodes"][v])):
            raise Failed(f"sharded {tag}: beams differ from one device's")
    dv = want["doc_valid"]
    if not np.array_equal(got["doc_valid"], dv):
        raise Failed(f"sharded {tag}: doc validity differs from one "
                     f"device's")
    gi, wi = got["doc_ids"], want["doc_ids"]
    for a, b in {tuple(x[:2]) for x in np.argwhere((gi != wi) & dv)}:
        v = dv[a, b]
        ws, gs = want["scores"][a, b][v], got["scores"][a, b][v]
        keep = ws != ws[-1] if v.all() else np.ones(len(ws), bool)
        if sorted(zip(-gs[keep], gi[a, b][v][keep])) != sorted(
                zip(-ws[keep], wi[a, b][v][keep])):
            raise Failed(f"sharded {tag}: doc ids differ from one device's "
                         f"(alpha {a}, query {b})")
    err = float(np.abs(got["scores"][dv] - want["scores"][dv]).max())
    if not err <= tol:
        raise Failed(f"sharded {tag}: fused scores differ by {err:.3g} > "
                     f"{tol:g}")
    return err


def _full_inputs(cfg):
    """Phase 4's queries and EvalConfig."""
    import numpy as np

    from gdr_tpu_torch.config import EvalConfig

    rng = np.random.default_rng(0)
    ids = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ev_cfg = EvalConfig(num_beams=100, num_return_sequences=100,
                        max_output_length=cfg.max_output_length,
                        length_penalty=0.8)
    return ids, np.ones_like(ids), ev_cfg


def _full_f32_model(dev):
    """Phase 4's t5-base f32 model, seeded on the card."""
    import torch

    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    cfg = ModelConfig().scaled("base")
    with torch.device(dev):
        model = GenerativeRetriever(cfg)
    return cfg, init_weights(model, torch.Generator(device=dev).manual_seed(0)
                             ).eval()


def _rank_small(dev) -> dict:
    """(a) in one rank: phase 3's small model retrieves over the sharded
    store on the card and on the CPU, each mesh shape and layout, with the
    launches of each card retrieve."""
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig, MeshConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.parallel.mesh import make_mesh

    cfg, trie, store, ids, mask, _ = _small_world(0)
    ev_cfg = EvalConfig(num_beams=12, num_return_sequences=20,
                        max_output_length=cfg.max_output_length)
    cpu_model, gpu_model = _small_models(cfg, dev)
    out = {}
    for mesh_name, mcfg in MESH_CFGS.items():
        for where, model in (("card", gpu_model), ("cpu", cpu_model)):
            mesh = make_mesh(MeshConfig(**mcfg), device=model.device)
            for layout in MESH_SMALL_LAYOUTS:
                ev = Evaluator(model, trie, store, ev_cfg, mesh=mesh,
                               **SMALL_LAYOUTS[layout])
                kernels.reset_launch_counts()
                res, rr = ev.retrieve(ids, mask)
                torch.cuda.synchronize()
                out[mesh_name, where, layout] = dict(
                    _arrays(res, rr), launches=kernels.launch_counts(),
                    rows=int((ev.store.values if ev.quantize
                              else ev.store).shape[0]))
    return out


def _rank_full(dev, trie, store_path: str, timed: int) -> dict:
    """(b) in one rank: t5-base f32 over its shard of phase 4's store (a
    memory map of the parent's copy), on each layout: the bytes it holds,
    the launches of one retrieve, ``timed`` retrieves after a warm one, the
    merge alone, and the peak over all of it."""
    import numpy as np
    import torch
    import torch.distributed

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import MeshConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.parallel.mesh import make_mesh
    from gdr_tpu_torch.parallel.store import gather_merge

    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model = _full_f32_model(dev)
    ids, mask, ev_cfg = _full_inputs(cfg)
    store = np.load(store_path, mmap_mode="r")
    mesh = make_mesh(MeshConfig(dp=MESH_RANKS), device=dev)
    top_r, a = ev_cfg.num_return_sequences, len(ev_cfg.score_rates)
    out = {}
    for name, kw, _ in MESH_LAYOUTS:
        t = time.perf_counter()
        ev = Evaluator(model, trie, store, ev_cfg, mesh=mesh, **kw)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t
        ev.retrieve(ids, mask)                           # warm: U table
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        res, rr = ev.retrieve(ids, mask)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
        # the merge alone, at the shapes a retrieve gives it, each call
        # after a barrier, so that no rank's time waits on another's decode
        r = min(top_r, ev_cfg.num_beams * CAP)
        s = torch.randn(a, B, r, device=dev)
        p = torch.randint(0, N_DOCS, (a, B, r), dtype=torch.int32, device=dev)
        merge = []
        for _ in range(6):
            torch.distributed.barrier()
            merge += _timed(lambda: gather_merge(mesh, s, p, top_r), 0, 1)
        merge = merge[1:]
        out[name] = dict(_arrays(res, rr), launches=launches,
                         store_bytes=_store_bytes(ev.store),
                         rows=int((ev.store.values if ev.quantize
                                   else ev.store).shape[0]),
                         place_s=place_s, retrieve_ms_each=totals,
                         merge_ms_each=merge)
        del ev, res, rr
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def _mesh_backend() -> str:
    """Phase 10's ranks: a card each over nccl on a machine of
    ``MESH_RANKS`` or more cards, else all on the one card over gloo."""
    import torch
    return "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"


def _rank_main(rank: int, coord: str, backend: str, trie, store_path: str,
               timed: int, queue) -> None:
    """One rank of phase 10 (a spawned process): join the group over
    ``backend``, run (a) and (b) on its card (card ``rank`` under nccl,
    else the first), put (rank, results, None) or (rank, None, traceback)
    on ``queue``."""
    import traceback

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdr_tpu_torch.parallel.distributed import initialize, shutdown
    try:
        initialize(coord, MESH_RANKS, rank, backend=backend)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        out = {"small": _rank_small(dev),
               "full": _rank_full(dev, trie, store_path, timed)}
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        shutdown()


def _spawn_ranks(backend: str, *args, target=None, phase: str = "phase 10"
                 ) -> list[dict]:
    """A phase's ranks as spawned processes (CUDA does not survive a
    fork): ``target(rank, coord, backend, *args, queue)``, phase 10's
    ``_rank_main`` by default; the first rank to fail fails the phase, and
    every rank is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    coord = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target or _rank_main,
                         args=(r, coord, backend, *args, q))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    results: dict[int, dict] = {}
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while len(results) < MESH_RANKS:
            try:
                rank, out, err = q.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise Failed(f"{phase}: rank(s) {dead} exited without "
                                 f"a result" if dead else
                                 f"{phase}: ranks sent nothing in "
                                 f"{RANK_TIMEOUT} s") from None
                continue
            if err is not None:
                raise Failed(f"{phase}: rank {rank} failed:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(MESH_RANKS)]


def sharded_small_refs(dev) -> dict:
    """(a)'s one-device retrieves: phase 3's small model on the card (with
    its launches) and on the CPU, on each layout."""
    import torch

    from gdr_tpu_torch import kernels
    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.eval.evaluator import Evaluator

    cfg, trie, store, ids, mask, _ = _small_world(0)
    ev_cfg = EvalConfig(num_beams=12, num_return_sequences=20,
                        max_output_length=cfg.max_output_length)
    cpu_model, gpu_model = _small_models(cfg, dev)
    refs = {}
    for where, model in (("card", gpu_model), ("cpu", cpu_model)):
        for layout in MESH_SMALL_LAYOUTS:
            ev = Evaluator(model, trie, store, ev_cfg,
                           **SMALL_LAYOUTS[layout])
            kernels.reset_launch_counts()
            res, rr = ev.retrieve(ids, mask)
            torch.cuda.synchronize()
            refs[where, layout] = dict(_arrays(res, rr),
                                       launches=kernels.launch_counts())
    return refs


def sharded_full_refs(dev, card: str, trie, store_path: Path,
                      timed: int) -> dict:
    """(b)'s one-card retrieves: t5-base f32 over phase 4's store on each
    layout (packed f32 is phase 4's f32 retrieve), timed beside the
    sharded ones; the store is written to ``store_path`` for the ranks."""
    import numpy as np
    import torch

    from gdr_tpu_torch.eval.evaluator import Evaluator

    cfg, model = _full_f32_model(dev)
    ids, mask, ev_cfg = _full_inputs(cfg)
    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, cfg.encoder_d_model, generator=g, device=dev)
    store = store / store.norm(dim=1, keepdim=True)
    np.save(store_path, store.cpu().numpy())
    refs = {}
    for name, kw, _ in MESH_LAYOUTS:
        ev = Evaluator(model, trie, store, ev_cfg, **kw)
        res, rr = ev.retrieve(ids, mask)
        totals = _timed(lambda: ev.retrieve(ids, mask), 0, timed)
        refs[name] = dict(_arrays(res, rr), retrieve_ms_each=totals,
                          store_bytes=_store_bytes(ev.store))
        log(f"  (b) one card, {name}: retrieve "
            f"{', '.join(f'{x:.2f}' for x in totals)} ms; store "
            f"{refs[name]['store_bytes'] / 1e6:.1f} MB; {card}")
        del ev, res, rr
    del model, store
    torch.cuda.empty_cache()
    return refs


def _same_hits(tag: str, got: str, want: str) -> int:
    """Two ``retrieve --json`` outputs: the same queries, and per query
    the same scores in order and the same doc at each score, docs of one
    tied score in either order (a tie at the end of the list may keep
    either doc).  Returns the number of hits."""
    g, w = ([json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
            for out in (got, want))
    if not w or [x["query"] for x in g] != [x["query"] for x in w]:
        raise Failed(f"{tag}: queries differ or none:\n{got}\nvs\n{want}")
    for x, y in zip(g, w):
        gh, wh = ([(h["score"], h["doc_id"]) for h in z["results"]]
                  for z in (x, y))
        tail = wh[-1][0] if wh else None
        if [s for s, _ in gh] != [s for s, _ in wh] or sorted(
                h for h in gh if h[0] != tail) != sorted(
                h for h in wh if h[0] != tail):
            raise Failed(f"{tag}: hits of {y['query']!r} differ:\n{gh}\n"
                         f"vs\n{wh}")
    return sum(len(y["results"]) for y in w)


def sharded_cli(root: Path, work: Path) -> dict:
    """(c): the CLI under torch.distributed.run with nccl, one rank per
    card, over phase 6's index with its rows scaled to unit norm (so that
    tanh does not saturate and fused scores do not tie) and seeded tiny
    weights: retrieve --packed --mesh N against retrieve --packed, then
    eval --packed --mesh N against eval --packed."""
    import os

    import numpy as np
    import torch

    from gdr_tpu_torch.index.io import load_index, save_index

    n = torch.cuda.device_count()
    index = load_index(str(work / "index.npz"))
    index.store = index.store / np.linalg.norm(index.store, axis=1,
                                               keepdims=True)
    save_index(str(work / "mesh_index.npz"), index)
    common = ["--index", str(work / "mesh_index.npz"), "--workdir",
              str(work / "mesh_run"), "--model-size", "tiny", "--beam", "20",
              "--max-input-length", "16", "--device", "cuda", "--packed"]
    retrieve = ["retrieve", *common, "--top-k", "5", "--json", "--query",
                "alpha river music", "--query", "science novel", "--query",
                "history of football"]
    evaluate = ["eval", *common, "--dev", str(work / "dev.tsv")]
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")

    def torchrun(argv):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m", "gdr_tpu_torch.cli", *argv,
             "--mesh", str(n)], cwd=root, env=env, capture_output=True,
            text=True, timeout=300)
        if out.returncode != 0:
            raise Failed(f"torchrun cli {argv[0]} --mesh {n} exited "
                         f"{out.returncode}:\n{out.stderr[-3000:]}")
        if "over nccl" not in out.stderr:
            raise Failed(f"torchrun cli {argv[0]}: no nccl group:\n"
                         f"{out.stderr[-2000:]}")
        return out.stdout

    t = time.perf_counter()
    hits = _same_hits(f"cli retrieve --mesh {n} (nccl)", torchrun(retrieve),
                      _port_cli(retrieve, root).stdout)
    drop = lambda m: {k: v for k, v in m.items()
                      if not k.endswith(TIMER_KEYS)}
    e_one = _port_cli(evaluate, root).stdout
    e_one = json.loads(e_one[e_one.index("{"):])
    e_many = torchrun(evaluate)
    e_many = json.loads(e_many[e_many.index("{"):])
    if drop(e_many) != drop(e_one):
        raise Failed(f"cli eval --mesh {n} (nccl) metrics differ from the "
                     f"unsharded ones")
    cli_s = time.perf_counter() - t
    log(f"  (c) cli under torch.distributed.run, nccl, {n} rank(s): "
        f"retrieve --packed --mesh {n} printed the unsharded hits ({hits}), "
        f"eval --mesh {n} its {len(drop(e_one))} metrics (recall1 "
        f"{e_one['recall1']:.3f}); {cli_s:.1f} s for the four processes")
    return dict(ranks=n, cli_s=cli_s, hits=hits, recall1=e_one["recall1"])


def phase_sharded(dev, card: str, root: Path, work: Path, trie,
                  timed: int = 3) -> dict:
    t = time.perf_counter()
    small = sharded_small_refs(dev)
    store_path = work / "mesh_store.npy"
    full = sharded_full_refs(dev, card, trie, store_path, timed)
    log(f"  one-device references {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    backend = _mesh_backend()
    ranks = _spawn_ranks(backend, trie, str(store_path), timed)
    store_path.unlink()
    log(f"  {MESH_RANKS} ranks over {backend}, "
        + ("a card each" if backend == "nccl" else "sharing the one card")
        + f": {time.perf_counter() - t:.1f} s from spawn to their results")

    # (a): every rank's merged result equals the one-device retrieve
    for (mesh_name, where, layout), got in ranks[0]["small"].items():
        want = small[where, layout]
        errs = [_same_merged(f"small {mesh_name} {where} {layout} rank {r}",
                             rk["small"][mesh_name, where, layout], want,
                             MESH_TOL) for r, rk in enumerate(ranks)]
        if where == "card":
            want_l = {k: (v if k in DECODER else 0)
                      for k, v in want["launches"].items()}
            want_l[SCORER_OF[layout]] = 1
            for r, rk in enumerate(ranks):
                got_l = rk["small"][mesh_name, where, layout]["launches"]
                if got_l != want_l:
                    raise Failed(f"sharded small {mesh_name} {layout} rank "
                                 f"{r}: launches {got_l} != {want_l}")
        log(f"  (a) f32 d=64 {mesh_name:7s} {where:4s} {layout:11s}: 4 "
            f"ranks x {got['rows']} rows; {int(want['doc_valid'].sum())} "
            f"valid docs equal to one {where}'s; max |d| fused score "
            f"{max(errs):.3g} (tol {MESH_TOL:g})"
            + (f"; launches per rank {got['launches']}"
               if where == "card" else ""))

    # (b): the merged full-width result, each rank's launches and numbers
    out = {"ranks": MESH_RANKS, "backend": backend, "layouts": {}}
    for name, _, scorer in MESH_LAYOUTS:
        want = full[name]
        per = [rk["full"][name] for rk in ranks]
        err = max(_same_merged(f"t5-base {name} rank {r}", g, want,
                               MESH_TOL, beams=False)
                  for r, g in enumerate(per))
        want_l = {**dict.fromkeys(per[0]["launches"], 0),
                  **dict.fromkeys(DECODER, 24), scorer: 1}
        for r, g in enumerate(per):
            if g["launches"] != want_l:
                raise Failed(f"sharded t5-base {name} rank {r}: launches "
                             f"{g['launches']} != {want_l}")
        retrieve = [fmean(g["retrieve_ms_each"]) for g in per]
        merge = [fmean(g["merge_ms_each"]) for g in per]
        lay = dict(
            store_bytes_per_rank=[g["store_bytes"] for g in per],
            rows_per_rank=per[0]["rows"],
            store_bytes_one_card=want["store_bytes"],
            launches_per_rank={k: v for k, v in per[0]["launches"].items()
                               if v},
            retrieve_ms_each=[g["retrieve_ms_each"] for g in per],
            retrieve_ms=fmean(retrieve),
            retrieve_ms_one_card=fmean(want["retrieve_ms_each"]),
            merge_ms_each=[g["merge_ms_each"] for g in per],
            merge_ms=fmean(merge), place_s=[g["place_s"] for g in per],
            max_abs_err=err)
        out["layouts"][name] = lay
        log(f"  (b) t5-base f32 {name}: per rank {per[0]['rows']} rows, "
            f"{lay['store_bytes_per_rank'][0] / 1e6:.1f} MB "
            f"(one card {want['store_bytes'] / 1e6:.1f} MB), placed in "
            f"{max(lay['place_s']):.2f} s; launches per rank "
            f"{lay['launches_per_rank']}; retrieve {lay['retrieve_ms']:.2f} "
            f"ms a rank (one card alone {lay['retrieve_ms_one_card']:.2f} "
            f"ms), merge {lay['merge_ms']:.3f} ms; merged = one card's "
            f"({int(want['doc_valid'].sum())} valid docs, max |d| "
            f"{err:.3g}, tol {MESH_TOL:g}); {card}")
    out["peak_gib_per_rank"] = [rk["full"]["peak_gib"] for rk in ranks]
    out["launches"] = {k: v for lay in out["layouts"].values()
                       for k, v in lay["launches_per_rank"].items()}
    log("  (b) peak per rank " + ", ".join(
        f"{x:.2f}" for x in out["peak_gib_per_rank"]) + " GiB")
    out["cli"] = sharded_cli(root, work)
    return out


# ------------------------------------------------------------ phase 11

def mesh_train_world(small: bool = False):
    """The f32 world of ``gdr_tpu``'s own mesh TrainLoop test
    (``tests/test_parallel.py:178-188``): module dropout 0, input dropout
    on (0.5), batch 8, two epochs of stage 1, eval at beam 4, masters and
    moments of leaves of 256+ elements sharded over mp; the port's copy of
    its synthetic task (16 docs, 3-ary).  ``small``: phase 3's model
    widths (d 64, 4 heads, vocab 512) over a 64-wide store.
    (cfg, index, train set, dev set)."""
    from gdr_tpu_torch.config import tiny_config
    from gdr_tpu_torch.data.dataset import TrainSet
    from gdr_tpu_torch.data.synthetic import build_synthetic_task
    from gdr_tpu_torch.eval.evaluator import EvalData
    from gdr_tpu_torch.index.io import Index

    cfg = tiny_config(kary=3, max_output_length=5)
    model = dataclasses.replace(cfg.model, dropout_rate=0.0)
    if small:
        model = dataclasses.replace(model, d_model=64, d_kv=16, d_ff=128,
                                    num_layers=2, num_decoder_layers=2,
                                    num_heads=4, vocab_size=512,
                                    encoder_d_model=64)
    cfg = cfg.replace(
        model=model,
        train=dataclasses.replace(
            cfg.train, train_batch_size=8, eval_batch_size=4,
            num_train_epochs=2, train_encoder_epoch=99, bf16=False,
            learning_rate=3e-3, decoder_learning_rate=3e-3),
        eval=dataclasses.replace(cfg.eval, num_beams=4,
                                 num_return_sequences=4, score_rates=(0.0,)),
        mesh=dataclasses.replace(cfg.mesh, tp_min_size=256))
    task = build_synthetic_task(n_docs=16, dim=model.encoder_d_model, kary=3,
                                leaf_cap=4, seq_len=8,
                                vocab_size=model.vocab_size,
                                max_output_length=5, seed=0)
    index = Index(store=task.store, trie=task.trie, paths=task.paths,
                  cid_of_doc=task.cid_of_doc)
    ts = TrainSet(input_ids=task.input_ids, attn_mask=task.attn_mask,
                  labels=task.labels, label_mask=task.label_mask,
                  pos_idx=task.pos_idx, source=["gtq"] * len(task.pos_idx))
    dev = EvalData(input_ids=task.input_ids, attn_mask=task.attn_mask,
                   gt_docs=task.gt_docs, gt_cids=task.gt_cids)
    return cfg, index, ts, dev


def record_loop(loop, noise=None) -> dict:
    """Instrument a TrainLoop before ``run``: each step's loss, this rank's
    masters at each epoch's end (as the eval sees them) and the kernel
    launches of each epoch's eval.  ``noise``: global draws handed to step
    ``i`` as ``{"input_gate": noise["gate"][i], "input_keep":
    noise["keep"][i]}`` (another package's draws).  Returns the dict that
    fills in as the loop runs."""
    from gdr_tpu_torch import kernels

    rec = {"losses": [], "masters": [], "launches": []}
    for stage in (1, 2):
        step_fn = loop._step_fn(stage)

        def step(state, batch, store, seed, step_fn=step_fn):
            n = None if noise is None else {
                "input_gate": noise["gate"][state.step],
                "input_keep": noise["keep"][state.step]}
            state, m = step_fn(state, batch, store, seed, noise=n)
            rec["losses"].append(float(m["loss"]))
            return state, m
        loop._step_fns[stage] = step
    evaluate = loop.evaluator.evaluate

    def counted(*args, **kw):
        rec["masters"].append({f"{t}/{n}": v.detach().cpu().clone()
                               for t, d in loop.state.params.items()
                               for n, v in d.items()})
        kernels.reset_launch_counts()
        out = evaluate(*args, **kw)
        rec["launches"].append(kernels.launch_counts())
        return out
    loop.evaluator.evaluate = counted
    return rec


# f32 masters after each epoch, a mesh's rank against one device.  Adam
# divides each element's step by the root of its second moment, so an
# element whose gradient is a near-cancellation at rounding level (a few
# 1e-8 against terms of 1e-2) takes a step of rounding-determined size:
# summed in another order it moves by up to ~0.5% of a step more or less
# (1.43e-5 at lr 3e-3 in (a) on an NVIDIA H100 80GB HBM3 at 700 W).  At
# most MASTER_NOISE_SHARE of the elements may differ by more than
# MASTER_TOL, and none by more than one step (the learning rate)
MASTER_TOL = 1e-5
MASTER_NOISE_SHARE = 1e-3
MESH_LOSS_TOL = 1e-5         # each step's loss, relative
MESH_TRAIN_LAYOUTS = {"plain": ("rerank_scores", False),
                      "packed": ("packed_scores", True)}
# (a)'s meshes: at 1x4 the d=64 model's 4 heads divide over the row (each
# rank's heads stay local through the core), PAWA's 2 do not (gathered)
MESH_TRAIN_CFGS = {"dp4": dict(dp=4), "dp2xmp2": dict(dp=2, mp=2),
                   "1x4": dict(dp=1, mp=4)}
# (b)'s meshes at t5-base: 12 heads, local through the core at both
MESH_FULL_CFGS = {"dp2xmp2": dict(dp=2, mp=2), "1x4": dict(dp=1, mp=4)}


def masters_diff(got: dict, want: dict, mp: int, mp_rank: int,
                 min_size: int) -> tuple[float, int, int]:
    """A rank's masters (its mp parts where cut, by the placement of
    ``tp_param_rules``) against one device's: (max |d|, elements beyond
    MASTER_TOL, elements)."""
    import torch

    from gdr_tpu_torch.parallel.mesh import Mesh, mp_slice, tp_param_rules

    rule = tp_param_rules(mp, min_size)
    row = Mesh(dp=1, mp=mp, rank=mp_rank, world=mp, device="cpu",
               comm_device="cpu")
    worst, over, n = 0.0, 0, 0
    for k, g in got.items():
        g, w = torch.as_tensor(g), torch.as_tensor(want[k])
        cut = rule(k, w) if mp > 1 else None
        if cut is not None:
            w = mp_slice(w, row, cut)
        d = (g.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        over += int((d > MASTER_TOL).sum())
        n += d.numel()
    return worst, over, n


def check_masters(tag: str, got: dict, want: dict, mp: int, mp_rank: int,
                  lr: float, min_size: int) -> float:
    worst, over, n = masters_diff(got, want, mp, mp_rank, min_size)
    if over > MASTER_NOISE_SHARE * n or worst > lr:
        raise Failed(f"{tag}: {over} of {n} master elements differ by more "
                     f"than {MASTER_TOL:g} (max {worst:.3g})")
    return worst


def _train_mesh_loops(dev, weights, noise, work: Path, mesh=None) -> dict:
    """(a)'s loops on ``dev``: phase 3's small model from ``weights``, two
    epochs with the input-dropout draws ``noise`` (made once on the host,
    so that card and CPU take the same), one per mesh shape and eval
    layout (one device without a mesh): each step's loss, the masters
    after each epoch, each epoch's eval launches, the best metrics, the
    store rows a rank holds."""
    import torch

    from gdr_tpu_torch.config import MeshConfig
    from gdr_tpu_torch.parallel.mesh import make_mesh
    from gdr_tpu_torch.train.loop import TrainLoop

    out = {}
    shapes = MESH_TRAIN_CFGS if mesh else {"one": None}
    for mesh_name, mcfg in shapes.items():
        m = make_mesh(MeshConfig(**mcfg), device=dev) if mcfg else None
        for layout, (_, packed) in MESH_TRAIN_LAYOUTS.items():
            cfg, index, ts, dv = mesh_train_world(small=True)
            loop = TrainLoop(cfg, index, ts, dv,
                             str(work / f"p11_{dev.type}_{mesh_name}_{layout}"),
                             seed=0, mesh=m, packed_eval=packed,
                             warm_start=lambda mod, _: mod.load_state_dict(
                                 weights), device=dev)
            rec = record_loop(loop, noise)
            best = loop.run()
            out[mesh_name, layout] = dict(
                rec, recall1=best["recall1"], lr=cfg.train.learning_rate,
                mp=m.mp if m else 1, mp_rank=m.mp_rank if m else 0,
                min_size=cfg.mesh.tp_min_size,
                store_rows=int(loop.store.shape[0]))
    return out


def _count_mp(mesh, dev) -> dict:
    """Count and time the mesh's mp-row collectives from here on (the card
    synchronised around each, so each is timed alone) until ``stop()``:
    {"n", "ms", "bytes", "stop"}."""
    import torch

    stats = {"n": 0, "ms": 0.0, "bytes": 0}
    cls = type(mesh)

    def wrap(name):
        fn = getattr(cls, name)

        def run(t, axis, *a):
            if axis != "mp":
                return fn(mesh, t, axis, *a)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(mesh, t, axis, *a)
            torch.cuda.synchronize(dev)
            stats["ms"] += (time.perf_counter() - t0) * 1e3
            stats["n"] += 1
            stats["bytes"] += t.numel() * t.element_size()
            return out
        setattr(mesh, name, run)

    for name in ("_gather", "_sum"):
        wrap(name)

    def stop():
        for name in ("_gather", "_sum"):
            delattr(mesh, name)
    stats["stop"] = stop
    return stats


def _rank_full_train(dev, store_path: str, shape: dict) -> dict:
    """(b) in one rank: t5-base at TrainConfig's defaults over a mesh of
    ``shape`` (column-parallel over its mp row): 1 warm and 2 timed steps
    of the global batch 64 (this rank's 64 / dp rows), then one step with
    the mp collectives timed alone, the gradient's dp all-reduce alone, the
    bytes of the compute copy, the gradient and the masters + moments held,
    the store rows held, the peak of the steps and of the set-up."""
    import numpy as np
    import torch

    from gdr_tpu_torch.config import GDRConfig, MeshConfig, ModelConfig
    from gdr_tpu_torch.data.dataset import BatchIterator, cluster_docs_lookup
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
    from gdr_tpu_torch.parallel.mesh import make_mesh, tp_param_rules
    from gdr_tpu_torch.parallel.store import place_store
    from gdr_tpu_torch.train.trainer import (init_train_state, load_masters,
                                             make_train_step, shard_state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = GDRConfig(model=ModelConfig().scaled("base"))
    mesh = make_mesh(MeshConfig(**shape), device=dev)
    paths = _paths_of(bench_cid_map(N_DOCS, cfg.model.kary, 30))
    bsz = cfg.train.train_batch_size
    ts = _train_set(np.random.default_rng(11), paths, bsz * 4, S,
                    cfg.model.vocab_size, cfg.model)
    lookup = cluster_docs_lookup(["-".join(map(str, p)) for p in paths])
    batches = list(BatchIterator(ts, lookup, bsz,
                                 cfg.data.max_intraclass_num, seed=0))
    if len(batches) < 4:
        raise Failed(f"(b): {len(batches)} batches, not 4")
    with torch.device(dev):
        model = GenerativeRetriever(cfg.model)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    state, opt = init_train_state(cfg, model, None, total_steps=10_000)
    state = shard_state(state, mesh,
                        tp_param_rules(mesh.mp, cfg.mesh.tp_min_size))
    load_masters(state, model)
    held = sum(t.numel() * 4 for part in (state.params["generator"],
                                          state.opt_state["mu"],
                                          state.opt_state["nu"])
               for t in part.values())
    copy_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    store = place_store(np.load(store_path, mmap_mode="r"), mesh, dev)
    # the set-up's peak: the whole f32 state, made before it is cut
    init_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_train_step(model, None, opt, cfg, stage=1, mesh=mesh)
    grad_shapes = []
    reduce_dp = mesh.all_reduce_dp

    def record(tensors):
        grad_shapes[:] = [tuple(t.shape) for t in tensors]
        return reduce_dp(tensors)
    mesh.all_reduce_dp = record
    losses, norms, ms = [], [], []
    for i, b in enumerate(batches[:3]):
        torch.distributed.barrier()
        t = time.perf_counter()
        state, m = step(state, b, store, 0)
        torch.cuda.synchronize(dev)
        if i:
            ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del mesh.all_reduce_dp
    # one more step with each mp collective timed alone
    torch.distributed.barrier()
    mp_stats = _count_mp(mesh, dev)
    state, m = step(state, batches[3], store, 0)
    torch.cuda.synchronize(dev)
    mp_stats.pop("stop")()
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
    grads = [torch.ones(s, device=dev) for s in grad_shapes]
    reduce_ms = []
    for _ in range(2):
        torch.distributed.barrier()
        t = time.perf_counter()
        mesh.all_reduce_dp(grads)
        torch.cuda.synchronize(dev)
        reduce_ms.append((time.perf_counter() - t) * 1e3)
    if float(grads[0].flatten()[0]) != mesh.dp ** 2:
        raise Failed(f"(b) the gradient all-reduce summed "
                     f"{float(grads[0].flatten()[0])}, not {mesh.dp ** 2}")
    grad_bytes = sum(g.numel() * 4 for g in grads)
    if not (copy_bytes < n_params * 2 and grad_bytes < n_params * 4):
        raise Failed(f"(b) {shape}: the rank holds a whole compute copy "
                     f"({copy_bytes} B) or gradient ({grad_bytes} B)")
    return dict(step_ms_each=ms, allreduce_ms_each=reduce_ms,
                mp_ms=mp_stats["ms"], mp_collectives=mp_stats["n"],
                mp_bytes=mp_stats["bytes"],
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                init_peak_gib=init_peak,
                held_bytes=held, one_process_bytes=n_params * 12,
                copy_bytes=copy_bytes, one_copy_bytes=n_params * 2,
                n_params=n_params, store_rows=int(store.shape[0]),
                losses=losses, grad_norms=norms, grad_bytes=grad_bytes,
                one_grad_bytes=n_params * 4, dp=mesh.dp, mp=mesh.mp,
                dp_rank=mesh.dp_rank, mp_rank=mesh.mp_rank)


def _rank_train(rank: int, coord: str, backend: str, weights, noise,
                store_path, queue) -> None:
    """One rank of phase 11: (a) then (b) on its card (card ``rank`` under
    nccl, else the first), each into a temp dir of its own run."""
    import traceback

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdr_tpu_torch.parallel.distributed import initialize, shutdown
    try:
        initialize(coord, MESH_RANKS, rank, backend=backend)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        work = Path(store_path).parent
        small = _train_mesh_loops(dev, weights, noise, work, mesh=True)
        for rec in small.values():       # no tensor crosses the queue
            rec["masters"] = [{k: v.numpy() for k, v in m.items()}
                              for m in rec["masters"]]
        full = {name: _rank_full_train(dev, store_path, shape)
                for name, shape in MESH_FULL_CFGS.items()}
        queue.put((rank, {"small": small, "full": full}, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        shutdown()


def phase_train_mesh(dev, card: str, work: Path) -> dict:
    """Phase 11: training over a dp x mp mesh of four ranks (sharing the
    card over gloo, or a card each over nccl on four cards)."""
    import numpy as np
    import torch

    from gdr_tpu_torch.config import ModelConfig
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    t = time.perf_counter()
    cfg, _, ts, _ = mesh_train_world(small=True)
    weights = init_weights(GenerativeRetriever(cfg.model),
                           torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(5)
    b = cfg.train.train_batch_size
    steps = cfg.train.num_train_epochs * (len(ts) // b)
    noise = dict(gate=rng.random(steps) < cfg.model.input_dropout,
                 keep=rng.random((steps, 2 * b, ts.input_ids.shape[1])) < 0.9)
    one = _train_mesh_loops(dev, weights, noise, work)
    cpu = _train_mesh_loops(torch.device("cpu"), weights, noise, work)
    for layout in MESH_TRAIN_LAYOUTS:
        c, g = cpu["one", layout], one["one", layout]
        err = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                      c["losses"]))
        if not err <= SMALL_TOL or g["recall1"] != c["recall1"]:
            raise Failed(f"phase 11 one card vs cpu ({layout}): losses "
                         f"differ by {err:.3g} relative, recall1 "
                         f"{g['recall1']} vs {c['recall1']}")
    store_path = work / "mesh_train_store.npy"
    g = torch.Generator(device=dev).manual_seed(7)      # phase 4's store
    store = torch.randn(N_DOCS, ModelConfig().scaled("base").encoder_d_model,
                        generator=g, device=dev)
    np.save(store_path, (store / store.norm(dim=1, keepdim=True)).cpu()
            .numpy())
    del store
    torch.cuda.empty_cache()
    log(f"  one-card and cpu loops {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    backend = _mesh_backend()
    ranks = _spawn_ranks(backend, weights, noise, str(store_path),
                         target=_rank_train, phase="phase 11")
    store_path.unlink()
    log(f"  {MESH_RANKS} ranks over {backend}, "
        + ("a card each" if backend == "nccl" else "sharing the one card")
        + f": {time.perf_counter() - t:.1f} s from spawn to their results")

    # (a): each rank's losses and masters against the one-card loop
    out = {"ranks": MESH_RANKS, "backend": backend, "small": {},
           "launches": {}}
    for (mesh_name, layout), got in ranks[0]["small"].items():
        want = one["one", layout]
        scorer = MESH_TRAIN_LAYOUTS[layout][0]
        errs, loss_err = [], 0.0
        for r, rk in enumerate(ranks):
            g = rk["small"][mesh_name, layout]
            loss_err = max(loss_err, max(abs(a - b) / abs(b) for a, b in
                                         zip(g["losses"], want["losses"])))
            errs += [check_masters(f"phase 11 (a) {mesh_name} {layout} rank "
                                   f"{r} epoch {e}", gm, wm, g["mp"],
                                   g["mp_rank"], g["lr"], g["min_size"])
                     for e, (gm, wm) in enumerate(zip(g["masters"],
                                                      want["masters"]))]
            if g["recall1"] != want["recall1"]:
                raise Failed(f"phase 11 (a) {mesh_name} {layout} rank {r}: "
                             f"recall1 {g['recall1']} != {want['recall1']}")
            if g["launches"] != want["launches"] or not all(
                    ln[scorer] and all(ln[k] for k in DECODER)
                    for ln in g["launches"]):
                raise Failed(f"phase 11 (a) {mesh_name} {layout} rank {r}: "
                             f"eval launches {g['launches']} != the one "
                             f"card's {want['launches']}")
        if not loss_err <= MESH_LOSS_TOL:
            raise Failed(f"phase 11 (a) {mesh_name} {layout}: losses differ "
                         f"from one card's by {loss_err:.3g} relative")
        out["small"][f"{mesh_name} {layout}"] = dict(
            loss_rel_err=loss_err, master_max_err=max(errs),
            store_rows=got["store_rows"], launches=got["launches"][0],
            recall1=got["recall1"])
        out["launches"].update({k: v for k, v in got["launches"][0].items()
                                if k in DECODER or k == scorer})
        log(f"  (a) f32 d=64 {mesh_name:7s} {layout:6s}: losses = one "
            f"card's within {loss_err:.3g} (rel), masters max |d| "
            f"{max(errs):.3g}; {got['store_rows']} store rows a rank; eval "
            f"launches per rank and epoch {dict((k, v) for k, v in got['launches'][0].items() if v)}; "
            f"recall1 {got['recall1']:.4f}")

    # (b): t5-base at dp=2 x mp=2 and dp=1 x mp=4
    out["full"] = {}
    for name in MESH_FULL_CFGS:
        out["full"][name] = _full_mesh_report(name, [rk["full"][name]
                                                     for rk in ranks], card)
    return out


def _full_mesh_report(name: str, per: list[dict], card: str) -> dict:
    """(b)'s checks and log lines of one mesh shape: every rank's losses
    bit-equal and finite, grad norms equal within 1e-6; per rank the bytes
    held, the collectives' and the step's ms, the peak."""
    import numpy as np

    losses = np.asarray([p["losses"] for p in per])
    if not (np.isfinite(losses).all() and (losses == losses[0]).all()):
        raise Failed(f"phase 11 (b) {name}: losses differ between ranks or "
                     f"are not finite: {losses.tolist()}")
    norms = np.asarray([p["grad_norms"] for p in per])
    if not (np.isfinite(norms).all() and np.allclose(norms, norms[0],
                                                      rtol=1e-6, atol=0)):
        raise Failed(f"phase 11 (b) {name}: grad norms differ between ranks "
                     f"or are not finite: {norms.tolist()}")
    keys = ("step_ms_each", "allreduce_ms_each", "mp_ms", "mp_collectives",
            "mp_bytes", "peak_gib", "init_peak_gib", "held_bytes",
            "copy_bytes", "grad_bytes", "store_rows")
    full = {k: [p[k] for p in per] for k in keys}
    full.update(step_ms=fmean(fmean(p["step_ms_each"]) for p in per),
                allreduce_ms=fmean(fmean(p["allreduce_ms_each"]) for p in per),
                one_process_bytes=per[0]["one_process_bytes"],
                one_copy_bytes=per[0]["one_copy_bytes"],
                one_grad_bytes=per[0]["one_grad_bytes"],
                losses=per[0]["losses"], dp=per[0]["dp"], mp=per[0]["mp"])
    for r, p in enumerate(per):
        log(f"  (b) t5-base bf16 over f32 masters, {name}, rank {r} (dp "
            f"{p['dp_rank']}, mp {p['mp_rank']}): step "
            f"{', '.join(f'{x:.1f}' for x in p['step_ms_each'])} ms; compute "
            f"copy {p['copy_bytes'] / 1e9:.3f} GB (whole "
            f"{p['one_copy_bytes'] / 1e9:.3f}), gradient "
            f"{p['grad_bytes'] / 1e9:.3f} GB (whole "
            f"{p['one_grad_bytes'] / 1e9:.3f}), masters + moments "
            f"{p['held_bytes'] / 1e9:.3f} GB (whole "
            f"{p['one_process_bytes'] / 1e9:.3f}); the dp all-reduce alone "
            f"{', '.join(f'{x:.1f}' for x in p['allreduce_ms_each'])} ms; "
            f"the mp collectives of one step {p['mp_ms']:.1f} ms "
            f"({p['mp_collectives']} of {p['mp_bytes'] / 1e9:.3f} GB); peak "
            f"{p['peak_gib']:.2f} GiB in the steps, {p['init_peak_gib']:.2f} "
            f"GiB in the set-up (the whole state, then cut); "
            f"{p['store_rows']} store rows of {N_DOCS}")
    log(f"  (b) {name} losses {', '.join(f'{x:.4f}' for x in full['losses'])}"
        f" bit-equal on every rank; {card}")
    return full


# ------------------------------------------------------------ main

def spilling_functions(ptxas_log: str) -> list[tuple[str, str]]:
    """(function, its stack and spill line) for each kernel or function in
    a ``-Xptxas -v`` report that has a stack frame or spills, demangled by
    c++filt where the machine has it."""
    import shutil
    found, fn = [], None
    for ln in ptxas_log.splitlines():
        if "Function properties for " in ln:
            fn = ln.split("Function properties for ", 1)[1].strip()
        elif "spill" in ln and fn is not None:
            props = ln.strip()
            if not props.startswith("0 bytes stack frame, 0 bytes spill"):
                found.append((fn, props))
            fn = None
    if found and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in found),
                               capture_output=True, text=True).stdout.split("\n")
        found = [(n or f, p) for (f, p), n in zip(found, names)]
    return found


KERNELS = [
    ("self_attn_sublayer", "gdr_tpu_torch/csrc/decode_sublayers.cu",
     "gdr_tpu/ops/pallas/decode_kernel.py:230",
     "torch.matmul (cuBLAS) of the QKV and Wo GEMMs"),
    ("cross_attn_sublayer", "gdr_tpu_torch/csrc/decode_sublayers.cu",
     "gdr_tpu/ops/pallas/decode_kernel.py:329",
     "torch.matmul (cuBLAS) of the Q and Wo GEMMs"),
    ("ffn_sublayer", "gdr_tpu_torch/csrc/decode_sublayers.cu",
     "gdr_tpu/ops/pallas/decode_kernel.py:396",
     "torch.matmul (cuBLAS) of the wi and wo GEMMs"),
    ("packed_scores", "gdr_tpu_torch/csrc/rerank_packed.cu",
     "gdr_tpu/ops/pallas/rerank_kernel.py:104",
     "gather + torch.bmm over the [R, cap, d] blocks + tanh"),
    ("packed_scores_int8", "gdr_tpu_torch/csrc/rerank_packed.cu",
     "gdr_tpu/ops/pallas/rerank_kernel.py:167",
     "gather of the int8 [R, cap, d] blocks + f32 torch.bmm"),
    ("rerank_scores", "gdr_tpu_torch/csrc/rerank_gather.cu",
     "gdr_tpu/ops/pallas/rerank_kernel.py:207",
     "store[docs] + torch.bmm + tanh + masked_fill"),
]


def kernel_rows(stats: dict, full: dict, index: dict, train: dict,
                secondary: dict, pretrained: dict, sharded: dict,
                train_mesh: dict, small: dict) -> list[dict]:
    """The ``{"kernels": [...]}`` rows: each kernel's launches on its
    layout's main path (phase 4) and its phase-2 numbers at 3,200 rows; the
    decoder rows add their numbers at each row count (``by_rows``), the
    per-retrieve sums (``per_retrieve``) and their GEMM shapes alone
    against torch.matmul (``gemms``).  ``launches_built_index`` counts the
    launches of one retrieve over phase 6's k-means index,
    ``launches_train_eval`` those of phase 7's TrainLoop epoch (its
    eval), ``launches_qg`` / ``launches_ensemble_eval`` /
    ``launches_hierarchic_eval`` those of phase 8's query generation
    batch, ensemble eval and hierarchic decode + re-rank,
    ``launches_pretrained`` those of phase 9's retrieve by the t5-base
    warm-started from a checkpoint directory, ``launches_sharded_per_rank``
    those of one rank's retrieve over phase 10's sharded store (its
    layout's), ``launches_mesh_train_eval_per_rank`` those of one rank's
    epoch eval in phase 11's mesh TrainLoop (its layout's scorer once a
    retrieve); the decoder rows
    add their numbers at query generation's shape (``qg``: one beam per
    row, a 64-token doc, a 40-position cache; f32 and bf16).  The last row,
    ``expert_sublayer``, replaces no TPU kernel: its launches on phase 4's
    dense main path, ``launches_switch_small`` those of phase 3's small
    Switch retrieve, and its phase-2 numbers at 100 rows, by row count
    (``by_rows``) and per retrieve."""
    rows = []
    for name, source, replaces, library in KERNELS:
        st = stats[name]
        row = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=full["launches"][name], max_abs_err=st["err"],
            ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=st["library_ms"],
            library=library, flops=st["flops"], bytes=st["bytes"],
            rows=B * WIDTHS[-1],
            dtype="int8" if name == "packed_scores_int8" else "bfloat16",
            launches_built_index=index["launches"][name],
            launches_train_eval=train["loop_launches"][name],
            launches_qg=secondary["qg"]["launches"][name],
            launches_ensemble_eval=secondary["ensemble"]["launches"][name],
            launches_hierarchic_eval=secondary["hierarchic"]["launches"][
                name],
            launches_pretrained=pretrained["launches"][name],
            launches_sharded_per_rank=sharded["launches"][name],
            launches_mesh_train_eval_per_rank=train_mesh["launches"].get(
                name, 0))
        if name in DECODER:
            row.update(by_rows=st["rows"], per_retrieve=st["per_retrieve"],
                       gemms=st["gemms"], by_rows_f32=st["rows_f32"],
                       per_retrieve_f32=st["per_retrieve_f32"],
                       gemms_f32=st["gemms_f32"])
            row.update(qg=st["qg"])
            row.update(by_rows_f32_b1=st["rows_f32_b1"],
                       per_retrieve_f32_b1=st["per_retrieve_f32_b1"],
                       gemms_f32_b1=st["gemms_f32_b1"],
                       gemm_kernels_f32_retrieve=full["gemm_kernels_f32"],
                       gemm_kernels_f32_one_query_retrieve=full[
                           "gemm_kernels_f32_one_query"])
        if name in full["launches_f32"]:
            row["launches_f32_retrieve"] = full["launches_f32"][name]
        rows.append(row)
    st = stats["expert_sublayer"]
    rows.append(dict(
        name="expert_sublayer", route="cuda",
        source="gdr_tpu_torch/csrc/experts.cu", replaces=None,
        launches=full["launches"].get("expert_sublayer", 0),
        launches_switch_small=small["switch_launches"]["expert_sublayer"],
        max_abs_err=st["err"], logit_err=st["logit_err"], ms=st["ms"],
        plain_ms=st["plain_ms"], bound_ms=st["bound_ms"],
        bound_by=st["bound_by"], library_ms=None,
        library="the plain version: transformers' loop over the experts "
                "hit, torch.matmul each (plain_ms, wall)",
        flops=st["flops"], bytes=st["bytes"], rows=100, dtype="float32",
        by_rows=st["by_rows"], per_retrieve=st["per_retrieve"]))
    for name, source in (("topk_expert_sublayer", "experts.cu"),
                         ("mla_attention", "mla.cu")):
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=f"gdr_tpu_torch/csrc/{source}",
            replaces=None, launches=full["launches"].get(name, 0),
            launches_moonlight_small=small["moonlight_launches"][name],
            max_abs_err=st["err"], ms=st["ms"], plain_ms=st["plain_ms"],
            bound_ms=st["bound_ms"], bound_by=st["bound_by"],
            library_ms=None, library="the plain version (plain_ms)",
            flops=st["flops"], bytes=st["bytes"], rows=100, dtype="float32",
            by_rows=st["by_rows"], per_retrieve=st["per_retrieve"],
            forced=st.get("forced")))
    st = stats["kda"]
    for name in ("kda_prefill", "kda_decode"):
        calls = {key: r for key, r in st["by_call"].items()
                 if (key == "prefill") == (name == "kda_prefill")}
        top = list(calls.values())[-1]     # the prefill; a 100-row step
        rows.append(dict(
            name=name, route="cuda", source="gdr_tpu_torch/csrc/kda.cu",
            replaces=None, launches=full["launches"].get(name, 0),
            launches_kimi_linear_small=small["kimi_linear_launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in calls.values()),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            library="the plain version (plain_ms)", flops=top["flops"],
            bytes=top["bytes"], rows=40 if name == "kda_prefill" else 100,
            dtype="float32", by_call=calls))
    return rows


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "gdr_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: no gdr_tpu_torch package beside {__file__}; "
              f"run it from the repository root", file=sys.stderr)
        return 2
    if any(a != "profile" for a in argv):
        print(f"chip_smoke.py: unknown arguments {argv}; usage: "
              f"python3 chip_smoke.py [profile]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from gdr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    secs = build.build_all()
    log(f"    nvcc build of {build.sources()}: {secs:.1f} s")
    from gdr_tpu_torch import native

    t = time.perf_counter()
    log(f"    host C++ library {native.build().name}: "
        f"{time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        for fn, props in spilling_functions(text):
            log(f"    {name}: {fn}: {props}")
    log(f"[1] {time.perf_counter() - t0:.1f} s")

    from gdr_tpu_torch.config import ModelConfig

    t = time.perf_counter()
    trie = build_nq_scale_trie(N_DOCS, ModelConfig().scaled("base").kary, 30,
                               64)
    log(f"    bench trie: {trie.num_nodes} nodes, {trie.num_clusters} "
        f"clusters, depth {int(trie.depth.max())} "
        f"({time.perf_counter() - t:.2f} s)")
    work = Path(tempfile.mkdtemp(prefix="gdr_smoke_"))
    try:
        t = time.perf_counter()
        log("[2] kernel vs plain on the card")
        stats = phase_kernels(dev, trie)
        log(f"[2] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[3] whole path, small f32 model, four store layouts: cpu "
            "(plain) vs gpu (kernels)")
        small = phase_small(dev)
        log(f"[3] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[4] whole path, full width: t5-base bf16 retrieve, three store "
            "layouts, then the f32 model on packed f32")
        full = phase_full(dev, smi, trie, profile="profile" in argv)
        log(f"[4] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[5] the other options at full width: t5-base bf16, packed "
            "bf16 store, four modes")
        modes = phase_modes(dev, smi, trie, profile="profile" in argv)
        log(f"[5] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[6] index build and expansion on the card: tiny tower and "
            "Lloyd vs the CPU, the CLI, the BERT-base tower, k-means at NQ "
            "scale, serving the built index, 2,048 docs inserted")
        index = phase_index(dev, smi, root, work, profile="profile" in argv)
        log(f"[6] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[7] training on the card: small f32 card vs CPU, t5-base "
            "stage 1 and stage 2 steps, TrainLoop with eval, checkpoints and "
            "resume, the CLI's train -> eval")
        train = phase_train(dev, smi, root, work, profile="profile" in argv)
        log(f"[7] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[8] the secondary modes on the card: small f32 card vs CPU, qg "
            "at t5-base, train --ensemble 3 and its eval, --hierarchic, "
            "--softmax, the CLI's qg -> train --qg and --ensemble 2")
        secondary = phase_secondary(dev, smi, root, work, trie,
                                    profile="profile" in argv)
        log(f"[8] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log("[9] pretrained starts and ingest: HF-layout T5 and BERT "
            "directories on the card vs the CPU, the reference fork's model, "
            "t5-base and BERT-base loads and a warm-started f32 retrieve, "
            "the CLI's ingest -> index --bert-ckpt -> train --t5-ckpt "
            "--bert-ckpt -> eval")
        pretrained = phase_pretrained(dev, smi, root, work, trie)
        log(f"[9] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log(f"[10] serving over a sharded store: {MESH_RANKS} ranks over "
            f"{_mesh_backend()} (small f32 card and cpu vs one device; "
            f"t5-base f32 on three layouts vs one card), then the CLI's "
            f"retrieve / eval --mesh under torch.distributed.run with nccl")
        sharded = phase_sharded(dev, smi, root, work, trie)
        log(f"[10] {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        log(f"[11] training over a mesh: {MESH_RANKS} ranks over "
            f"{_mesh_backend()} (small f32 TrainLoop at dp=4, 2x2 and 1x4 vs "
            f"one card, its eval through each rank's kernels; column-"
            f"parallel t5-base steps at dp=2 x mp=2 and dp=1 x mp=4)")
        train_mesh = phase_train_mesh(dev, smi, work)
        log(f"[11] {time.perf_counter() - t:.1f} s")
    except Failed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"retrieve": full["layouts"],
                      "peak_gib": full["peak_gib"], "modes": modes,
                      "index": index, "train": train,
                      "secondary": secondary, "pretrained": pretrained,
                      "sharded": sharded, "train_mesh": train_mesh}),
          flush=True)
    print(json.dumps({"kernels": kernel_rows(stats, full, index, train,
                                             secondary, pretrained,
                                             sharded, train_mesh, small)}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
