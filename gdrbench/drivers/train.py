"""Training: the port's stage-1 ``train_step`` (``make_train_step(...,
stage=1)``) at ``TrainConfig``'s defaults, bf16 compute over f32 masters,
fed by the port's ``BatchIterator`` inside the window.

Set-up builds one step with its model and optimiser state, and drives it
through its first ``check_steps`` steps through the window's own call and
feed (the warm-up, with every shape of the cell); the window goes on with
that same state and iterator for ``seconds``, then synchronises.  The
reference (``reference/train.py``) follows the first steps from the same
weights, batches and draws, once the program is freed: each step's loss,
the first step's gradient as the optimiser took it (the moment after one
step over 1 − β1), leaf by leaf, and each leaf's change after the checked
steps.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import statistics
import time

import torch

from gdrbench import costs, harness, trace
from gdrbench.reference import model as ref_model
from gdrbench.reference import train as ref_train
from gdrbench.traffic.world import (bench_cid_map, sub_seed, train_set,
                                    unit_store)
from gdrbench.weights import load_into, make_weights

SEED_WEIGHTS, SEED_STORE, SEED_QUERIES, SEED_ITER, SEED_STEP = 1, 2, 3, 4, 5
TRAIN_KEYS = ("train_batch_size", "learning_rate", "decoder_learning_rate",
              "weight_decay", "adam_epsilon", "warmup_steps", "scheduler",
              "max_grad_norm", "gradient_accumulation_steps", "tau",
              "intra_rate", "loss_func", "bf16")
# compared; the first step's loss gap is reported beside them, not compared:
# neither the control nor a fault reads 3x its sound runs' reading
NUMBERS = ("grad_leaf_gap", "delta_leaf_gap")
# leaves whose reference gradient is under this share of the median leaf's
# are rounding noise that Adam scales to whole steps: left out of the gaps
LEAF_FLOOR = 1e-3


def _norms(tensors: dict, scale: float = 1.0) -> dict[str, float]:
    names = list(tensors)
    got = torch._foreach_norm([tensors[n].float() for n in names])
    return {n: float(v) * scale for n, v in zip(names, got)}


def run(ctx) -> dict:
    """One process on one card, or ``ctx.chips`` rank processes."""
    if ctx.chips > 1:
        return spawn_ranks(ctx)
    r = body(ctx, None)
    checks, info = check(ctx, r)
    return {"attempted": r["steps"] * r["batch"], "failed": 0,
            "end_to_end": {"setup_s": r["window_start"] - ctx.t_start,
                           "train_examples_per_s": r["steps"] * r["batch"]
                           / r["layer"]["window_s"]},
            "layer": r["layer"], "memory_peak_bytes": r["peak"],
            "checks": checks,
            "info": {**info, "steps": r["steps"], "losses": r["losses"]}}


def body(ctx, mesh) -> dict:
    """Set-up, the checked steps, the window and the traced steps of one
    process (``mesh``: this rank's, the global batch and the store cut
    over it); the program is freed before it returns."""
    from gdr_tpu_torch.config import (DataConfig, GDRConfig, ModelConfig,
                                      TrainConfig)
    from gdr_tpu_torch.data.dataset import (BatchIterator, TrainSet,
                                            cluster_docs_lookup)
    from gdr_tpu_torch.models.gdr import GenerativeRetriever
    from gdr_tpu_torch.train.trainer import init_train_state, make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    m, t, st = cfg["model"], cfg["train"], cfg["store"]
    if t["gradient_accumulation_steps"] != 1:
        raise ValueError("the reference takes one AdamW step a batch")
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    bsz, s = t["train_batch_size"] * ctx.chips, cfg["max_input_length"]
    cid_map = bench_cid_map(st["n_docs"], st["kary"], st["leaf_cap"])
    n_rows = (math.ceil(ctx.seconds * tr["max_steps_per_s"])
              + tr["check_steps"] + tr["trace_steps"]) * bsz
    ts = train_set(tr["lengths"], n_rows, s, m["vocab_size"], cid_map,
                   m["kary"], m["max_output_length"],
                   sub_seed(ctx.seed, SEED_QUERIES))
    batcher = BatchIterator(
        TrainSet(**{k: ts[k] for k in ("input_ids", "attn_mask", "labels",
                                       "label_mask", "pos_idx")},
                 source=["gtq"] * n_rows),
        cluster_docs_lookup(ts["cid_of"]), bsz, t["max_intraclass_num"],
        seed=sub_seed(ctx.seed, SEED_ITER))

    def epochs():             # epoch after epoch, each a new permutation
        while True:
            yield from batcher
    it = epochs()
    store = unit_store(st["n_docs"], m["encoder_d_model"],
                       sub_seed(ctx.seed, SEED_STORE), dev)
    if mesh is not None:
        from gdr_tpu_torch.parallel.store import place_store
        store = place_store(store, mesh, dev)
    weights = make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev)
    with torch.device("meta"):
        model = GenerativeRetriever(ModelConfig(**m))
    load_into(model, weights, torch.float32)
    del weights
    gcfg = GDRConfig(model=ModelConfig(**m),
                     train=TrainConfig(**{**{k: t[k] for k in TRAIN_KEYS},
                                          "train_batch_size": bsz}),
                     data=DataConfig(max_input_length=s,
                                     max_intraclass_num=t["max_intraclass_num"]))
    state, opt = init_train_state(gcfg, model, None,
                                  total_steps=t["total_steps"])
    step = make_train_step(model, None, opt, gcfg, stage=t["stage"],
                           mesh=mesh)
    seed = sub_seed(ctx.seed, SEED_STEP)

    losses, grads1, step_s = [], {}, []
    for k in range(tr["check_steps"]):
        sync()
        t1 = time.perf_counter()
        state, met = step(state, next(it), store, seed)
        losses.append(float(met["loss"]))
        step_s.append(time.perf_counter() - t1)
        if k == 0:
            grads1 = _norms({n.split("/", 1)[1]: v for n, v in
                             state.opt_state["mu"].items()},
                            1.0 / (1.0 - ref_train.B1))
    w0 = make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev)
    masters = state.params["generator"]
    delta = _norms({n: masters[n] - w0[n] for n in masters})
    del w0
    n_steps = None
    if mesh is not None:
        # every rank runs the same steps: as many as the slowest rank's
        # last checked step says fit the window
        est = torch.tensor([min(step_s[1:] or step_s)], device=dev)
        torch.distributed.all_reduce(est, op=torch.distributed.ReduceOp.MAX)
        n_steps = max(1, round(ctx.seconds / float(est)))
        torch.distributed.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()

    t0 = time.perf_counter()
    window_start = t0 if mesh is None else time.time()
    n = 0
    while (n < n_steps if n_steps is not None
           else time.perf_counter() - t0 < ctx.seconds):
        state, _ = step(state, next(it), store, seed)
        n += 1
    sync()
    if mesh is not None:
        torch.distributed.barrier()
    window_s = time.perf_counter() - t0

    n_params = sum(p.numel() for p in model.parameters())
    layer = {"kind": "train", "units": n, "window_s": window_s,
             "chips": ctx.chips, "peak_flops": costs.H100_BF16_FLOPS,
             "flops_per_unit": costs.train_step_cost(m, 2 * bsz, s,
                                                     n_params)[0]}
    if ctx.trace:
        k = tr["trace_steps"]

        def traced_steps():
            nonlocal state
            for _ in range(k):
                state, _ = step(state, next(it), store, seed)
        if mesh is None or mesh.rank == 0:
            layer["trace"] = trace.traced(traced_steps)
        else:
            traced_steps()
            sync()
        layer["trace_units"] = k
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state, opt, step, model, store
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"losses": losses, "grads1": grads1, "delta": delta, "steps": n,
            "batch": bsz, "layer": layer, "peak": peak,
            "window_start": window_start, "ts": ts, "cid_map": cid_map}


def reference(ctx, ts: dict, cid_map: dict, lowp=None,
              half: bool = False) -> dict:
    """The reference's readings over the checked steps (``lowp``: computed
    in that dtype, the control; ``half``: each batch's first half only,
    its mean over those rows, a fault)."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    m, t, st = cfg["model"], cfg["train"], cfg["store"]
    ref_model.f32_matmul_only()
    w = make_weights(m, sub_seed(ctx.seed, SEED_WEIGHTS), dev)
    store = unit_store(st["n_docs"], m["encoder_d_model"],
                       sub_seed(ctx.seed, SEED_STORE), dev)
    docs_of = [cid_map[c] for c in ts["cid_of"]]
    batch_list = ref_train.batches(ts, docs_of,
                                   t["train_batch_size"] * ctx.chips,
                                   t["max_intraclass_num"] + 1,
                                   sub_seed(ctx.seed, SEED_ITER),
                                   tr["check_steps"])
    if half:
        batch_list = [{k: v[:len(v) // 2] for k, v in b.items()}
                      for b in batch_list]
    seed = sub_seed(ctx.seed, SEED_STEP)
    with (ref_train.computed_in(lowp) if lowp is not None
          else contextlib.nullcontext()):
        return ref_train.train(w, m, t, batch_list, store, seed,
                               dp=ctx.chips)


def numbers(got: dict, ref: dict) -> tuple[dict, int]:
    """The compared numbers of a run's readings ``got`` against the
    reference's: the first step's relative loss gap (the later steps'
    carry the rounding of the earlier updates, which Adam's near-sign
    first steps magnify), and the worst leaf's
    gap of first-gradient norms and of change norms, each against the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves under ``LEAF_FLOOR`` are left out; their count is returned."""
    loss = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_med = statistics.median(ref["grad_norms"].values())
    d_med = statistics.median(ref["delta_norms"].values())
    keep = [n for n, v in ref["grad_norms"].items() if v >= LEAF_FLOOR * g_med]

    def gap(key, med):
        return max(abs(got[key][n] - ref[key][n]) / max(ref[key][n], med)
                   for n in keep)
    return ({"loss0_rel_err": loss,
             "grad_leaf_gap": gap("grad_norms", g_med),
             "delta_leaf_gap": gap("delta_norms", d_med)},
            len(ref["grad_norms"]) - len(keep))


def check(ctx, r: dict) -> tuple[dict, dict]:
    """The compared numbers of a run's readings ``r`` beside their limits."""
    tr = ctx.traffic
    t = time.perf_counter()
    ref = reference(ctx, r["ts"], r["cid_map"])
    got = {"losses": r["losses"], "grad_norms": r["grads1"],
           "delta_norms": r["delta"]}
    vals, left_out = numbers(got, ref)
    checks = {k: (vals[k], tr["limits"][k]) for k in NUMBERS}
    return checks, {"loss0_rel_err": vals["loss0_rel_err"],
                    "leaves_left_out": left_out,
                    "reference_losses": ref["losses"],
                    "reference_s": time.perf_counter() - t}


# ------------------------------------------------- data parallel over cards

RANK_TIMEOUT = 900


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(ctx) -> dict:
    """``ctx.chips`` rank processes, one a card, joined over ``nccl``
    (dp = chips, mp = 1): each makes its inputs from the seed and steps the
    global batch's rows it owns; rank 0 times the window, traces, runs the
    reference and reports through a file in a directory under ``TMPDIR``."""
    import gdr_tpu_torch

    start_wall = time.time() - (time.perf_counter() - ctx.t_start)
    port = _free_port()
    # the ranks import the benchmark and the program from where this
    # process found them
    path = [str(ctx.root),
            os.path.dirname(os.path.dirname(gdr_tpu_torch.__file__)),
            os.environ.get("PYTHONPATH", "")]
    with tempfile.TemporaryDirectory(prefix="gdrbench-ranks-") as out:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r),
             "--world", str(ctx.chips), "--port", str(port),
             "--cell", ctx.cell, "--seed", str(ctx.seed),
             "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)),
             "--root", str(ctx.root), "--out", out,
             "--device", ctx.device.type],
            env={**os.environ, "PYTHONPATH": os.pathsep.join(path)})
            for r in range(ctx.chips)]
        try:
            codes = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"rank processes exited with {codes}")
        res = [json.loads(open(os.path.join(out, f"rank{r}.json")).read())
               for r in range(ctx.chips)]
    bad = {r: x["forbidden"] for r, x in enumerate(res) if x["forbidden"]}
    if bad:
        raise harness.ForbiddenModules(
            ", ".join(f"rank {r}: {m}" for r, m in bad.items()))
    r0 = res[0]
    layer = r0["layer"]
    if "trace" in layer:
        layer["trace"] = trace.Trace(**layer["trace"])
    checks = {k: tuple(v) for k, v in r0["checks"].items()}
    return {"attempted": r0["steps"] * r0["batch"], "failed": 0,
            "end_to_end": {"setup_s": r0["window_start"] - start_wall,
                           "train_examples_per_s": r0["steps"] * r0["batch"]
                           / layer["window_s"]},
            "layer": layer, "memory_peak_bytes": max(r["peak"] for r in res),
            "checks": checks,
            "info": {**r0["info"], "steps": r0["steps"],
                     "losses": r0["losses"]}}


def rank_main(argv=None) -> int:
    """One rank process of :func:`spawn_ranks`."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser()
    for a in ("--rank", "--world", "--port", "--seed", "--trace"):
        ap.add_argument(a, type=int, required=True)
    for a in ("--cell", "--root", "--out", "--device"):
        ap.add_argument(a, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from gdr_tpu_torch.config import MeshConfig
    from gdr_tpu_torch.parallel import distributed
    from gdr_tpu_torch.parallel.mesh import make_mesh

    root = args.root
    cell = harness.cell(harness.load_spec(root), args.cell, root)
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
        dev = torch.device("cuda", args.rank)
    else:
        dev = torch.device("cpu")
    distributed.initialize(f"localhost:{args.port}", args.world, args.rank,
                           "nccl" if args.device == "cuda" else "gloo")
    ctx = harness.Run.of(cell, args.seed, args.seconds, bool(args.trace),
                         dev, time.perf_counter(), root)
    try:
        mesh = make_mesh(MeshConfig(dp=args.world, mp=1), device=dev)
        r = body(ctx, mesh)
        torch.distributed.barrier()
    finally:
        distributed.shutdown()
    out = {k: r[k] for k in ("losses", "steps", "batch", "peak",
                             "window_start")}
    if args.rank == 0:
        checks, info = check(ctx, r)
        layer = dict(r["layer"])
        if "trace" in layer:
            layer["trace"] = dataclasses.asdict(layer["trace"])
        out.update(layer=layer, checks=checks, info=info)
    # the window, the trace and the reference are over in this process
    out["forbidden"] = harness.forbidden_modules()
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
