"""The readings that a cell's limits are set from, on the chip at the
cell's own size: the program's compared numbers over many seeds (the
lower reading), and the control's (the upper): the plain reference one
precision below the configuration's, put in the program's place and
compared with the reference as the program is.

    python3 gdrbench/control.py --cell serve-b32 --which program \\
        --seeds 1 2 3 ... [--seconds 1]
    python3 gdrbench/control.py --cell serve-b32 --which control --seeds 1 2 3
    python3 gdrbench/control.py --cell train-b64 --which half-batch --seeds 1 2 3

Serving's control computes the reference's products in TF32 (the
configuration is float32 with TF32 off); training's rounds every
product's operands to float8 e4m3 (the configuration computes in
bfloat16); ``half-batch`` puts the reference over each batch's first
half, its mean over those rows, in the program's place (a fault of step
3).  The benchmark's runs never run this; a card-only test does.
Prints one JSON line per seed, then the largest and smallest reading of
each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gdrbench import compare, harness  # noqa: E402
from gdrbench.traffic.world import bench_cid_map, queries, sub_seed  # noqa: E402


def _run_module():
    """``run.py`` (a script, loaded by path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gdrbench_run", ROOT / "gdrbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    return run


def _ctx(cell, seed: int, device) -> harness.Run:
    return harness.Run.of(cell, seed, 0.0, False, device, 0.0, ROOT)


def control_serve(cell, seed: int, device) -> dict:
    """The TF32 reference against the f32 one over the retrieves a run of
    this seed would compare."""
    ctx = _ctx(cell, seed, device)
    drv = cell.driver
    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    _, max_len = drv._world(ctx)
    n = tr["check_requests"] * 4
    b, s = tr["batch"], cfg["max_input_length"]
    ids, mask = queries(tr["lengths"], n * b, s, m["vocab_size"],
                        sub_seed(seed, drv.SEED_QUERIES))
    ids, mask = ids.reshape(n, b, s), mask.reshape(n, b, s)
    picks = drv.sample(ctx, n, mask)
    low, _ = drv.reference_outputs(ctx, ids, mask, picks, max_len, tf32=True)
    ref, cids = drv.reference_outputs(ctx, ids, mask, picks, max_len)
    parts = [compare.serve_numbers(
        drv.as_served(lb, lr, m["kary"], cfg["eval"]["num_beams"], max_len),
        rb, rr, m["kary"], cfg["eval"]["score_rates"], cids)
        for (lb, lr), (rb, rr) in zip(low, ref)]
    got = compare.merge(parts)
    checks = {k: got[k] for k in compare.SERVE_NUMBERS}
    return {"seed": seed, "checks": checks,
            "correct": all(v <= tr["limits"][k] for k, v in checks.items()),
            "tie_excluded": got["tie_excluded"], "queries": got["queries"]}


def control_train(cell, seed: int, device, fault: bool = False) -> dict:
    """The float8 reference's readings against the f32 reference's
    (``fault``: the f32 reference over each batch's first half, the mean
    taken over it, in the program's place)."""
    ctx = _ctx(cell, seed, device)
    drv = cell.driver
    cfg, tr = cell.config, cell.traffic
    m, t, st = cfg["model"], cfg["train"], cfg["store"]
    cid_map = bench_cid_map(st["n_docs"], st["kary"], st["leaf_cap"])
    n_rows = (tr["check_steps"] + 1) * t["train_batch_size"] * cell.chips
    from gdrbench.traffic.world import train_set
    ts = train_set(tr["lengths"], n_rows, cfg["max_input_length"],
                   m["vocab_size"], cid_map, m["kary"],
                   m["max_output_length"], sub_seed(seed, drv.SEED_QUERIES))
    low = (drv.reference(ctx, ts, cid_map, half=True) if fault else
           drv.reference(ctx, ts, cid_map, lowp=torch.float8_e4m3fn))
    gc.collect()
    ref = drv.reference(ctx, ts, cid_map)
    vals, left = drv.numbers(low, ref)
    return {"seed": seed, "checks": vals, "leaves_left_out": left,
            "losses": low["losses"], "reference_losses": ref["losses"],
            "correct": all(vals[k] <= lim for k, lim in tr["limits"].items())}


def readings(name: str, seeds, which: str, seconds: float = 1.0,
             device: str = "cuda:0") -> list[dict]:
    """One row per seed: the compared numbers of a short run of the
    program (``program``) or of the control (``control``)."""
    spec = harness.with_pending(harness.load_spec(ROOT), ROOT)
    cell = harness.cell(spec, name, ROOT)
    rows = []
    for seed in seeds:
        if which == "program":
            r = _run_module().execute(name, seed, seconds, False, device)
            rows.append({"seed": seed, "correct": r["correct"],
                         "checks": {k: c["value"]
                                    for k, c in r["checks"].items()},
                         "info": r["info"]})
        elif cell.traffic["driver"] == "serve":
            rows.append(control_serve(cell, seed, torch.device(device)))
        else:
            rows.append(control_train(cell, seed, torch.device(device),
                                      fault=which == "half-batch"))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--which", choices=("program", "control", "half-batch"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    harness.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rows = readings(args.cell, args.seeds, args.which, args.seconds)
    keys = rows[0]["checks"]
    print(json.dumps({"which": args.which, "cell": args.cell,
                      "max": {k: max(r["checks"][k] for r in rows)
                              for k in keys},
                      "min": {k: min(r["checks"][k] for r in rows)
                              for k in keys},
                      "correct": [r["correct"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
