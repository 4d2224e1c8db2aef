"""The TF32 control of the serving cells whose driver is ``serve_moonlight``:
the Moonlight reference with its products in TF32, put in the program's
place and compared with the f32 reference as the program is.  The f32
reference follows the TF32 one's routing near ties, as it follows the
program's (the TF32 reference logs its decisions within
``reference/moonlight.py``'s ``LOG_GAP``, ten times the tie gap), and
``selection_err`` is the largest |TF32 − f32| selection score over the
first compared query's tokens.

TF32 changes every compared query's beam set at this cell's widths, so
that ``fused_err`` and ``top_r_gap`` read 0 there.  ``--fault rerank``
reads them: the f32 reference's own beams, with the re-rank's one product
(the store's rows · the query embedding) taken on operands rounded to TF32
(10 explicit mantissa bits, as TF32 tensor cores read f32), in the
program's place, against the same reference's f32 re-rank.

    python3 gdrbench/control_moonlight.py --cell serve-b1-moonlight \\
        --seeds 1 2 [--fault tf32|rerank]

Prints one JSON line per seed, then whether each was correct.
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

from gdrbench import harness  # noqa: E402
from gdrbench.drivers.serve import as_served  # noqa: E402
from gdrbench.reference import model as M  # noqa: E402
from gdrbench.reference import moonlight as ref_ds  # noqa: E402
from gdrbench.reference import serve as S  # noqa: E402
from gdrbench.traffic.world import queries, sub_seed  # noqa: E402


def _scores(w, m, ids, mask, follow, log) -> list:
    n = int(mask[0].sum())
    x = w["shared.weight"][torch.as_tensor(ids[0, :n],
                                           device=w["shared.weight"].device)]
    out: list = []
    with torch.no_grad():
        ref_ds.stack(w, m, x[None], lambda _, l: (0, ("p", l)), follow,
                     ref_ds.Routing(log=log), out)
    return out


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to 10 explicit mantissa bits (nearest,
    halves away from zero), as TF32 tensor cores read an f32 operand."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _setup(cell, seed: int, device):
    """The run's context, its compared requests and the weights."""
    ctx = harness.Run.of(cell, seed, 0.0, False, device, 0.0, ROOT)
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
    model, w = drv.build(ctx)
    return ctx, max_len, ids, mask, picks, model, w


def rerank_control(cell, seed: int, device) -> dict:
    """The f32 reference's beams with a TF32 re-rank against the same
    beams' f32 re-rank, compared as the program is."""
    drv, tr, cfg = cell.driver, cell.traffic, cell.config
    m = cfg["model"]
    ctx, max_len, ids, mask, picks, model, w = _setup(cell, seed, device)
    low, plain = [], S.rerank

    def both(store, q, beams, *rest):
        low.append(plain(to_tf32(store), to_tf32(q), beams, *rest))
        return plain(store, q, beams, *rest)
    S.rerank = both
    try:
        ref, cids = drv.reference_outputs(ctx, w, ids, mask, picks,
                                          [None] * len(picks), max_len)
    finally:
        S.rerank = plain
    served = [as_served(beams, lr, m["kary"], cfg["eval"]["num_beams"],
                        max_len) for (beams, _), lr in zip(ref, low)]
    got, info = drv.numbers(served, ref, m["kary"],
                            cfg["eval"]["score_rates"], cids)
    got["selection_err"] = 0.0               # one stack, one routing
    checks = {k: got[k] for k in drv.CHECKS}
    del model, w
    return {"seed": seed, "fault": "rerank", "checks": checks, **info,
            "correct": all(v <= tr["limits"][k] for k, v in checks.items())}


def control(cell, seed: int, device) -> dict:
    drv, tr, cfg = cell.driver, cell.traffic, cell.config
    m = cfg["model"]
    ctx, max_len, ids, mask, picks, model, w = _setup(cell, seed, device)
    logs = [{} for _ in picks]
    low, _ = drv.reference_outputs(ctx, w, ids, mask, picks,
                                   [None] * len(picks), max_len, tf32=True,
                                   logs=logs)
    routes = [{k: (v, None) for k, v in log.items()} for log in logs]
    ref, cids = drv.reference_outputs(ctx, w, ids, mask, picks, routes,
                                      max_len)
    served = [as_served(lb, lr, m["kary"], cfg["eval"]["num_beams"], max_len)
              for lb, lr in low]
    got, info = drv.numbers(served, ref, m["kary"],
                            cfg["eval"]["score_rates"], cids)
    j = picks[0]
    log: dict = {}
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lo = _scores(w, m, ids[j], mask[j], None, log)
    finally:
        M.f32_matmul_only()
    hi = _scores(w, m, ids[j], mask[j], lambda layer, key: log.get(
        (layer, key)), None)
    got["selection_err"] = max(float((a - c).abs().max())
                               for a, c in zip(lo, hi))
    checks = {k: got[k] for k in drv.CHECKS}
    del model, w
    return {"seed": seed, "fault": "tf32", "checks": checks, **info,
            "correct": all(v <= tr["limits"][k] for k, v in checks.items())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("tf32", "rerank"), default="tf32")
    args = ap.parse_args()
    run = control if args.fault == "tf32" else rerank_control
    harness.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(harness.load_spec(ROOT), args.cell, ROOT)
    rows = []
    for seed in args.seeds:
        rows.append(run(cell, seed, torch.device("cuda:0")))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"cell": args.cell, "fault": args.fault,
                      "correct": [r["correct"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
