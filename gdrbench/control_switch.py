"""The TF32 control of the serving cells whose driver is ``serve_switch``
(``control.py`` runs the ``serve`` driver's): the Switch reference with its
products in TF32, put in the program's place and compared with the f32
reference as the program is, router ties left out as for the program.

    python3 gdrbench/control_switch.py --cell serve-b1-switch128 \\
        --seeds 1 2 3

The program's readings of such a cell come from ``control.py --which
program``.  Prints one JSON line per seed, then whether each was correct.
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
from gdrbench.traffic.world import queries, sub_seed  # noqa: E402


def control(cell, seed: int, device) -> dict:
    """The TF32 reference against the f32 one over the retrieves a run of
    this seed would compare."""
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
    low, _ = drv.reference_outputs(ctx, ids, mask, picks, max_len, tf32=True)
    ref, cids = drv.reference_outputs(ctx, ids, mask, picks, max_len)
    served = [as_served(lb, lr, m["kary"], cfg["eval"]["num_beams"], max_len)
              for lb, lr in low]
    got, info = drv.numbers(served, ref, m["kary"],
                            cfg["eval"]["score_rates"], cids)
    checks = {k: got[k] for k in drv.CHECKS}
    return {"seed": seed, "checks": checks, **info,
            "correct": all(v <= tr["limits"][k] for k, v in checks.items())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(harness.load_spec(ROOT), args.cell, ROOT)
    rows = []
    for seed in args.seeds:
        rows.append(control(cell, seed, torch.device("cuda:0")))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"cell": args.cell,
                      "correct": [r["correct"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
