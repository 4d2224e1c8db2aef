"""The controls of the serving cells whose driver is ``serve_kimi_linear``:
each puts a known fault in the program's place and must come out not
correct.

- ``--fault tf32``: ``control_moonlight.py``'s TF32 control with the Kimi
  Linear reference (its products in TF32, compared with the f32 reference
  as the program is; the f32 reference follows the TF32 one's routing
  near ties);
- ``--fault rerank``: ``control_moonlight.py``'s re-rank control (the f32
  reference's own beams, the re-rank's product on TF32-rounded operands);
- ``--fault unreordered``: the cell itself (a short timed window, then the
  comparison), the program's KDA states left unreordered: every beam row
  keeps the state of its own slot (row r reads row r modulo the last
  step's rows) instead of its source beam's.  It shows that the
  comparison sees the recurrent state's reorder.

    python3 gdrbench/control_kimi_linear.py --cell serve-b1-kimi-linear \\
        --seeds 1 2 [--fault tf32|rerank|unreordered]

Prints one JSON line per seed, then whether each was correct.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gdrbench import control_moonlight, harness  # noqa: E402
from gdrbench.reference import kimi_linear as ref_kimi  # noqa: E402


@contextlib.contextmanager
def _kimi_reference():
    plain, control_moonlight.ref_ds = control_moonlight.ref_ds, ref_kimi
    try:
        yield
    finally:
        control_moonlight.ref_ds = plain


@contextlib.contextmanager
def unreordered_states():
    """The beam search's reorder with ``rec_src`` replaced by each row's
    own slot (modulo the rows of the step the states come from)."""
    from gdr_tpu_torch.ops import beam
    plain = beam._reorder_cache

    def own_slot(cache, src):
        out = plain(cache, src)
        if "rec_src" in out:
            rows = torch.arange(src.numel(), device=src.device)
            out["rec_src"] = torch.remainder(rows, src.max() + 1).to(
                torch.int32)
        return out
    beam._reorder_cache = own_slot
    try:
        yield
    finally:
        beam._reorder_cache = plain


def unreordered(cell, seed: int, device) -> dict:
    spec = importlib.util.spec_from_file_location("gdrbench_run",
                                                  ROOT / "gdrbench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    with unreordered_states():
        r = run.execute(cell.name, seed, 2.0, False, str(device), root=ROOT)
    return {"seed": seed, "fault": "unreordered", "checks": {
        k: c["value"] for k, c in r["checks"].items()}, "correct": r["correct"],
        "info": {k: r["info"].get(k) for k in ("compared_queries",
                                                "route_follow_share")}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("tf32", "rerank", "unreordered"),
                    default="tf32")
    args = ap.parse_args()
    run = {"tf32": control_moonlight.control,
           "rerank": control_moonlight.rerank_control,
           "unreordered": unreordered}[args.fault]
    harness.set_cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell(harness.load_spec(ROOT), args.cell, ROOT)
    rows = []
    for seed in args.seeds:
        with _kimi_reference():
            rows.append(run(cell, seed, torch.device("cuda:0")))
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"cell": args.cell, "fault": args.fault,
                      "correct": [r["correct"] for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
