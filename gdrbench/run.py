"""Run one cell of the benchmark once and print its result line.

    python3 gdrbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, driver and metrics come from
``BENCHMARK.json`` and the files it names (``harness.py``).  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the profiler's trace of a
further traced stretch after the window.  Every run compares what the
timed path produced with the plain reference, prints each compared number
beside its limit as the last lines of standard error, and prints one JSON
object as the last line of standard output.  It exits non-zero, with no
result, when the card or the cards the cell needs are missing, or when a
module of the JAX stack or of the JAX package was loaded, in this process
or in a rank process that it started.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gdrbench import harness  # noqa: E402


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            root: Path = ROOT, t_start: float | None = None) -> dict:
    """Run the cell ``name`` on ``device`` and return its result object;
    the caller has checked the device."""
    import torch

    spec = harness.load_spec(root)
    cell = harness.cell(spec, name, root)
    run = harness.Run.of(cell, seed, seconds, trace, torch.device(device),
                         T_START if t_start is None else t_start, root)
    out = cell.driver.run(run)
    checks = out["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    if trace:
        metrics = harness.read_layer_metrics(cell, out["layer"], root)
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and "trace" in out["layer"]:
        tr = out["layer"]["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["info"] = out.get("info", {})
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs(ROOT)
    spec = harness.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result = execute(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0")
        bad = harness.forbidden_modules()
        if bad:
            raise harness.ForbiddenModules(", ".join(bad))
    except harness.ForbiddenModules as e:
        print(f"modules of the JAX stack or package were loaded: {e}",
              file=sys.stderr)
        return 3
    limit = _power_limit()
    if limit:
        result["device"]["power_limit"] = limit
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
