#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone (training over a mesh of four
ranks), after the kernels' build: the quick way to measure or debug it on
a GPU machine.  Four ranks share the one card over gloo, or take a card
each over nccl on a machine of four or more cards.  Prints the phase's log
and writes its JSON to ``chiprun_out/train_mesh.json``.

    python3 tools/train_mesh_phase.py
"""

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("train_mesh_phase.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gdr_tpu_torch import native
    from gdr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(f"{smi[0]} x {len(smi)}; torch {torch.__version__}", flush=True)
    print(f"build {build.build_all():.1f} s; {native.build().name}",
          flush=True)
    work = Path(tempfile.mkdtemp(prefix="gdr_train_mesh_"))
    try:
        t = time.perf_counter()
        out = chip_smoke.phase_train_mesh(torch.device("cuda", 0), smi[0],
                                          work)
        print(f"phase 11 {time.perf_counter() - t:.1f} s", flush=True)
    except chip_smoke.Failed as e:
        print(f"train_mesh_phase.py: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_mesh.json").write_text(json.dumps(out))
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
