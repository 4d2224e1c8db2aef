"""Checkpoints with the reference's selection policy, in the port's own
format (the counterpart of ``gdr_tpu/train/checkpoint.py``, which rides on
orbax).

A checkpoint is one ``torch.save`` file ``<step>.pt`` holding the f32
master parameters, the optimizer state, the step and the epoch's metrics,
all on the CPU; it is written to a temporary name and renamed into place,
so a reader never sees half a file.  Two directories:

- ``<dir>``: best-k retention by the ``monitor`` metric (max, or min for a
  ``*loss`` monitor; ties keep the newer step; a checkpoint without the
  metric ranks last), with ``metrics.json`` beside the files;
- ``<dir>_preempt``: the latest-1 resume point, written at every epoch's
  end and on preemption, kept apart so best-k retention never deletes it.

:meth:`CheckpointManager.restore_latest` prefers the resume point when it
is strictly newer than the newest best-k step, and says so (``preempted``):
a mid-epoch save means that epoch must run again.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from gdr_tpu_torch.config import TrainConfig
from gdr_tpu_torch.train.trainer import TrainState


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _write_atomic(path: str, payload) -> None:
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(directory)
                  if f.endswith(".pt") and f[:-3].isdigit())


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "recall1",
                 mode: str = "max", save_top_k: int = 1):
        self.directory = os.path.abspath(directory)
        self.preempt_dir = self.directory + "_preempt"
        self.monitor = monitor
        self.mode = mode
        self.keep = max(save_top_k, 1)

    @classmethod
    def from_config(cls, cfg: TrainConfig, directory: str | None = None
                    ) -> "CheckpointManager":
        mode = "min" if cfg.monitor.endswith("loss") else "max"
        return cls(directory or cfg.checkpoint_dir, monitor=cfg.monitor,
                   mode=mode, save_top_k=cfg.save_top_k)

    # ---------------------------------------------------------------- save

    def _metrics(self) -> dict[int, dict]:
        path = os.path.join(self.directory, "metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as fh:
            return {int(k): v for k, v in json.load(fh).items()}

    def _rank(self, metrics: dict) -> float:
        v = metrics.get(self.monitor)
        if v is None:
            return float("-inf")
        return float(v) if self.mode == "max" else -float(v)

    def save(self, step: int, state: TrainState, metrics: dict) -> None:
        """Write ``state`` as best-k candidate ``step``, then keep the best
        ``save_top_k``."""
        os.makedirs(self.directory, exist_ok=True)
        metrics = {k: float(v) for k, v in metrics.items()}
        _write_atomic(os.path.join(self.directory, f"{step}.pt"),
                      {"params": _to_cpu(state.params),
                       "opt_state": _to_cpu(state.opt_state),
                       "step": int(state.step), "metrics": metrics})
        table = self._metrics()
        table[step] = metrics
        kept = sorted(table, key=lambda s: (self._rank(table[s]), s))
        kept = set(kept[-self.keep:])
        for s in list(table):
            if s not in kept:
                path = os.path.join(self.directory, f"{s}.pt")
                if os.path.exists(path):
                    os.remove(path)
                del table[s]
        tmp = os.path.join(self.directory, "metrics.json.tmp")
        with open(tmp, "w") as fh:
            json.dump({str(k): v for k, v in table.items()}, fh)
        os.replace(tmp, os.path.join(self.directory, "metrics.json"))

    def save_preemption(self, step: int, state: TrainState) -> None:
        """The latest-1 resume point at ``step``, outside best-k
        retention."""
        os.makedirs(self.preempt_dir, exist_ok=True)
        _write_atomic(os.path.join(self.preempt_dir, f"{step}.pt"),
                      {"params": _to_cpu(state.params),
                       "opt_state": _to_cpu(state.opt_state),
                       "step": int(state.step), "metrics": {}})
        for s in _steps(self.preempt_dir):
            if s != step:
                os.remove(os.path.join(self.preempt_dir, f"{s}.pt"))

    # ------------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        table = {s: m for s, m in self._metrics().items()
                 if s in _steps(self.directory)}
        if not table:
            return None
        return max(table, key=lambda s: (self._rank(table[s]), s))

    @staticmethod
    def _load(path: str, device) -> tuple[TrainState, dict]:
        raw = torch.load(path, map_location=device, weights_only=True)
        return (TrainState(params=raw["params"], opt_state=raw["opt_state"],
                           step=int(raw["step"])), raw["metrics"])

    def restore(self, step: int, device="cpu") -> TrainState:
        return self._load(os.path.join(self.directory, f"{step}.pt"),
                          device)[0]

    def restore_latest(self, device="cpu"
                       ) -> tuple[Optional[int], Optional[TrainState], bool]:
        """``(step, state, preempted)``; ``(None, None, False)`` when there
        is no checkpoint.  ``preempted``: the resume point is newer than
        every best-k save, so the epoch at ``step`` is incomplete (a save at
        an epoch's end names the next epoch)."""
        step = self.latest_step()
        p_steps = _steps(self.preempt_dir)
        p_step = p_steps[-1] if p_steps else None
        if p_step is not None and (step is None or p_step > step):
            path = os.path.join(self.preempt_dir, f"{p_step}.pt")
            return p_step, self._load(path, device)[0], True
        if step is None:
            return None, None, False
        return step, self.restore(step, device), False

    def restore_best(self, device="cpu"
                     ) -> tuple[Optional[int], Optional[TrainState]]:
        """The best-k checkpoint with the best monitored value, else the
        latest resume point."""
        step = self.best_step()
        if step is None:
            step, state, _ = self.restore_latest(device)
            return step, state
        return step, self.restore(step, device)
