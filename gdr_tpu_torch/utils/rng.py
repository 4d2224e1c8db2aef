"""Seeds (the counterpart of ``gdr_tpu/utils/rng.py``).  The reference
folds indices into JAX keys; the port mixes them into an integer seed with
numpy's SeedSequence and seeds an explicit ``torch.Generator`` with it."""

from __future__ import annotations

import random

import numpy as np
import torch


def fold_in(seed: int, index: int) -> int:
    """A 64-bit seed from ``seed`` and ``index`` (another index, another
    stream)."""
    return int(np.random.SeedSequence([seed, index])
               .generate_state(1, np.uint64)[0])


def generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by :func:`fold_in`."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, index))


def set_seed(seed: int) -> None:
    """Seed python's and numpy's global generators (the port's own draws
    take explicit generators)."""
    random.seed(seed)
    np.random.seed(seed)
