"""Weight bridge from the reference package's flax parameter tree to the
port's ``state_dict``.

The tree is nested dicts of numpy arrays under the names ``init_params`` and
``CheckpointManager.restore_raw()["params"]["generator"]`` give
(``params/shared/embedding``, ``params/decoder/block_0/self_attn/q/kernel``,
…).  Two layout details:

- flax Dense kernels are ``[in, out]``; torch Linear weights are ``[out, in]``;
- attention q/k/v kernels become one fused ``qkv`` weight ``[3·inner, d]``
  (rows q | k | v), which ``models/t5.py::Attention`` slices.

U keeps its ``[d, V, d]`` layout and the slow PAWA head's U2 its
``[d, d·d]``.  Every flax leaf must map to a port
parameter (else :func:`params_from_flax` raises), and the model's strict
``load_state_dict`` raises on a missing, extra or mis-shaped parameter.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def _module_path(parts: list[str]) -> str:
    out = []
    for p in parts:
        m = re.fullmatch(r"(block|layer)_(\d+)", p)
        out.append(f"{m.group(1)}s.{m.group(2)}" if m else p)
    return ".".join(out)


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays, with or without the top
    ``params`` level) → the port's state_dict."""
    flat = _flatten(tree)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    sd: dict[str, torch.Tensor] = {}
    qkv: dict[str, dict[int, np.ndarray]] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel" and len(parts) >= 2:
            if parts[-2] in ("q", "k", "v"):
                key = _module_path(parts[:-2]) + ".qkv.weight"
                qkv.setdefault(key, {})["qkv".index(parts[-2])] = arr.T
                continue
            sd[_module_path(parts[:-1]) + ".weight"] = arr.T
        elif leaf == "embedding" and len(parts) >= 2:
            sd[_module_path(parts[:-1]) + ".weight"] = arr
        elif leaf == "scale" and len(parts) >= 2:
            # PAWA's LayerNorms are torch-style (weight, bias); T5's RMSNorm
            # keeps the flax name
            name = "weight" if parts[0] == "pawa" else "scale"
            sd[_module_path(parts[:-1]) + "." + name] = arr
        elif leaf == "bias" and parts[0] in ("pawa", "fusion") \
                and len(parts) >= 2:
            sd[_module_path(parts[:-1]) + ".bias"] = arr
        elif leaf == "rel_embedding" or path in ("pawa/memory", "pawa/u",
                                                  "pawa/u2", "lm_head"):
            sd[_module_path(parts)] = arr
        else:
            raise ValueError(f"flax leaf {path!r} has no port counterpart")
    for key, p in qkv.items():
        if sorted(p) != [0, 1, 2]:
            raise ValueError(f"{key}: needs q, k and v kernels, got "
                             f"{['qkv'[i] for i in sorted(p)]}")
        sd[key] = np.concatenate([p[0], p[1], p[2]], axis=0)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """The state_dict of an ``.npz`` whose keys are ``/``-joined flax paths
    (as ``tools/export_gdr_tpu_params.py`` writes it)."""
    with np.load(path, allow_pickle=False) as z:
        tree: dict = {}
        for key in z.files:
            node = tree
            *dirs, leaf = key.split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = z[key]
    return params_from_flax(tree)
