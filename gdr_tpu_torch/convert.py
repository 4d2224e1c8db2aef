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

:func:`doc_encoder_params_from_flax` does the same for the document tower
(``gdr_tpu/models/dual_encoder.py::DocEncoder`` → ``models/dual_encoder.py``),
whose layout differs: attention projections are flax ``DenseGeneral``
kernels ``[d, H, dh]`` (bias ``[H, dh]``) and ``[H, dh, d]`` for the output,
every Dense has a bias, and LayerNorm has ``scale`` and ``bias``.
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


def _flat_params(tree: Mapping) -> dict[str, np.ndarray]:
    """``/``-joined leaf paths, without a top ``params`` level."""
    flat = _flatten(tree)
    if all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
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
    flat = _flat_params(tree)
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


def doc_encoder_params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``DocEncoder`` parameter tree → the port's ``DocEncoder``
    state_dict."""
    flat = _flat_params(tree)
    sd: dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        mod, leaf = _module_path(parts[:-1]), parts[-1]
        owner = parts[-2] if len(parts) >= 2 else ""
        if leaf == "embedding" and len(parts) == 2:
            sd[mod + ".weight"] = arr
        elif leaf == "kernel" and owner in ("query", "key", "value") \
                and arr.ndim == 3:                       # [d, H, dh]
            sd[mod + ".weight"] = arr.reshape(arr.shape[0], -1).T
        elif leaf == "kernel" and owner == "out" and arr.ndim == 3:
            sd[mod + ".weight"] = arr.reshape(-1, arr.shape[-1]).T
        elif leaf == "kernel" and arr.ndim == 2:
            sd[mod + ".weight"] = arr.T
        elif leaf == "bias" and len(parts) >= 2:         # [H, dh] or [out]
            sd[mod + ".bias"] = arr.reshape(-1)
        elif leaf == "scale" and len(parts) >= 2:
            sd[mod + ".weight"] = arr
        else:
            raise ValueError(f"flax leaf {path!r} has no doc-tower "
                             f"counterpart")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _npz_tree(path: str) -> dict:
    """The nested parameter tree of an ``.npz`` whose keys are ``/``-joined
    flax paths (as ``tools/export_gdr_tpu_params.py`` writes it)."""
    with np.load(path, allow_pickle=False) as z:
        tree: dict = {}
        for key in z.files:
            node = tree
            *dirs, leaf = key.split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = z[key]
    return tree


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """The retriever's state_dict from an exported ``params.npz``."""
    return params_from_flax(_npz_tree(path))


def load_doc_encoder_npz(path: str) -> dict[str, torch.Tensor]:
    """The doc tower's state_dict from an exported ``.npz``."""
    return doc_encoder_params_from_flax(_npz_tree(path))
