"""Weight bridge between the reference package's flax parameter tree and
the port's ``state_dict``, both ways.

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

:func:`params_to_flax` is the inverse (a round trip is bit-equal), and
:func:`save_params_npz` writes a port model's weights as the ``params.npz``
that :func:`load_params_npz` and the reference package read.

:func:`doc_encoder_params_from_flax` does the same for the document tower
(``gdr_tpu/models/dual_encoder.py::DocEncoder`` → ``models/dual_encoder.py``),
whose layout differs: attention projections are flax ``DenseGeneral``
kernels ``[d, H, dh]`` (bias ``[H, dh]``) and ``[H, dh, d]`` for the output,
every Dense has a bias, and LayerNorm has ``scale`` and ``bias``.
"""

from __future__ import annotations

import os
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
        elif leaf == "bias" and parts[0] in ("pawa", "fusion", "fc") \
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


_EMBEDDINGS = ("shared", "decode_embed", "embed")
_AS_IS = ("rel_embedding", "memory", "u", "u2", "lm_head")


def _flax_parts(module_path: str) -> list[str]:
    """``decoder.blocks.0.ln1`` → ``["decoder", "block_0", "ln1"]``."""
    parts, out = module_path.split("."), []
    for p in parts:
        if p.isdigit() and out and out[-1] in ("blocks", "layers"):
            out[-1] = out[-1][:-1] + "_" + p
        else:
            out.append(p)
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict → the flax tree ``{"params": {...}}`` of numpy
    arrays in the reference's names and layouts (the inverse of
    :func:`params_from_flax`)."""
    tree: dict = {}

    def put(parts: list[str], arr: np.ndarray) -> None:
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        mod, _, leaf = name.rpartition(".")
        parts = _flax_parts(mod) if mod else []
        if leaf in _AS_IS:
            put(parts + [leaf], arr)
        elif leaf == "weight" and mod.endswith("qkv"):
            inner = arr.shape[0] // 3
            for i, proj in enumerate("qkv"):
                put(parts[:-1] + [proj, "kernel"],
                    arr[i * inner:(i + 1) * inner].T.copy())
        elif leaf == "weight" and parts and parts[-1] in _EMBEDDINGS:
            put(parts + ["embedding"], arr)
        elif leaf == "weight" and arr.ndim == 1:      # PAWA LayerNorm
            put(parts + ["scale"], arr)
        elif leaf == "weight":
            put(parts + ["kernel"], arr.T.copy())
        elif leaf in ("scale", "bias"):
            put(parts + [leaf], arr)
        else:
            raise ValueError(f"port parameter {name!r} has no flax "
                             f"counterpart")
    return {"params": tree}


_DOC_EMBEDDINGS = ("tok_embed", "pos_embed", "type_embed")
_DOC_HEADS = ("query", "key", "value")


def flax_layout(name: str, shape, heads: int = 0
                ) -> tuple[tuple[int, ...], int, int]:
    """Where the flax leaf of port parameter ``name`` (of ``shape``) keeps
    its last axis in the port's tensor: (the flax leaf's shape, the port
    dim that holds that axis, the contiguous blocks that dim is made of).
    A cut of the flax last axis into parts cuts each block of the port dim
    alike.  The retriever's and the doc tower's names (``heads``: the doc
    tower's, which its attention kernels ``[d, H, dh]`` need):

    - a Dense kernel ``[in, out]`` is the Linear weight ``[out, in]``: dim 0;
    - the fused ``qkv`` ``[3·inner, d]`` holds the three kernels ``[d,
      inner]``: dim 0 in 3 blocks, so a part holds q, k and v of the same
      heads;
    - the doc tower's query / key / value ``[H·dh, d]`` (kernel ``[d, H,
      dh]``, bias ``[H, dh]``): dim 0 in H blocks; its ``out`` ``[d, H·dh]``
      (kernel ``[H, dh, d]``): dim 0;
    - embeddings ``[vocab, d]`` and the leaves kept as they are (``u``,
      ``u2``, ``memory``, ``lm_head``, ``rel_embedding``) and 1-D leaves:
      their last dim."""
    shape = tuple(shape)
    mod, _, leaf = name.rpartition(".")
    owner = mod.rpartition(".")[2]
    last = len(shape) - 1
    if owner in _DOC_HEADS and not heads:
        raise ValueError(f"{name}: the doc tower's attention needs its heads")
    if leaf in _AS_IS or len(shape) < 2 and owner not in _DOC_HEADS:
        return shape, last, 1
    if leaf == "weight" and owner in _EMBEDDINGS + _DOC_EMBEDDINGS:
        return shape, last, 1
    if leaf == "weight" and owner == "qkv":
        return (shape[1], shape[0] // 3), 0, 3
    if owner in _DOC_HEADS:
        dh = shape[0] // heads
        return (((shape[1],) if leaf == "weight" else ()) + (heads, dh),
                0, heads)
    if leaf == "weight" and owner == "out" and heads:
        return (heads, shape[1] // heads, shape[0]), 0, 1
    if leaf == "weight" and len(shape) == 2:
        return (shape[1], shape[0]), 0, 1
    raise ValueError(f"port parameter {name!r} has no flax layout")


def save_tree_npz(path: str, tree: Mapping) -> int:
    """Write a nested tree of arrays as an ``.npz``, each leaf under its
    ``/``-joined path, to a temporary file renamed into place.  Returns the
    leaf count."""
    flat = _flatten(tree)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return len(flat)


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor]
                    ) -> int:
    """Write a retriever's state_dict as ``params.npz``: each leaf under
    its ``/``-joined flax path (``params/shared/embedding``, …).  Returns
    the leaf count."""
    return save_tree_npz(path, params_to_flax(state_dict))


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


def load_tree_npz(path: str) -> dict:
    """The nested parameter tree of an ``.npz`` whose keys are ``/``-joined
    flax paths (as :func:`save_tree_npz` and
    ``tools/export_gdr_tpu_params.py`` write it)."""
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
    return params_from_flax(load_tree_npz(path))


def load_doc_encoder_npz(path: str) -> dict[str, torch.Tensor]:
    """The doc tower's state_dict from an exported ``.npz``."""
    return doc_encoder_params_from_flax(load_tree_npz(path))


# ------------------------------------------------ the secondary modes' trees
#
# The reference's modes keep flax trees of their own (gdr_tpu/train/
# modes.py): the ensemble {"enc": {shared, encoder}, "dec": decoder sides
# stacked on a leading member axis}; the hierarchic mode {"base": {"params":
# everything but the decoder}, "dec": decoder stacks on a leading depth
# axis}; the classifier and Seq2SeqLM a plain {"params": ...}.  The port
# writes the same trees, as ``.npz`` of ``/``-joined paths
# (``ensemble.npz``, ``hierarchic.npz``, ``softmax.npz``), and these turn
# them into its modules' state_dicts and back.

def _index_tree(tree: Mapping, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, Mapping)
            else np.asarray(v)[i] for k, v in tree.items()}


def _stack_trees(trees: list) -> dict:
    first = trees[0]
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(first[k], Mapping)
            else np.stack([np.asarray(t[k]) for t in trees])
            for k in first}


def _leading(tree: Mapping) -> int:
    return int(next(iter(_flatten(tree).values())).shape[0])


def ensemble_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """``{"enc", "dec"}`` → the state_dict of ``models/ensemble.py::
    Ensemble`` (every member's keys, its encoder side the shared one)."""
    sd = {}
    for i in range(_leading(tree["dec"])):
        member = params_from_flax({**tree["enc"],
                                   **_index_tree(tree["dec"], i)})
        sd.update({f"members.{i}.{k}": v for k, v in member.items()})
    return sd


def ensemble_to_flax(ens: torch.nn.Module) -> dict:
    """The inverse of :func:`ensemble_from_flax`."""
    sides = []
    for m in ens.members:
        sides.append(params_to_flax(m.state_dict())["params"])
    enc = {k: v for k, v in sides[0].items() if k in ("shared", "encoder")}
    dec = [{k: v for k, v in t.items() if k not in ("shared", "encoder")}
           for t in sides]
    return {"enc": enc, "dec": _stack_trees(dec)}


def hierarchic_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """``{"base", "dec"}`` → the state_dict of ``models/hierarchic.py::
    Hierarchic``."""
    sd = {f"base.{k}": v for k, v in params_from_flax(tree["base"]).items()}
    for i in range(_leading(tree["dec"])):
        dec = params_from_flax({"decoder": _index_tree(tree["dec"], i)})
        sd.update({f"decoders.{i}.{k.split('.', 1)[1]}": v
                   for k, v in dec.items()})
    return sd


def hierarchic_to_flax(h: torch.nn.Module) -> dict:
    """The inverse of :func:`hierarchic_from_flax`."""
    decs = [params_to_flax({f"decoder.{k}": v for k, v in
                            d.state_dict().items()})["params"]["decoder"]
            for d in h.decoders]
    return {"base": params_to_flax(h.base.state_dict()),
            "dec": _stack_trees(decs)}

