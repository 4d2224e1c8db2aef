"""Export a gdr_tpu generator's weights to the ``params.npz`` that the
PyTorch port reads (``gdr_tpu_torch/convert.py::load_params_npz``), or with
``--doc-encoder`` its document tower's to the ``.npz`` that the port's
``index`` / ``expand --encoder-ckpt`` read (``load_doc_encoder_npz``).

    python tools/export_gdr_tpu_params.py --workdir runs/nq --index index.npz \\
        [--model-size base --kary 30 ...] [--out runs/nq/params.npz]
    python tools/export_gdr_tpu_params.py --doc-encoder tiny --out enc.npz \\
        [--encoder-ckpt enc.msgpack] [--doc-tokenizer tok.json] [--seed 7]
    python tools/export_gdr_tpu_params.py --mode ensemble \\
        --msgpack runs/ens/ensemble.msgpack [--out runs/ens/ensemble.npz]

``--mode ensemble|hierarchic|softmax|seq2seq`` exports a tree that
gdr_tpu's secondary modes wrote (``ensemble.msgpack``,
``hierarchic.msgpack``, ``softmax.msgpack``; a ``Seq2SeqLM``'s
``{"params": ...}`` serialised the same way) to the ``.npz`` the port's
modes read (``ensemble.npz``, ``hierarchic.npz``, ``softmax.npz``; by
default beside the msgpack).  Every leaf passes through the port's bridge
(``gdr_tpu_torch/convert.py``), which refuses a leaf it cannot place.  The
ensemble's ``ensemble_paths.npy`` is read by both packages as it is.

The weights are ``CheckpointManager(<workdir>/ckpt).restore_raw()
["params"]["generator"]`` when the workdir holds a checkpoint, else
``init_params`` for the configuration and ``--seed`` — the same fallback the
reference ``retrieve`` CLI takes, so both CLIs then serve identical weights.
The model flags are those of ``python -m gdr_tpu.cli retrieve``; ``--index``
sets the dense-stage width from the store, as that CLI does.

The doc tower (``DocEncoder``, ``full`` or ``tiny``) is built as
``python -m gdr_tpu.cli index`` builds it: its token table sized to
``--doc-tokenizer``, its weights the flax msgpack ``--encoder-ckpt`` when
given, else its init at ``--seed`` (default 7, that CLI's).  Both CLIs then
embed with the same weights.

Each leaf is written under its ``/``-joined flax path
(``params/shared/embedding``, ``params/decoder/block_0/self_attn/q/kernel``,
…) in its own dtype.  This tool is the one program outside ``tests/`` that
imports both gdr_tpu and JAX; the port itself imports neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def export(params, out: str) -> int:
    """Write a flax parameter tree to ``out``; returns the leaf count."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if hasattr(v, "items"):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    np.savez(out, **flat)
    return len(flat)


def export_mode(mode: str, msgpack: str, out: str) -> int:
    """A secondary mode's flax msgpack → the port's ``.npz``; returns the
    leaf count.  The tree is read without a template and handed to the
    port's bridge for its mode before it is written."""
    from flax import serialization

    from gdr_tpu_torch import convert

    with open(msgpack, "rb") as fh:
        tree = serialization.msgpack_restore(fh.read())
    bridge = {"ensemble": convert.ensemble_from_flax,
              "hierarchic": convert.hierarchic_from_flax,
              "softmax": convert.params_from_flax,
              "seq2seq": convert.params_from_flax}[mode]
    bridge(tree)                    # raises on a leaf the port cannot place
    return convert.save_tree_npz(out, tree)


def export_doc_encoder(args) -> None:
    import jax

    from gdr_tpu.cli import _load_msgpack
    from gdr_tpu.data.tokenize import load_tokenizer
    from gdr_tpu.models.dual_encoder import DocEncoder, tiny_doc_encoder

    enc = tiny_doc_encoder() if args.doc_encoder == "tiny" else DocEncoder()
    tok = load_tokenizer(args.doc_tokenizer, vocab_size=enc.vocab_size)
    if tok.vocab_size != enc.vocab_size:
        enc = dataclasses.replace(enc, vocab_size=tok.vocab_size)
    seed = 7 if args.seed is None else args.seed
    ids = np.zeros((2, 8), np.int32)
    params = enc.init(jax.random.PRNGKey(seed), ids, np.ones_like(ids))
    if args.encoder_ckpt:
        params = _load_msgpack(args.encoder_ckpt, params)
        print(f"# doc tower from {args.encoder_ckpt}", file=sys.stderr)
    else:
        print(f"# no --encoder-ckpt: DocEncoder init (seed {seed})",
              file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n = export(params, args.out)
    print(f"# wrote {n} arrays to {args.out}", file=sys.stderr)


def main(argv=None) -> None:
    from gdr_tpu.cli import _add_common_model_flags, _model_config

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    _add_common_model_flags(p)
    p.add_argument("--workdir", default=None,
                   help="run dir (generator export; required without "
                        "--doc-encoder)")
    p.add_argument("--doc-encoder", default=None, choices=["full", "tiny"],
                   help="export this DocEncoder instead of the generator")
    p.add_argument("--mode", default=None,
                   choices=["ensemble", "hierarchic", "softmax", "seq2seq"],
                   help="export the tree of this secondary mode (or "
                        "query generation's Seq2SeqLM) from --msgpack")
    p.add_argument("--msgpack", default=None,
                   help="with --mode: the flax msgpack gdr_tpu wrote")
    p.add_argument("--encoder-ckpt", default=None,
                   help="with --doc-encoder: the tower's flax msgpack")
    p.add_argument("--doc-tokenizer", default=None,
                   help="with --doc-encoder: sizes the tower's vocab")
    p.add_argument("--index", default=None,
                   help="index .npz: its store width sets encoder_d_model")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--max-input-length", type=int, default=40)
    p.add_argument("--seed", type=int, default=None,
                   help="init seed without a checkpoint (default 42 for the "
                        "generator, 7 for --doc-encoder)")
    p.add_argument("--out", default=None,
                   help="default: <workdir>/params.npz (required with "
                        "--doc-encoder)")
    args = p.parse_args(argv)
    if args.mode:
        if not args.msgpack:
            p.error("--mode needs --msgpack")
        out = args.out or os.path.splitext(args.msgpack)[0] + ".npz"
        n = export_mode(args.mode, args.msgpack, out)
        print(f"# wrote {n} arrays to {out}", file=sys.stderr)
        return
    if args.doc_encoder:
        if not args.out:
            p.error("--doc-encoder needs --out")
        export_doc_encoder(args)
        return
    if not args.workdir:
        p.error("--workdir is required (or --doc-encoder with --out)")

    import jax

    from gdr_tpu.data.tokenize import load_tokenizer
    from gdr_tpu.models.gdr import GenerativeRetriever, init_params
    from gdr_tpu.train.checkpoint import CheckpointManager

    store_dim = None
    if args.index:
        with np.load(args.index, allow_pickle=False) as z:
            store_dim = z["store"].shape[1]
    mcfg = _model_config(args, store_dim=store_dim)
    tok = load_tokenizer(args.tokenizer, vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)

    params = None
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    if os.path.isdir(ckpt_dir):
        step, raw = CheckpointManager(ckpt_dir).restore_raw()
        if step is not None:
            params = raw["params"]["generator"]
            print(f"# checkpoint step {step}", file=sys.stderr)
    if params is None:
        model = GenerativeRetriever(mcfg)
        seed = 42 if args.seed is None else args.seed
        params = init_params(model, jax.random.PRNGKey(seed),
                             input_len=args.max_input_length)
        print(f"# no checkpoint: init_params (seed {seed})",
              file=sys.stderr)
    out = args.out or os.path.join(args.workdir, "params.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    n = export(params, out)
    print(f"# wrote {n} arrays to {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
