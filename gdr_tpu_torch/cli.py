"""Command-line interface of the PyTorch port: ``index`` (embed a corpus,
k-means it, pack the trie), ``expand`` (insert new documents without
retraining), ``tokenizer`` (train a subword tokenizer), ``retrieve``
(serving), ``eval`` (a dev set's metrics) and ``calculate`` (metrics of a
result TSV).

    python -m gdr_tpu_torch.cli index --corpus docs.tsv --out index.npz \\
        [--encoder-size tiny] [--encoder-ckpt enc.npz] [--device cuda]
    python -m gdr_tpu_torch.cli expand --index index.npz \\
        --corpus new_docs.tsv --out index_expanded.npz
    python -m gdr_tpu_torch.cli tokenizer --corpus docs.tsv --out tok.json
    python -m gdr_tpu_torch.cli retrieve --index index.npz --workdir run \\
        --packed --query "who wrote hamlet" [--int8-store] [--device cuda]
    python -m gdr_tpu_torch.cli eval --index index.npz --dev dev.tsv \\
        --workdir run --packed [--int8-store] --result-tsv res1.tsv
    python -m gdr_tpu_torch.cli calculate --result res1.tsv [--ref-compat]

Mirrors ``gdr_tpu/cli.py``.  ``index`` / ``expand``: a corpus TSV (title
\\t text, or text) → the doc tower's embeddings → hierarchical k-means → the
CID trie, saved as the ``.npz`` both packages read; ``expand`` assigns each
new document to the cluster whose node embedding is nearest and leaves the
trie's structure as it is.  ``retrieve``: free-text queries from
``--query`` (repeatable), ``--queries-file`` or stdin → beam decode → trie
expansion → dense re-rank → the top ``--top-k`` documents per query, as
TSV (query_idx, rank, doc_id, score, cid) or JSON lines.  ``eval``: a dev
TSV (query \\t docid[,docid...]) → the metric suite and phase times as
JSON, and with ``--result-tsv`` the reference-compatible result file that
``calculate`` scores.

Differences from the reference CLI:

- ``--device`` (default ``cuda``) picks where everything runs; on ``cuda``
  the decoder sublayers and the re-rank scorers run as the port's CUDA
  kernels, on ``cpu`` as their plain versions; the doc tower and the
  k-means run on the same device.  There is no ``--pallas`` or
  ``--fused-decode``: the device decides.  ``eval --mesh`` (other than
  ``none``) and ``--ensemble`` are later slices and are refused;
  ``retrieve`` has no ``--mesh``.  ``eval --gen-method sample|top_k``
  draws rollouts (``--temperature``, ``--sample-top-k``).  The
  decoder-side query reps and the slow PAWA head are reached through
  ``EvalConfig`` / ``ModelConfig``, as in the reference package.
- Weights come from ``<workdir>/params.npz``, written from a reference
  checkpoint (or its seeded init) by ``tools/export_gdr_tpu_params.py``.
  Without that file the model gets seeded random weights (``--seed``), as
  the reference CLI falls back to its init when no checkpoint exists.
- The doc tower's weights come from ``--encoder-ckpt``, an ``.npz`` that
  ``tools/export_gdr_tpu_params.py --doc-encoder`` writes from the
  reference's flax checkpoint or its seeded init; without it the tower gets
  seeded random weights (``--seed``).  ``index --bert-ckpt`` (a HuggingFace
  BERT checkpoint) is not ported yet and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-size", default="base",
                   choices=["base", "large", "small", "tiny"])
    p.add_argument("--kary", type=int, default=30)
    p.add_argument("--max-output-length", type=int, default=10)
    p.add_argument("--no-adaptor", action="store_true",
                   help="disable the PAWA adaptive lm-head")
    p.add_argument("--adaptor-layers", type=int, default=4)
    p.add_argument("--rdrop", type=float, default=0.1)


def _model_config(args, store_dim=None):
    from gdr_tpu_torch.config import ModelConfig
    cfg = ModelConfig(kary=args.kary,
                      max_output_length=args.max_output_length,
                      adaptor_decode=not args.no_adaptor,
                      adaptor_layer_num=args.adaptor_layers,
                      rdrop=args.rdrop).scaled(args.model_size)
    if store_dim is not None:
        cfg = dataclasses.replace(cfg, encoder_d_model=int(store_dim))
    return cfg


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available here (torch "
            f"{torch.__version__}); pass --device cpu to run the plain "
            f"PyTorch path on the CPU")
    return dev


def _check_query_length(device, max_input_length: int, mcfg) -> None:
    """On cuda, refuse queries longer than the cross-attention kernel
    serves to the CLI's f32 model."""
    if device.type != "cuda":
        return
    import torch

    from gdr_tpu_torch.kernels.decode import cross_attn_max_len
    limit = cross_attn_max_len(mcfg.d_kv, torch.float32)
    if max_input_length > limit:
        raise SystemExit(
            f"--max-input-length {max_input_length}: the CUDA "
            f"cross-attention kernel serves at most {limit} query tokens at "
            f"d_kv {mcfg.d_kv}; pass --device cpu for longer queries")


def _read_corpus_tsv(path: str) -> tuple[list[str], list[str]]:
    """TSV rows: title \\t text (or just text)."""
    import csv
    titles, texts = [], []
    with open(path, newline="") as fh:
        for row in csv.reader(fh, delimiter="\t"):
            if not row:
                continue
            if len(row) >= 2:
                titles.append(row[0])
                texts.append(row[1])
            else:
                titles.append(f"doc-{len(titles)}")
                texts.append(row[0])
    return titles, texts


def _read_query_tsv(path: str) -> tuple[list[str], list[list[int]]]:
    """TSV rows: query \\t docid[,docid...]."""
    import csv
    queries, positives = [], []
    with open(path, newline="") as fh:
        for row in csv.reader(fh, delimiter="\t"):
            if len(row) < 2:
                continue
            queries.append(row[0])
            positives.append([int(d) for d in row[1].split(",")])
    return queries, positives


def load_model(cfg, workdir: str, device, seed: int = 42):
    """The retriever with ``<workdir>/params.npz`` weights, or seeded
    random ones when the file is absent."""
    import torch

    from gdr_tpu_torch.convert import load_params_npz
    from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights

    model = GenerativeRetriever(cfg)
    path = os.path.join(workdir, "params.npz")
    if os.path.exists(path):
        model.load_state_dict(load_params_npz(path))
        print(f"# loaded {path}", file=sys.stderr)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
        print(f"# no {path}: seeded random weights (seed {seed})",
              file=sys.stderr)
    return model.to(device).eval()


def _doc_tower(args, device):
    """(doc tokenizer, doc tower on ``device``) of ``--encoder-size``: the
    tower's token table sized to the tokenizer (its ids must fit), weights
    from ``--encoder-ckpt`` or a seeded init."""
    import torch

    from gdr_tpu_torch.convert import load_doc_encoder_npz
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   DocEncoderConfig,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)

    cfg = (tiny_doc_encoder_config() if args.encoder_size == "tiny"
           else DocEncoderConfig())
    tok = load_tokenizer(args.doc_tokenizer, vocab_size=cfg.vocab_size)
    if tok.vocab_size != cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    enc = DocEncoder(cfg)
    if args.encoder_ckpt:
        enc.load_state_dict(load_doc_encoder_npz(args.encoder_ckpt))
        print(f"# doc tower from {args.encoder_ckpt}", file=sys.stderr)
    else:
        init_doc_encoder(enc, torch.Generator().manual_seed(args.seed))
        print(f"# no --encoder-ckpt: seeded random doc tower (seed "
              f"{args.seed})", file=sys.stderr)
    return tok, enc.to(device).eval()


def cmd_index(args) -> None:
    if args.bert_ckpt:
        raise SystemExit("--bert-ckpt: the HuggingFace BERT loaders are not "
                         "ported yet (ROADMAP.md queue 1, item 9)")
    from gdr_tpu_torch.config import IndexConfig
    from gdr_tpu_torch.index.builder import build_index
    from gdr_tpu_torch.index.io import save_index

    device = _device(args.device)
    _, texts = _read_corpus_tsv(args.corpus)
    tok, enc = _doc_tower(args, device)
    ids, mask = tok.encode_batch(texts, args.encoder_max_len)
    cfg = IndexConfig(kary=args.kary, leaf_cap=args.leaf_cap, seed=args.seed,
                      embedding_dim=enc.cfg.d_model)
    index = build_index(enc, ids, mask, cfg, batch_size=args.batch_size)
    save_index(args.out, index)
    print(f"index: {len(index.paths)} docs, {index.trie.num_clusters} "
          f"clusters, {index.trie.num_nodes} nodes → {args.out}")


def cmd_expand(args) -> None:
    from gdr_tpu_torch.index.expand import expand_with_encoder
    from gdr_tpu_torch.index.io import load_index, save_index

    device = _device(args.device)
    index = load_index(args.index)
    _, texts = _read_corpus_tsv(args.corpus)
    tok, enc = _doc_tower(args, device)
    ids, mask = tok.encode_batch(texts, args.encoder_max_len)
    bigger = expand_with_encoder(index, enc, ids, mask)
    save_index(args.out, bigger)
    print(f"expanded: {len(index.paths)} → {len(bigger.paths)} docs "
          f"→ {args.out}")


def cmd_tokenizer(args) -> None:
    """Train a subword tokenizer over every text column of a corpus."""
    from gdr_tpu_torch.data.subword import train_unigram, train_wordpiece

    titles, texts = _read_corpus_tsv(args.corpus)
    train = train_unigram if args.type == "unigram" else train_wordpiece
    tok = train(titles + texts, vocab_size=args.vocab_size, path=args.out)
    ids, _ = tok.encode_batch(texts[:2], 16)
    print(f"tokenizer: {args.type} vocab={tok.vocab_size} → {args.out} "
          f"(smoke: {ids[0][:8].tolist()})")


def cmd_retrieve(args) -> None:
    import numpy as np

    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.index.io import load_index

    device = _device(args.device)
    queries = list(args.query or [])
    if args.queries_file:
        with open(args.queries_file) as fh:
            queries += [ln.strip() for ln in fh if ln.strip()]
    if not queries:
        queries = [ln.strip() for ln in sys.stdin if ln.strip()]
    if not queries:
        raise SystemExit("no queries (use --query / --queries-file / stdin)")

    index = load_index(args.index)
    mcfg = _model_config(args, store_dim=index.store.shape[1])
    _check_query_length(device, args.max_input_length, mcfg)
    tok = load_tokenizer(args.tokenizer, vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)
    model = load_model(mcfg, args.workdir, device, args.seed)

    ev_cfg = EvalConfig(num_beams=args.beam,
                        num_return_sequences=args.top_k,
                        max_output_length=mcfg.max_output_length,
                        score_rates=(args.alpha,))
    evaluator = Evaluator(model, index.trie, index.store, ev_cfg,
                          packed=args.packed, quantize=args.int8_store)

    bs = min(args.batch_size, len(queries))
    if not args.json:
        print("query_idx\trank\tdoc_id\tscore\tcid")
    for s in range(0, len(queries), bs):
        chunk = queries[s:s + bs]
        padded = chunk + [chunk[0]] * (bs - len(chunk))
        ids, msk = tok.encode_batch(padded, args.max_input_length)
        _, rr = evaluator.retrieve(ids, msk)
        doc_ids = rr.doc_ids[0].cpu().numpy()       # single fusion weight
        scores = rr.scores[0].cpu().numpy()
        valid = rr.doc_valid[0].cpu().numpy()
        for b, q in enumerate(chunk):
            hits = [(int(doc_ids[b, r]), float(scores[b, r]))
                    for r in np.flatnonzero(valid[b])[:args.top_k]]
            if args.json:
                print(json.dumps({
                    "query": q,
                    "results": [{"doc_id": d, "score": round(sc, 6),
                                 "cid": index.cid_of_doc[d]}
                                for d, sc in hits]}))
            else:
                for r, (d, sc) in enumerate(hits):
                    print(f"{s + b}\t{r + 1}\t{d}\t{sc:.6f}"
                          f"\t{index.cid_of_doc[d]}")


def cmd_eval(args) -> None:
    if args.ensemble > 1:
        raise SystemExit("--ensemble: the N-decoder ensemble is not ported "
                         "yet (ROADMAP.md queue 1, item 8)")
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: the sharded store is not "
                         f"ported yet (ROADMAP.md queue 1, item 10)")

    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.data.dataset import build_eval_data
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.index.io import load_index

    device = _device(args.device)
    index = load_index(args.index)
    mcfg = _model_config(args, store_dim=index.store.shape[1])
    _check_query_length(device, args.max_input_length, mcfg)
    tok = load_tokenizer(args.tokenizer, vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)
    model = load_model(mcfg, args.workdir, device, args.seed)

    dev_q, dev_pos = _read_query_tsv(args.dev)
    dev = build_eval_data(dev_q, dev_pos, index.cid_of_doc, tok,
                          args.max_input_length)
    ev_cfg = EvalConfig(num_beams=args.beam, num_return_sequences=args.beam,
                        max_output_length=mcfg.max_output_length,
                        gen_method=args.gen_method,
                        temperature=args.temperature,
                        sample_top_k=args.sample_top_k)
    evaluator = Evaluator(model, index.trie, index.store, ev_cfg,
                          packed=args.packed, quantize=args.int8_store)
    out = evaluator.evaluate(dev, batch_size=args.eval_batch_size,
                             result_tsv=args.result_tsv)
    if args.result_tsv:
        print(f"wrote result TSV → {args.result_tsv}")
    print(json.dumps(out, indent=2, sort_keys=True))


def cmd_calculate(args) -> None:
    from gdr_tpu_torch.eval.offline import calculate
    print(json.dumps(calculate(args.result, ref_compat=args.ref_compat),
                     indent=2, sort_keys=True))


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels) or cpu (plain "
                        "PyTorch)")


def _add_doc_tower_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--encoder-max-len", type=int, default=128)
    p.add_argument("--doc-tokenizer", default=None)
    p.add_argument("--encoder-size", default="full", choices=["full", "tiny"])
    p.add_argument("--encoder-ckpt", default=None,
                   help="doc tower .npz from tools/export_gdr_tpu_params.py "
                        "--doc-encoder")
    p.add_argument("--seed", type=int, default=7,
                   help="k-means seed, and the seed of the random tower "
                        "used without --encoder-ckpt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gdr_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="embed corpus + k-means + trie")
    pi.add_argument("--corpus", required=True,
                    help="corpus TSV: title \\t text (or text)")
    pi.add_argument("--out", required=True)
    pi.add_argument("--kary", type=int, default=30)
    pi.add_argument("--leaf-cap", type=int, default=30)
    _add_doc_tower_flags(pi)
    pi.add_argument("--batch-size", type=int, default=256)
    pi.add_argument("--bert-ckpt", default=None,
                    help="HuggingFace BERT checkpoint (not ported yet; "
                         "refused)")
    _add_device_flag(pi)
    pi.set_defaults(fn=cmd_index)

    px = sub.add_parser("expand", help="insert new docs, no retraining")
    px.add_argument("--index", required=True)
    px.add_argument("--corpus", required=True,
                    help="TSV of the new docs, embedded with the tower the "
                         "index was built with")
    px.add_argument("--out", required=True)
    _add_doc_tower_flags(px)
    _add_device_flag(px)
    px.set_defaults(fn=cmd_expand)

    pk = sub.add_parser("tokenizer",
                        help="train a subword tokenizer over a corpus")
    pk.add_argument("--corpus", required=True)
    pk.add_argument("--out", required=True, help=".json output path")
    pk.add_argument("--type", default="unigram",
                    choices=["unigram", "wordpiece"],
                    help="unigram = T5/sentencepiece-style (queries); "
                         "wordpiece = BERT-style (documents)")
    pk.add_argument("--vocab-size", type=int, default=32000)
    pk.set_defaults(fn=cmd_tokenizer)
    pr = sub.add_parser("retrieve",
                        help="ad-hoc retrieval (serving): free-text "
                             "queries → ranked documents")
    _add_common_model_flags(pr)
    pr.add_argument("--index", required=True)
    pr.add_argument("--workdir", required=True,
                    help="run dir holding params.npz")
    pr.add_argument("--tokenizer", default=None)
    pr.add_argument("--query", action="append",
                    help="query text (repeatable)")
    pr.add_argument("--queries-file", default=None,
                    help="file with one query per line (else stdin)")
    pr.add_argument("--max-input-length", type=int, default=40,
                    help="query tokens; on cuda at most 431 at d_kv 64 "
                         "(the cross-attention kernel holds a query's "
                         "K/V in shared memory)")
    pr.add_argument("--beam", type=int, default=100)
    pr.add_argument("--top-k", type=int, default=10)
    pr.add_argument("--alpha", type=float, default=1.0,
                    help="beam-probability fusion weight "
                         "(score = tanh(q·d) + α·p_beam)")
    pr.add_argument("--batch-size", type=int, default=4,
                    help="queries per retrieve call")
    pr.add_argument("--json", action="store_true",
                    help="one JSON object per query instead of TSV")
    pr.add_argument("--packed", action="store_true",
                    help="cluster-packed store (one contiguous block per "
                         "beam, scored by the packed re-rank kernel)")
    pr.add_argument("--int8-store", action="store_true",
                    help="int8 doc-embedding store (4x smaller; with "
                         "--packed scored by the int8 packed kernel)")
    _add_device_flag(pr)
    pr.add_argument("--seed", type=int, default=42,
                    help="seed of the random weights used when the workdir "
                         "has no params.npz")
    pr.set_defaults(fn=cmd_retrieve)

    pe = sub.add_parser("eval", help="standalone evaluation of a dev set")
    _add_common_model_flags(pe)
    pe.add_argument("--index", required=True)
    pe.add_argument("--dev", required=True,
                    help="dev TSV: query \\t docid[,docid...]")
    pe.add_argument("--workdir", required=True,
                    help="run dir holding params.npz")
    pe.add_argument("--tokenizer", default=None)
    pe.add_argument("--max-input-length", type=int, default=40)
    pe.add_argument("--beam", type=int, default=100)
    pe.add_argument("--eval-batch-size", type=int, default=8)
    pe.add_argument("--gen-method", default="beam",
                    choices=["beam", "greedy", "sample", "top_k"],
                    help="decode mode; greedy is beam search, as in the "
                         "reference; sample and top_k draw rollouts")
    pe.add_argument("--temperature", type=float, default=1.0)
    pe.add_argument("--sample-top-k", type=int, default=0)
    pe.add_argument("--packed", action="store_true",
                    help="cluster-packed store (one contiguous block per "
                         "beam, scored by the packed re-rank kernel)")
    pe.add_argument("--int8-store", action="store_true",
                    help="int8 doc-embedding store (4x smaller; with "
                         "--packed scored by the int8 packed kernel)")
    pe.add_argument("--result-tsv", default=None,
                    help="also write the reference-compatible result TSV "
                         "(query, preds, gts, rank) that `calculate` reads")
    pe.add_argument("--mesh", default="none",
                    help="only 'none' (the sharded store is not ported yet)")
    pe.add_argument("--ensemble", type=int, default=1,
                    help="only 1 (the ensemble is not ported yet)")
    _add_device_flag(pe)
    pe.add_argument("--seed", type=int, default=42,
                    help="seed of the random weights used when the workdir "
                         "has no params.npz")
    pe.set_defaults(fn=cmd_eval)

    pc = sub.add_parser("calculate", help="offline metrics from result TSV")
    pc.add_argument("--result", required=True)
    pc.add_argument("--ref-compat", action="store_true",
                    help="score with the reference's exact semantics "
                         "(hits@k over row-accumulated gt, per-row MRR100); "
                         "default is per-query fraction-recall")
    pc.set_defaults(fn=cmd_calculate)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
