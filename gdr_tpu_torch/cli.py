"""Command-line interface of the PyTorch port: ``ingest`` (raw NQ jsonl or
a pickled corpus → the TSVs the others read), ``index`` (embed a corpus,
k-means it, pack the trie), ``expand`` (insert new documents without
retraining), ``tokenizer`` (train a subword tokenizer), ``qg`` (generate
pseudo-queries per document), ``train`` (the two-stage GDR training, or a
secondary mode), ``retrieve`` (serving), ``eval`` (a dev set's metrics) and
``calculate`` (metrics of a result TSV).

    python -m gdr_tpu_torch.cli ingest --nq-jsonl train.jsonl.gz \\
        [--dev-jsonl dev.jsonl.gz] --out-dir data
    python -m gdr_tpu_torch.cli index --corpus docs.tsv --out index.npz \\
        [--encoder-size tiny] [--bert-ckpt bert_dir] [--encoder-ckpt enc.npz]
    python -m gdr_tpu_torch.cli expand --index index.npz \\
        --corpus new_docs.tsv --out index_expanded.npz
    python -m gdr_tpu_torch.cli tokenizer --corpus docs.tsv --out tok.json
    python -m gdr_tpu_torch.cli train --index index.npz --train train.tsv \\
        --dev dev.tsv --workdir run [--corpus docs.tsv] \\
        [--t5-ckpt t5_dir] [--bert-ckpt bert_dir] [--device cuda]
    python -m gdr_tpu_torch.cli retrieve --index index.npz --workdir run \\
        --packed --query "who wrote hamlet" [--int8-store] [--device cuda]
    python -m gdr_tpu_torch.cli eval --index index.npz --dev dev.tsv \\
        --workdir run --packed [--int8-store] --result-tsv res1.tsv
    python -m gdr_tpu_torch.cli calculate --result res1.tsv [--ref-compat]
    python -m gdr_tpu_torch.cli qg --corpus docs.tsv --out qg.npz \\
        [--train train.tsv] [--n-per-doc 5] [--max-query-length 40]
    python -m gdr_tpu_torch.cli train ... --qg qg.npz [--query-type gtq_qg]
    python -m gdr_tpu_torch.cli train ... --ensemble 3   # | --hierarchic
    python -m gdr_tpu_torch.cli eval ... --ensemble 3
    torchrun --nproc-per-node 4 -m gdr_tpu_torch.cli retrieve ... --mesh 4
    torchrun --nproc-per-node 2 -m gdr_tpu_torch.cli eval ... --packed \\
        --mesh 2 --device cpu

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
  ``--fused-decode``: the device decides.  ``eval --gen-method sample|top_k``
  draws rollouts (``--temperature``, ``--sample-top-k``).  The
  decoder-side query reps and the slow PAWA head are reached through
  ``EvalConfig`` / ``ModelConfig``, as in the reference package.
- ``train`` runs ``train/loop.py::TrainLoop`` with the reference's flags
  for the default mode (stage 2 from ``--train-encoder-epoch`` when
  ``--corpus`` is given; ``--hard-negatives bm25|random``; ``--query-type``
  mixing ``gtq``, ``qg`` (``--qg``), ``doc`` and ``aug``), bf16 compute
  over f32 masters unless ``--no-bf16``, and ends by writing the best
  checkpoint's weights to ``<workdir>/params.npz``.  ``--ensemble N``,
  ``--hierarchic`` and ``--softmax`` run ``train/modes.py`` instead (f32),
  print its metrics and write its state file (``ensemble.npz`` +
  ``ensemble_paths.npy``, ``hierarchic.npz``, ``softmax.npz``: the
  reference's trees as ``.npz``, not flax msgpack), which ``eval
  --ensemble N`` reads.  ``--dropout`` sets the modules' dropout rate.
- ``train --mesh`` (default ``auto``, as in the reference) trains over the
  ranks of a process group, one process per GPU: ``auto`` makes every
  rank data-parallel (no mesh in a world of one), ``DP,MP`` computes
  tensor-parallel over mp as well (``gdr_tpu``'s column-parallel
  placement: each mp rank holds and computes only its columns of every
  large leaf, forward and backward).  Where the
  reference's ``auto`` shrinks dp to a divisor of the batch, a torch world
  is fixed by its launcher, so a batch that does not divide over the world
  is refused.  Rank 0 alone prints, writes the metrics, the checkpoints
  and ``params.npz``.  The secondary modes take no mesh.

      torchrun --nproc-per-node 4 -m gdr_tpu_torch.cli train --mesh 2,2 ...
- ``retrieve`` and ``eval --mesh`` row-shard the doc store over the ranks
  of a process group, one process per GPU as ``torchrun`` starts them
  (``nccl`` on ``--device cuda``, one card per rank; ``gloo`` on ``--device
  cpu``); each rank decodes the whole batch, scores the candidates it
  owns and the ranks' winners merge in one ``all_gather``.  ``--mesh``:
  ``none``, ``auto`` (every rank, data-parallel; no mesh in a world of
  one) or ``DP,MP`` (their product the world).  The group comes from
  ``torchrun``'s environment, or from ``--coordinator`` (rank 0's
  ``host:port``), ``--num-processes`` and ``--process-id``.  Only rank 0
  prints results and writes the result TSV; the ranks read no stdin, so
  give ``retrieve`` ``--query`` or ``--queries-file``.  ``eval
  --ensemble`` takes no mesh.
- Pretrained starts read HuggingFace checkpoint directories (``config.json``
  and ``model.safetensors``, ``pytorch_model.bin`` or their shards) with
  ``models/convert.py``, never through ``transformers``.  ``train
  --t5-ckpt`` takes such a directory (its config replaces the preset's
  widths), an ``export_t5_encoder`` ``.npz`` (HF names) or a ``params.npz``,
  and warm-starts the encoder and shared embeddings; ``--bert-ckpt`` (a
  BERT / DPR / AR2 directory) gives ``index`` its doc tower and ``train``
  its stage-2 tower.  A checkpoint directory is also the tokenizer when no
  ``--tokenizer`` / ``--doc-tokenizer`` is given, read through
  ``transformers``; where that is missing or cannot load the directory,
  the hash tokenizer of the checkpoint's vocab stands in, as in the
  reference package, and a tokenizer whose vocab differs from the
  checkpoint's is refused.
- ``qg`` samples with the KV-cached decoder (on ``cuda`` the sublayer
  kernels, the self-attention cache ``--max-query-length`` positions) and
  writes token arrays, never strings; its Seq2SeqLM starts from seeded
  random weights (``--seed``), as the reference's does.
- Weights come from ``<workdir>/params.npz``, written by ``train`` or from
  a reference checkpoint (or its seeded init) by
  ``tools/export_gdr_tpu_params.py``.  Without that file the model gets
  seeded random weights (``--seed``), as the reference CLI falls back to
  its init when no checkpoint exists.
- The doc tower's weights come from ``--encoder-ckpt``, an ``.npz`` that
  ``tools/export_gdr_tpu_params.py --doc-encoder`` writes from the
  reference's flax checkpoint or its seeded init; without it the tower gets
  seeded random weights (``--seed``).  With ``--bert-ckpt`` the
  checkpoint's weights come first and ``--encoder-ckpt`` loads over them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-size", default="base",
                   choices=["base", "large", "small", "tiny", "switch-base",
                            "moonlight-16b-a3b", "kimi-linear-48b-a3b"])
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
    """The device of ``--device``; a bare ``cuda`` is the card this rank
    took (``parallel/distributed.py::initialize``)."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available here (torch "
            f"{torch.__version__}); pass --device cpu to run the plain "
            f"PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_from_flag(spec: str, device):
    """``--mesh``: ``none`` (one process), ``auto`` (every rank of the
    process group, data-parallel; none in a world of one) or ``DP,MP``,
    whose product must be the world."""
    if spec in (None, "none"):
        return None
    from gdr_tpu_torch.config import MeshConfig
    from gdr_tpu_torch.parallel.distributed import process_info
    from gdr_tpu_torch.parallel.mesh import make_mesh

    if spec == "auto":
        world = process_info()[1]
        return None if world == 1 else make_mesh(MeshConfig(dp=world),
                                                  device=device)
    parts = [int(x) for x in spec.split(",")]
    cfg = MeshConfig(dp=parts[0], mp=parts[1] if len(parts) > 1 else 1)
    try:
        return make_mesh(cfg, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e} (start one process per rank, "
                         f"e.g. torchrun --nproc-per-node {cfg.dp * cfg.mp})")


def _train_mesh(spec: str, device, batch_sizes: tuple[int, ...]):
    """``train --mesh``: as :func:`_mesh_from_flag`, but ``auto`` in a
    world of N > 1 processes must divide every stage's batch by N: the
    reference shrinks dp to the largest divisor of the batch over its
    devices, while a torch world is fixed by its launcher."""
    if spec == "auto":
        from gdr_tpu_torch.parallel.distributed import process_info
        world = process_info()[1]
        bad = [b for b in batch_sizes if b % world]
        if world > 1 and bad:
            raise SystemExit(
                f"--mesh auto: a batch of {bad[0]} does not divide over the "
                f"world of {world} processes (every rank data-parallel); "
                f"start a world that divides it, or pass --mesh DP,MP")
    return _mesh_from_flag(spec, device)


def _check_query_length(device, max_input_length: int, mcfg,
                        dtype=None) -> None:
    """On cuda, refuse queries longer than the cross-attention kernel
    serves to a model of ``dtype`` (default: the serving CLI's f32)."""
    if device.type != "cuda":
        return
    import torch

    from gdr_tpu_torch.kernels.decode import cross_attn_max_len
    limit = cross_attn_max_len(mcfg.d_kv, dtype or torch.float32)
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


def _doc_tower(args, device, bert_ckpt: str | None = None):
    """(doc tokenizer, doc tower on ``device``) of ``--encoder-size``, or of
    the architecture of ``bert_ckpt`` (a HF BERT / DPR checkpoint
    directory, also the tokenizer unless ``--doc-tokenizer``): the tower's
    token table sized to the tokenizer (its ids must fit; a checkpoint's
    must equal it), weights from the checkpoint, then ``--encoder-ckpt``
    over them, or a seeded init without either."""
    import torch

    from gdr_tpu_torch.convert import load_doc_encoder_npz
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.models.convert import (bert_model_overrides,
                                              bert_state_dict_from_pretrained,
                                              load_bert_encoder)
    from gdr_tpu_torch.models.dual_encoder import (DocEncoder,
                                                   DocEncoderConfig,
                                                   init_doc_encoder,
                                                   tiny_doc_encoder_config)

    cfg = (tiny_doc_encoder_config() if args.encoder_size == "tiny"
           else DocEncoderConfig())
    if bert_ckpt:
        cfg = dataclasses.replace(cfg, **bert_model_overrides(bert_ckpt))
    tok = load_tokenizer(args.doc_tokenizer or bert_ckpt,
                         vocab_size=cfg.vocab_size)
    if tok.vocab_size != cfg.vocab_size:
        if bert_ckpt:
            raise ValueError(f"--doc-tokenizer vocab ({tok.vocab_size}) must "
                             f"match the --bert-ckpt vocab ({cfg.vocab_size})")
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    enc = DocEncoder(cfg)
    if bert_ckpt:
        load_bert_encoder(enc, bert_state_dict_from_pretrained(bert_ckpt))
        print(f"# doc tower from {bert_ckpt}", file=sys.stderr)
    if args.encoder_ckpt:
        enc.load_state_dict(load_doc_encoder_npz(args.encoder_ckpt))
        print(f"# doc tower from {args.encoder_ckpt}", file=sys.stderr)
    elif not bert_ckpt:
        init_doc_encoder(enc, torch.Generator().manual_seed(args.seed))
        print(f"# no --encoder-ckpt: seeded random doc tower (seed "
              f"{args.seed})", file=sys.stderr)
    return tok, enc.to(device).eval()


def cmd_index(args) -> None:
    from gdr_tpu_torch.config import IndexConfig
    from gdr_tpu_torch.index.builder import build_index
    from gdr_tpu_torch.index.io import save_index

    device = _device(args.device)
    tok, enc = _doc_tower(args, device, bert_ckpt=args.bert_ckpt)
    _, texts = _read_corpus_tsv(args.corpus)
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


def cmd_train(args) -> None:
    # query-source mixing: gtq (the train TSV), qg (the `qg` subcommand's
    # .npz), doc and aug (from --corpus); gtq, plus qg when --qg is given
    query_type = args.query_type or ("gtq_qg" if args.qg else "gtq")
    wanted = query_type.split("_")
    if "qg" in wanted and not args.qg:
        raise SystemExit(f"--query-type {query_type} needs --qg (run the "
                         f"`qg` subcommand first)")
    import numpy as np
    import torch

    from gdr_tpu_torch.config import (DataConfig, EvalConfig, GDRConfig,
                                      TrainConfig)
    from gdr_tpu_torch.convert import save_params_npz
    from gdr_tpu_torch.data.dataset import (build_doc_query_sets,
                                            build_eval_data, build_train_set,
                                            mix_sources)
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.index.io import load_index
    from gdr_tpu_torch.models.convert import (bert_model_overrides,
                                              t5_model_overrides)
    from gdr_tpu_torch.train.loop import TrainLoop

    # the checkpoints' configs are read first: a missing one fails at once
    t5_widths = (t5_model_overrides(args.t5_ckpt)
                 if args.t5_ckpt and not args.t5_ckpt.endswith(".npz")
                 else None)
    stage2 = bool(args.corpus) and args.train_encoder_epoch < args.epochs
    bert_width = None
    if args.bert_ckpt:
        bert_width = bert_model_overrides(args.bert_ckpt)["d_model"]
        if not stage2:
            raise ValueError("--bert-ckpt warm-starts the stage-2 doc tower: "
                             "pass --corpus and --train-encoder-epoch < "
                             "--epochs")
    device = _device(args.device)
    # the secondary modes compute in f32, as the reference's
    modes = args.ensemble > 1 or args.hierarchic or args.softmax
    mesh = _train_mesh(args.mesh, device, (args.batch_size,
                                           args.stage2_batch_size
                                           or args.batch_size))
    if mesh is not None and modes:
        raise SystemExit("--ensemble / --hierarchic / --softmax take no "
                         "--mesh: they train in one process (--mesh none)")
    lead = mesh is None or mesh.rank == 0
    index = load_index(args.index)
    mcfg = dataclasses.replace(
        _model_config(args, store_dim=index.store.shape[1]),
        embedding_distillation=args.embed_distill,
        weight_distillation=args.weight_distill, dropout_rate=args.dropout)
    if t5_widths:
        # the model takes the checkpoint's widths, so its tensors fit
        mcfg = dataclasses.replace(mcfg, **t5_widths)
    tok = load_tokenizer(args.tokenizer or args.t5_ckpt,
                         vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        if args.t5_ckpt:
            raise ValueError(
                f"--tokenizer vocab ({tok.vocab_size}) must match the "
                f"--t5-ckpt vocab ({mcfg.vocab_size}): resizing the "
                "embedding table would break the warm start — point "
                "--tokenizer at the checkpoint's own tokenizer")
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)
    _check_query_length(device, args.max_input_length, mcfg,
                        torch.float32 if args.no_bf16 or modes
                        else torch.bfloat16)
    tcfg = TrainConfig(train_batch_size=args.batch_size,
                       stage2_train_batch_size=(args.stage2_batch_size
                                                or args.batch_size),
                       num_train_epochs=args.epochs,
                       train_encoder_epoch=args.train_encoder_epoch,
                       learning_rate=args.lr,
                       decoder_learning_rate=args.decoder_lr,
                       gradient_accumulation_steps=args.grad_accum,
                       bf16=not args.no_bf16,
                       checkpoint_dir=f"{args.workdir}/ckpt")
    hard = args.hard_negatives != "none"
    dcfg = DataConfig(hard_negative=hard,
                      sample_neg_num=args.sample_neg_num if hard else 0)
    cfg = GDRConfig(model=mcfg, train=tcfg, data=dcfg,
                    eval=EvalConfig(num_beams=args.beam,
                                    num_return_sequences=args.beam,
                                    max_output_length=mcfg.max_output_length))

    queries, positives = _read_query_tsv(args.train)
    train_set = build_train_set(
        queries, [p[0] for p in positives], index.paths, tok, mcfg,
        args.max_input_length, label_length_cutoff=dcfg.label_length_cutoff)
    dev_q, dev_pos = _read_query_tsv(args.dev)
    dev = build_eval_data(dev_q, dev_pos, index.cid_of_doc, tok,
                          args.max_input_length)
    if modes:
        out = _train_mode(args, mcfg, index, train_set, dev, device)
        print(json.dumps(out, indent=2, sort_keys=True))
        return

    needs_corpus = (args.hard_negatives == "bm25" or "doc" in wanted
                    or "aug" in wanted)
    if needs_corpus and not args.corpus:
        raise SystemExit("--hard-negatives bm25 and the doc / aug query "
                         "sources need --corpus (the document text)")
    doc_texts = _read_corpus_tsv(args.corpus)[1] if args.corpus else None
    if args.hard_negatives == "bm25":
        from gdr_tpu_torch.data.negatives import bm25_negatives
        train_set.neg_pool = bm25_negatives(
            queries, positives, doc_texts,
            k=max(args.sample_neg_num * 3, 10))
    elif args.hard_negatives == "random":
        from gdr_tpu_torch.data.negatives import random_negatives
        train_set.neg_pool = random_negatives(
            len(queries), len(index.paths), positives,
            k=max(args.sample_neg_num * 3, 10), seed=args.seed)

    if query_type != "gtq":
        sources = {"gtq": train_set}
        if "qg" in wanted:
            sources["qg"] = _qg_train_set(
                args.qg, train_set.input_ids.shape[1], index.paths, mcfg)
        if "doc" in wanted or "aug" in wanted:
            dq = dataclasses.replace(dcfg,
                                     max_input_length=args.max_input_length)
            sources.update(build_doc_query_sets(
                doc_texts, index.paths, tok, mcfg, dq,
                rng=np.random.default_rng(args.seed)))
        train_set = mix_sources(query_type, **sources)
        if lead:
            print("train set: " + " + ".join(
                f"{len(sources[w])} {w}" for w in wanted)
                + f" = {len(train_set)} rows", file=sys.stderr)

    # stage 2 (the live doc tower) is reachable when the corpus is given
    doc_tokens = doc_tok_mask = tower = None
    if stage2:
        if bert_width is not None and bert_width != index.store.shape[1]:
            raise ValueError(
                f"--bert-ckpt hidden size ({bert_width}) != index store dim "
                f"({index.store.shape[1]}): rebuild the index with the same "
                "checkpoint (index --bert-ckpt)")
        dtok, tower = _doc_tower(args, torch.device("cpu"),
                                 bert_ckpt=args.bert_ckpt)
        if tower.cfg.d_model != index.store.shape[1]:
            raise SystemExit(
                f"doc tower width {tower.cfg.d_model} != index store width "
                f"{index.store.shape[1]}: build the index with the same "
                f"--encoder-size / --encoder-ckpt")
        doc_tokens, doc_tok_mask = dtok.encode_batch(doc_texts,
                                                     args.encoder_max_len)
        if lead:
            print(f"stage 2 enabled: live doc tower over {len(doc_texts)} "
                  f"docs from epoch {args.train_encoder_epoch + 1}",
                  file=sys.stderr)

    warm = _t5_warm_start(args.t5_ckpt, mcfg.num_layers) if args.t5_ckpt \
        else None
    loop = TrainLoop(cfg, index, train_set, dev, workdir=args.workdir,
                     seed=args.seed, doc_tokens=doc_tokens,
                     doc_tok_mask=doc_tok_mask, doc_encoder=tower,
                     mesh=mesh, packed_eval=args.packed_eval,
                     warm_start=warm, device=device)
    best = loop.run()
    if not lead:
        return
    step, state = loop.ckpt.restore_best()
    params = (state or loop.state).params["generator"]
    out = os.path.join(args.workdir, "params.npz")
    n = save_params_npz(out, params)
    print(f"# wrote {n} arrays of checkpoint step {step} to {out}",
          file=sys.stderr)
    print(json.dumps({k: best[k] for k in ("epoch", "avg_train_loss",
                                            cfg.train.monitor) if k in best}))


def _t5_warm_start(path: str, num_layers: int):
    """``TrainLoop``'s ``warm_start`` hook of ``train --t5-ckpt``: the
    encoder and shared embeddings from a HF T5 checkpoint directory, an
    ``export_t5_encoder`` ``.npz`` (HF names) or a ``params.npz`` (flax
    paths), told apart by their key names."""
    import numpy as np

    from gdr_tpu_torch.convert import load_params_npz
    from gdr_tpu_torch.models.convert import (load_t5_encoder,
                                              state_dict_from_pretrained)

    sd = None
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            names = z.files
        if "shared.weight" not in names:
            if not names or not all("/" in k for k in names):
                raise SystemExit(f"--t5-ckpt {path}: neither an "
                                 f"export_t5_encoder dump (HF names) nor a "
                                 f"params.npz (flax paths)")
            sd = {k: v for k, v in load_params_npz(path).items()
                  if k.startswith(("shared.", "encoder."))}
    hf = state_dict_from_pretrained(path) if sd is None else None

    def warm(model, _tower):
        if hf is not None:
            load_t5_encoder(model, hf, num_layers)
        else:
            want = {k for k in model.state_dict()
                    if k.startswith(("shared.", "encoder."))}
            if set(sd) != want:
                raise SystemExit(f"--t5-ckpt {path}: its encoder and shared "
                                 f"leaves do not match the model's")
            model.load_state_dict(sd, strict=False)
        print(f"# encoder and shared embeddings from {path}", file=sys.stderr)

    return warm


def _qg_train_set(path: str, width: int, paths, mcfg):
    """The `qg` subcommand's .npz as a ``qg`` train source, its query
    tokens padded or cut to the train set's ``width``."""
    import numpy as np

    from gdr_tpu_torch.data.dataset import build_train_set_from_tokens
    with np.load(path) as z:
        qt, qm, src = z["query_tokens"], z["query_mask"], z["source_doc"]
    if qt.shape[1] < width:
        pad = ((0, 0), (0, width - qt.shape[1]))
        qt, qm = np.pad(qt, pad), np.pad(qm, pad)
    qt, qm = qt[:, :width], qm[:, :width]
    return build_train_set_from_tokens(qt, qm, [int(s) for s in src], paths,
                                       mcfg)


def _train_mode(args, mcfg, index, train_set, dev, device) -> dict:
    """``train --ensemble N`` / ``--hierarchic`` / ``--softmax``: the
    mode's training and eval (``train/modes.py``), its metrics."""
    from gdr_tpu_torch.train import modes

    common = dict(epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
                  workdir=args.workdir, seed=args.seed, device=device)
    if args.ensemble > 1:
        modes.train_ensemble(mcfg, index, train_set,
                             num_decoders=args.ensemble,
                             leaf_cap=args.leaf_cap,
                             decoder_lr=args.decoder_lr, rdrop=mcfg.rdrop,
                             rdrop_loss=mcfg.rdrop_loss, **common)
        return modes.eval_ensemble(mcfg, index, dev, args.workdir,
                                   num_decoders=args.ensemble,
                                   beam=args.beam, device=device)
    if args.hierarchic:
        return modes.train_eval_hierarchic(mcfg, index, train_set, dev,
                                           beam=args.beam, **common)
    return modes.train_eval_softmax(mcfg, index, train_set, dev, **common)


def cmd_retrieve(args) -> None:
    import numpy as np

    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.index.io import load_index
    from gdr_tpu_torch.parallel.distributed import process_info

    device = _device(args.device)
    mesh = _mesh_from_flag(args.mesh, device)
    emit = print if process_info()[0] == 0 else (lambda *a, **k: None)
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
    evaluator = Evaluator(model, index.trie, index.store, ev_cfg, mesh=mesh,
                          packed=args.packed, quantize=args.int8_store)

    bs = min(args.batch_size, len(queries))
    if not args.json:
        emit("query_idx\trank\tdoc_id\tscore\tcid")
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
                emit(json.dumps({
                    "query": q,
                    "results": [{"doc_id": d, "score": round(sc, 6),
                                 "cid": index.cid_of_doc[d]}
                                for d, sc in hits]}))
            else:
                for r, (d, sc) in enumerate(hits):
                    emit(f"{s + b}\t{r + 1}\t{d}\t{sc:.6f}"
                          f"\t{index.cid_of_doc[d]}")


def cmd_eval(args) -> None:
    from gdr_tpu_torch.config import EvalConfig
    from gdr_tpu_torch.data.dataset import build_eval_data
    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.eval.evaluator import Evaluator
    from gdr_tpu_torch.index.io import load_index
    from gdr_tpu_torch.parallel.distributed import process_info

    device = _device(args.device)
    mesh = _mesh_from_flag(args.mesh, device)
    if mesh is not None and args.ensemble > 1:
        raise SystemExit("--ensemble takes no --mesh: the ensemble's eval "
                         "reads each member's store on one device")
    lead = process_info()[0] == 0
    index = load_index(args.index)
    mcfg = _model_config(args, store_dim=index.store.shape[1])
    _check_query_length(device, args.max_input_length, mcfg)
    tok = load_tokenizer(args.tokenizer, vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)
    dev_q, dev_pos = _read_query_tsv(args.dev)
    dev = build_eval_data(dev_q, dev_pos, index.cid_of_doc, tok,
                          args.max_input_length)
    if args.ensemble > 1:
        from gdr_tpu_torch.train.modes import eval_ensemble
        out = eval_ensemble(mcfg, index, dev, args.workdir,
                            num_decoders=args.ensemble, beam=args.beam,
                            batch_size=args.eval_batch_size, device=device)
        print(json.dumps(out, indent=2, sort_keys=True))
        return

    model = load_model(mcfg, args.workdir, device, args.seed)
    ev_cfg = EvalConfig(num_beams=args.beam, num_return_sequences=args.beam,
                        max_output_length=mcfg.max_output_length,
                        gen_method=args.gen_method,
                        temperature=args.temperature,
                        sample_top_k=args.sample_top_k)
    evaluator = Evaluator(model, index.trie, index.store, ev_cfg, mesh=mesh,
                          packed=args.packed, quantize=args.int8_store)
    out = evaluator.evaluate(dev, batch_size=args.eval_batch_size,
                             result_tsv=args.result_tsv if lead else None)
    if not lead:
        return
    if args.result_tsv:
        print(f"wrote result TSV → {args.result_tsv}")
    print(json.dumps(out, indent=2, sort_keys=True))


def _ensure_eos(q_ids):
    """EOS-terminate tokenized queries (seq2seq targets): EOS at the first
    pad slot, or the last slot when the row is full."""
    import numpy as np
    q = np.asarray(q_ids).copy()
    for i in range(len(q)):
        pads = np.flatnonzero(q[i] == 0)
        q[i, pads[0] if len(pads) else -1] = 1
    return q


def cmd_qg(args) -> None:
    """Query generation (docTTTTTquery): optionally fine-tune a doc→query
    Seq2SeqLM on the train TSV, then sample ``--n-per-doc`` pseudo-queries
    per corpus doc into a token-level .npz (``query_tokens``,
    ``query_mask``, ``source_doc``) that ``train --qg`` reads."""
    import numpy as np
    import torch

    from gdr_tpu_torch.data.tokenize import load_tokenizer
    from gdr_tpu_torch.kernels.decode import self_attn_max_len
    from gdr_tpu_torch.models.seq2seq import (Seq2SeqLM, generate_queries,
                                              make_qg_train_step,
                                              qg_optimizer)
    from gdr_tpu_torch.models.t5 import init_t5_weights

    device = _device(args.device)
    _, texts = _read_corpus_tsv(args.corpus)
    mcfg = _model_config(args)
    tok = load_tokenizer(args.tokenizer, vocab_size=mcfg.vocab_size)
    if tok.vocab_size != mcfg.vocab_size:
        mcfg = dataclasses.replace(mcfg, vocab_size=tok.vocab_size)
    _check_query_length(device, args.doc_length, mcfg)
    limit = self_attn_max_len(mcfg.d_kv, torch.float32)
    if device.type == "cuda" and args.max_query_length > limit:
        raise SystemExit(f"--max-query-length {args.max_query_length}: the "
                         f"CUDA self-attention core serves at most {limit} "
                         f"positions at d_kv {mcfg.d_kv}")
    doc_ids, doc_mask = tok.encode_batch(texts, args.doc_length)
    with torch.device(device):
        model = Seq2SeqLM(mcfg)
    init_t5_weights(model, torch.Generator(device=device)
                    .manual_seed(args.seed))

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=device)

    if args.train:
        queries, positives = _read_query_tsv(args.train)
        q_ids = _ensure_eos(tok.encode_batch(queries,
                                             args.max_query_length)[0])
        pos = np.asarray([p[0] for p in positives], np.int64)
        step = make_qg_train_step(model, qg_optimizer(model, args.lr))
        rng = np.random.default_rng(args.seed)
        bs = min(args.batch_size, len(queries))
        for epoch in range(args.qg_epochs):
            order = rng.permutation(len(queries))
            losses = []
            for s in range(0, len(order) - bs + 1, bs):
                idx = order[s:s + bs]
                batch = {"doc_tokens": on_card(doc_ids[pos[idx]]),
                         "doc_mask": on_card(doc_mask[pos[idx]]),
                         "query_tokens": on_card(q_ids[idx])}
                gen = torch.Generator(device=device).manual_seed(
                    epoch * 10_007 + s)
                losses.append(float(step(batch, gen)))
            print(f"qg epoch {epoch}: loss {np.mean(losses):.4f}",
                  file=sys.stderr)

    all_toks, all_src = [], []
    bs = min(args.batch_size, len(texts))
    for s in range(0, len(texts), bs):
        e = min(s + bs, len(texts))
        ids, msk = doc_ids[s:e], doc_mask[s:e]
        if e - s < bs:        # pad to the batch shape
            pad = bs - (e - s)
            ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]),
                                                ids.dtype)])
            msk = np.concatenate([msk, np.ones((pad, msk.shape[1]),
                                               msk.dtype)])
        toks, src = generate_queries(
            model, on_card(ids), on_card(msk), n_per_doc=args.n_per_doc,
            max_len=args.max_query_length,
            generator=torch.Generator(device=device).manual_seed(
                args.seed * 7919 + s),
            temperature=args.temperature, top_k=args.sample_top_k)
        toks, src = toks.cpu().numpy(), src.cpu().numpy()
        keep = src < (e - s)
        all_toks.append(toks[keep])
        all_src.append(src[keep] + s)
    q_toks = np.concatenate(all_toks)
    src = np.concatenate(all_src)
    np.savez(args.out, query_tokens=q_toks.astype(np.int32),
             query_mask=(q_toks != 0).astype(np.int32),
             source_doc=src.astype(np.int32))
    print(f"qg: {len(q_toks)} pseudo-queries ({args.n_per_doc}/doc × "
          f"{len(texts)} docs) → {args.out}")


def cmd_ingest(args) -> None:
    """Raw data → the ``corpus.tsv`` / ``train.tsv`` / ``dev.tsv`` that
    ``index`` and ``train`` read: simplified NQ jsonl (train, and dev over
    the same document table) or the pickled corpus with its query records;
    without a dev file, ``--dev-frac`` holds out the tail of the train
    queries."""
    from gdr_tpu_torch.data.corpus import (QuerySet, corpus_from_records,
                                           ingest_nq_splits,
                                           queries_from_records)

    if bool(args.nq_jsonl) == bool(args.corpus_pickle):
        raise ValueError("pass exactly one of --nq-jsonl / --corpus-pickle")
    if args.corpus_pickle and not args.train_pickle:
        raise ValueError("--corpus-pickle requires --train-pickle")

    if args.nq_jsonl:
        corpus, train_q, dev_q = ingest_nq_splits(
            args.nq_jsonl, args.dev_jsonl, max_records=args.max_records)
    else:
        import pickle
        with open(args.corpus_pickle, "rb") as fh:
            corpus, title_to_id = corpus_from_records(pickle.load(fh))
        with open(args.train_pickle, "rb") as fh:
            train_q = queries_from_records(pickle.load(fh), title_to_id)
        dev_q = None
        if args.dev_pickle:
            with open(args.dev_pickle, "rb") as fh:
                dev_q = queries_from_records(pickle.load(fh), title_to_id)

    if dev_q is None and args.dev_frac > 0:
        # the corpus stays whole, so retrieval still runs over every doc
        n_dev = max(1, int(len(train_q.queries) * args.dev_frac))
        dev_q = QuerySet(queries=train_q.queries[-n_dev:],
                         doc_ids=train_q.doc_ids[-n_dev:])
        train_q = QuerySet(queries=train_q.queries[:-n_dev],
                           doc_ids=train_q.doc_ids[:-n_dev])

    os.makedirs(args.out_dir, exist_ok=True)

    def _clean(s: str) -> str:          # TSV-safe single-line fields
        return s.replace("\t", " ").replace("\n", " ")

    with open(os.path.join(args.out_dir, "corpus.tsv"), "w") as fh:
        for t, x in zip(corpus.titles, corpus.texts):
            fh.write(f"{_clean(t)}\t{_clean(x)}\n")

    def _write_queries(name: str, qs) -> None:
        with open(os.path.join(args.out_dir, name), "w") as fh:
            for q, ds in zip(qs.queries, qs.doc_ids):
                fh.write(f"{_clean(q)}\t{','.join(str(d) for d in ds)}\n")

    _write_queries("train.tsv", train_q)
    if dev_q is not None:
        _write_queries("dev.tsv", dev_q)
    print(f"ingest: {len(corpus.titles)} docs, {len(train_q.queries)} train"
          + (f", {len(dev_q.queries)} dev" if dev_q is not None else "")
          + f" → {args.out_dir}/{{corpus,train"
          + (",dev" if dev_q is not None else "") + "}.tsv")


def cmd_calculate(args) -> None:
    from gdr_tpu_torch.eval.offline import calculate
    print(json.dumps(calculate(args.result, ref_compat=args.ref_compat),
                     indent=2, sort_keys=True))


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (kernels) or cpu (plain "
                        "PyTorch)")


def _add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", default="none",
                   help="row-shard the doc store over the ranks of the "
                        "process group (torchrun): 'none', 'auto' or "
                        "'DP,MP'; with --int8-store it needs --packed")


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
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port, to start a process group "
                        "without torchrun (torchrun's environment needs "
                        "nothing); processes are numbered host by host, "
                        "one per card, process p on card p %% cards")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
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
                    help="HuggingFace BERT / DPR / AR2 checkpoint directory: "
                         "the doc tower's architecture and weights (and its "
                         "tokenizer unless --doc-tokenizer)")
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
    pt = sub.add_parser("train", help="two-stage training")
    _add_common_model_flags(pt)
    pt.add_argument("--index", required=True)
    pt.add_argument("--train", required=True,
                    help="train TSV: query \\t docid[,docid...]")
    pt.add_argument("--dev", required=True)
    pt.add_argument("--workdir", required=True,
                    help="run dir: checkpoints, metrics and params.npz")
    pt.add_argument("--tokenizer", default=None)
    pt.add_argument("--max-input-length", type=int, default=40)
    pt.add_argument("--batch-size", type=int, default=64)
    pt.add_argument("--stage2-batch-size", type=int, default=None,
                    help="stage-2 batch (default: --batch-size)")
    pt.add_argument("--epochs", type=int, default=500)
    pt.add_argument("--train-encoder-epoch", type=int, default=51)
    pt.add_argument("--lr", type=float, default=2e-4)
    pt.add_argument("--decoder-lr", type=float, default=1e-4)
    pt.add_argument("--beam", type=int, default=100)
    pt.add_argument("--seed", type=int, default=42)
    pt.add_argument("--hard-negatives", default="none",
                    choices=["none", "bm25", "random"],
                    help="mine per-query negatives and train the margin "
                         "ranking loss on them")
    pt.add_argument("--sample-neg-num", type=int, default=2)
    pt.add_argument("--corpus", default=None,
                    help="corpus TSV: enables stage 2 (with "
                         "--train-encoder-epoch < --epochs), bm25 negatives "
                         "and the doc / aug query sources")
    pt.add_argument("--doc-tokenizer", default=None)
    pt.add_argument("--encoder-max-len", type=int, default=128)
    pt.add_argument("--encoder-size", default="full",
                    choices=["full", "tiny"])
    pt.add_argument("--encoder-ckpt", default=None,
                    help="the stage-2 doc tower's starting weights (.npz "
                         "of tools/export_gdr_tpu_params.py --doc-encoder)")
    pt.add_argument("--packed-eval", action="store_true",
                    help="the in-training eval reads the cluster-packed "
                         "store")
    pt.add_argument("--mesh", default="auto",
                    help="'none', 'auto' (every rank of the process group "
                         "data-parallel; one process without one) or "
                         "'DP,MP' (tensor-parallel over MP: each rank "
                         "holds and computes its columns of large leaves)")
    pt.add_argument("--dropout", type=float, default=0.1,
                    help="the modules' dropout rate")
    pt.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches per optimizer update")
    pt.add_argument("--no-bf16", action="store_true",
                    help="compute in f32 (bf16 compute over f32 masters is "
                         "the default)")
    pt.add_argument("--embed-distill", type=float, default=0.0,
                    help="weight of the embedding-distillation loss")
    pt.add_argument("--weight-distill", type=float, default=0.0,
                    help="weight of the weight-distillation loss (needs the "
                         "index's node embeddings)")
    pt.add_argument("--t5-ckpt", default=None,
                    help="warm start of the encoder and shared embeddings "
                         "from a HuggingFace T5 checkpoint directory (its "
                         "widths replace the preset's), an export_t5_encoder "
                         ".npz or a params.npz")
    pt.add_argument("--bert-ckpt", default=None,
                    help="the stage-2 doc tower from a HuggingFace BERT / "
                         "DPR / AR2 checkpoint directory; needs --corpus and "
                         "--train-encoder-epoch < --epochs")
    pt.add_argument("--qg", default=None,
                    help="generated queries: the `qg` subcommand's .npz")
    pt.add_argument("--query-type", default=None,
                    help="underscore-joined mix of gtq, qg, doc and aug "
                         "(default gtq, or gtq_qg with --qg)")
    pt.add_argument("--ensemble", type=int, default=1,
                    help="train N decoders on one shared encoder, each on "
                         "its own k-means docid assignment, then evaluate "
                         "their merged retrievals")
    pt.add_argument("--leaf-cap", type=int, default=30,
                    help="leaf size of the ensemble's extra k-means "
                         "assignments")
    pt.add_argument("--hierarchic", action="store_true",
                    help="one decoder stack per CID depth, then its "
                         "constrained decode + re-rank")
    pt.add_argument("--softmax", action="store_true",
                    help="encoder + linear classifier over the trie's "
                         "clusters")
    _add_device_flag(pt)
    pt.set_defaults(fn=cmd_train)

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
                    help="query tokens; on cuda at most 1,472 at d_kv 64 "
                         "(the f32 cross-attention kernel holds 32 beams' "
                         "scores of every key in shared memory)")
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
    _add_mesh_flag(pr)
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
    _add_mesh_flag(pe)
    pe.add_argument("--ensemble", type=int, default=1,
                    help="evaluate the N-decoder ensemble that train "
                         "--ensemble N wrote (ensemble.npz)")
    _add_device_flag(pe)
    pe.add_argument("--seed", type=int, default=42,
                    help="seed of the random weights used when the workdir "
                         "has no params.npz")
    pe.set_defaults(fn=cmd_eval)

    pq = sub.add_parser("qg", help="generate pseudo-queries per doc "
                                   "(docTTTTTquery)")
    _add_common_model_flags(pq)
    pq.add_argument("--corpus", required=True)
    pq.add_argument("--out", required=True, help=".npz output")
    pq.add_argument("--train", default=None,
                    help="train TSV to fine-tune doc→query first")
    pq.add_argument("--tokenizer", default=None)
    pq.add_argument("--doc-length", type=int, default=64)
    pq.add_argument("--max-query-length", type=int, default=40)
    pq.add_argument("--n-per-doc", type=int, default=5,
                    help="pseudo-queries per doc")
    pq.add_argument("--qg-epochs", type=int, default=3)
    pq.add_argument("--batch-size", type=int, default=64)
    pq.add_argument("--lr", type=float, default=1e-3)
    pq.add_argument("--temperature", type=float, default=1.0)
    pq.add_argument("--sample-top-k", type=int, default=10)
    pq.add_argument("--seed", type=int, default=42)
    _add_device_flag(pq)
    pq.set_defaults(fn=cmd_qg)

    pn = sub.add_parser("ingest", help="raw NQ jsonl / pickle corpus → "
                                       "corpus.tsv + train/dev TSVs")
    pn.add_argument("--nq-jsonl", default=None,
                    help="simplified NQ train jsonl(.gz)")
    pn.add_argument("--dev-jsonl", default=None,
                    help="simplified NQ dev jsonl(.gz); shares the train "
                         "corpus' doc-id table")
    pn.add_argument("--max-records", type=int, default=None)
    pn.add_argument("--corpus-pickle", default=None,
                    help="pickled [{'title','text'}] corpus")
    pn.add_argument("--train-pickle", default=None,
                    help="pickled [{'query','positive_passages'}] records")
    pn.add_argument("--dev-pickle", default=None)
    pn.add_argument("--dev-frac", type=float, default=0.0,
                    help="with no dev file: hold out this query fraction "
                         "as dev.tsv")
    pn.add_argument("--out-dir", required=True)
    pn.set_defaults(fn=cmd_ingest)

    pc = sub.add_parser("calculate", help="offline metrics from result TSV")
    pc.add_argument("--result", required=True)
    pc.add_argument("--ref-compat", action="store_true",
                    help="score with the reference's exact semantics "
                         "(hits@k over row-accumulated gt, per-row MRR100); "
                         "default is per-query fraction-recall")
    pc.set_defaults(fn=cmd_calculate)
    return p


def _bootstrap(args) -> bool:
    """Join the process group when several processes run
    (``parallel/distributed.py::initialize`` reads torchrun's environment
    or ``--coordinator`` / ``--num-processes`` / ``--process-id``):
    ``nccl`` under ``--device cuda``, one card per rank, ``gloo`` under
    ``--device cpu``.  Returns True when a group was made."""
    from gdr_tpu_torch.parallel.distributed import initialize, process_info

    backend = "nccl" if getattr(args, "device", "cuda").startswith("cuda") \
        else "gloo"
    try:
        if not initialize(args.coordinator, args.num_processes,
                          args.process_id, backend=backend):
            return False
    except ValueError as e:
        raise SystemExit(f"process group: {e}")
    rank, world = process_info()
    print(f"# process group: rank {rank}/{world} over {backend}",
          file=sys.stderr)
    return True


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    started = _bootstrap(args)
    try:
        args.fn(args)
    finally:
        if started:
            from gdr_tpu_torch.parallel.distributed import shutdown
            shutdown()


if __name__ == "__main__":
    main()
