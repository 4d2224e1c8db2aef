"""Eval-set assembly (a copy of ``build_eval_data`` from
``gdr_tpu/data/dataset.py``; the training datasets are a later slice)."""

from __future__ import annotations

from typing import Sequence

from gdr_tpu_torch.eval.evaluator import EvalData


def build_eval_data(queries: Sequence[str],
                    positives: Sequence[Sequence[int]],
                    cid_of_doc: Sequence[str], tokenizer,
                    max_input_length: int) -> EvalData:
    """Dev set with multi-positive rows: token arrays, ground-truth doc-id
    strings and their sorted CID strings."""
    ids, mask = tokenizer.encode_batch(list(queries), max_input_length)
    gt_docs = [[str(d) for d in pos] for pos in positives]
    gt_cids = [sorted({cid_of_doc[d] for d in pos}) for pos in positives]
    return EvalData(input_ids=ids, attn_mask=mask,
                    gt_docs=gt_docs, gt_cids=gt_cids)
