"""Offline metrics over result TSVs, the reference's ``calculate`` mode (a
copy of ``gdr_tpu/eval/offline.py``).

A result TSV has one row per query: query, comma-joined predictions,
comma-joined ground truths, rank.  Both packages read and write the same
format, so their result files are interchangeable.

Two scoring modes (identical on single-positive, single-row files):

* default: keeps rank-1 rows, the per-query gt set, fraction-recall
  (|gts found in top-k| / |gts|) macro and micro, and set-MRR; the
  definition the online evaluator uses;
* ``ref_compat=True``: the reference's exact semantics.  Predictions come
  from the first line of each contiguous run of a query (rank ignored); the
  gt set accumulates the first row's ``gt.split(",")``, then each later
  row's whole gt string (capped above 100); recall@k is binary hits@k per
  query; MRR100 is per row: the row's whole gt string looked up in the
  prediction list, divided by the row count.
"""

from __future__ import annotations

import csv
from typing import Sequence

from gdr_tpu_torch.eval import metrics as M


def read_result_tsv(path: str) -> tuple[dict, dict]:
    """Rows: query \\t preds(comma) \\t gts(comma) \\t rank.  Keeps rank-1
    rows; the first row per query wins."""
    preds: dict[str, list[str]] = {}
    gts: dict[str, list[str]] = {}
    with open(path, newline="") as fh:
        for row in csv.reader(fh, delimiter="\t"):
            if len(row) < 3:
                continue
            query, p, g = row[0], row[1], row[2]
            rank = int(row[3]) if len(row) > 3 else 1
            if rank != 1 or query in preds:
                continue
            preds[query] = p.split(",") if p else []
            gts[query] = sorted(set(g.split(","))) if g else []
    return preds, gts


def write_result_tsv(path: str, rows: Sequence[tuple[str, list, list, int]]
                     ) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t")
        for query, preds, gts, rank in rows:
            w.writerow([query, ",".join(map(str, preds)),
                        ",".join(map(str, gts)), rank])


def _read_rows(path: str) -> list[tuple[str, str, str]]:
    rows = []
    with open(path, newline="") as fh:
        for row in csv.reader(fh, delimiter="\t"):
            if len(row) >= 3:
                rows.append((row[0], row[1], row[2]))
    return rows


def calculate_ref_compat(path: str,
                         recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100)
                         ) -> dict[str, float]:
    """The reference's exact scoring; see the module docstring."""
    rows = _read_rows(path)
    q_pred: dict[str, list[str]] = {}
    q_gt: dict[str, set[str]] = {}
    prev_q = ""
    for query, pred, gt in rows:
        # predictions: the first line of each contiguous run of a query
        if query != prev_q:
            q_pred[query] = pred.split(",")
            prev_q = query
        if query in q_gt:
            # later rows add their whole gt string, capped
            if len(q_gt[query]) <= 100:
                q_gt[query].add(gt)
        else:
            q_gt[query] = set(gt.split(","))
    out: dict[str, float] = {}
    for k in recall_ks:
        hits = sum(any(p in q_pred[q][:k] for p in q_gt[q]) for q in q_pred)
        out[f"recall{k}"] = hits / len(q_pred) if q_pred else 0.0
    # MRR100: per row, whole gt string, divided by the row count
    mrr_total = 0.0
    for query, pred, gt in rows:
        pred_list = pred.split(",")
        if gt in pred_list:
            mrr_total += 1.0 / (pred_list.index(gt) + 1)
    out["MRR100"] = mrr_total / len(rows) if rows else 0.0
    return out


def calculate(path: str, recall_ks: Sequence[int] = (1, 5, 10, 20, 50, 100),
              ref_compat: bool = False) -> dict[str, float]:
    if ref_compat:
        return calculate_ref_compat(path, recall_ks)
    preds, gts = read_result_tsv(path)
    out: dict[str, float] = {}
    for k in recall_ks:
        mac, mic = M.recall_at_k(preds, gts, k)
        out[f"recall{k}"] = mac
        out[f"recall{k}_micro"] = mic
    out["MRR100"] = M.mrr_at_k(preds, gts, 100)
    out["MRR10"] = M.mrr_at_k(preds, gts, 10)
    return out
