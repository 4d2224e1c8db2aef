"""The comparisons that decide ``correct``: what the timed path returned
against the plain reference, reduced to a few numbers, each held to a
limit that the traffic file states.

Serving (:func:`serve_numbers`).  Two correct beam searches keep the same
beams unless, at some step, the last beam kept and the first dropped
score within rounding of each other; the reference reports that smallest
gap per query, and a query whose gap is under ``TIE_GAP`` is left out of
the set comparison (its common beams are still compared).  The numbers:

- ``malformed``: answers that cannot be right whatever the rounding: a
  count of valid beams other than the reference's, a beam that spells no
  CID of the trie or repeats one, a document that no beam's cluster holds,
  a repeated document, fewer valid documents than the reference returns;
- ``beam_set_diff``: queries clear of ties whose beam set differs;
- ``beam_score_err``: the largest |served − reference| length-normalised
  score of a beam both kept;
- ``fused_err``: the largest |served − reference| fused score of a
  returned document, over every α (queries with equal beam sets);
- ``top_r_gap``: the widest gap by which a returned document's reference
  fused score lies below the reference's R-th best.
"""

from __future__ import annotations

import numpy as np

# a step's cut this close to a tie may fall either way under f32 rounding
TIE_GAP = 3e-4
SERVE_NUMBERS = ("malformed", "beam_set_diff", "beam_score_err", "fused_err",
                 "top_r_gap")


def served_cids(seq: np.ndarray, kary: int) -> tuple | None:
    """The digits of one served token row [start, t0, t1, …], up to its
    EOS; None where a token is not a digit of its position."""
    digits = []
    for pos, t in enumerate(seq[1:]):
        if t == 1:
            return tuple(digits)
        d = int(t) - 2 - pos * kary
        if not 0 <= d < kary:
            return None
        digits.append(d)
    return None


def serve_numbers(prog: dict, beams, rr, kary: int, alphas,
                  cids: set) -> dict[str, float]:
    """The numbers of one retrieve: ``prog`` holds the served arrays
    (``sequences`` [B, K, L+1], ``beam_scores`` [B, K], ``valid`` [B, K],
    ``doc_ids`` and ``fused`` [A, B, R]); ``beams`` and ``rr`` the
    reference's (``reference/serve.py``); ``cids`` every CID of the trie
    as a digit tuple.  Also ``queries`` and ``tie_excluded`` (not
    compared)."""
    out = dict.fromkeys(SERVE_NUMBERS, 0.0)
    out["queries"] = 0
    out["tie_excluded"] = 0
    n_alpha, n_q, top_r = prog["doc_ids"].shape
    for b in range(n_q):
        out["queries"] += 1
        ref = {c: s for c, s in zip(beams.cids[b], beams.scores[b])}
        got: dict[tuple, float] = {}
        bad = 0
        for k in np.flatnonzero(prog["valid"][b]):
            c = served_cids(prog["sequences"][b, k], kary)
            if c is None or c in got or c not in cids:
                bad += 1
                continue
            got[c] = float(prog["beam_scores"][b, k])
        if int(prog["valid"][b].sum()) != len(ref):
            bad += 1
        for c in got.keys() & ref.keys():
            out["beam_score_err"] = max(out["beam_score_err"],
                                        abs(got[c] - float(ref[c])))
        if beams.cut_gap[b] < TIE_GAP:
            out["tie_excluded"] += 1
            out["malformed"] += bad
            continue
        if bad or got.keys() != ref.keys():
            out["beam_set_diff"] += int(got.keys() != ref.keys())
            out["malformed"] += bad
            continue
        sim, prob = rr.sim[b], rr.prob[b]
        n_ref = int((rr.fused[0, b] > -1e8).sum())
        for a in range(n_alpha):
            alpha = float(alphas[a])
            ids = prog["doc_ids"][a, b]
            ok = prog["fused"][a, b] > -1e8
            if int(ok.sum()) < n_ref or len(set(ids[ok].tolist())) != ok.sum():
                bad += 1
            kth = float(rr.fused[a, b, n_ref - 1])
            for d, f in zip(ids[ok].tolist(), prog["fused"][a, b][ok].tolist()):
                if d not in sim:
                    bad += 1
                    continue
                fr = sim[d] + alpha * prob[d]
                out["fused_err"] = max(out["fused_err"], abs(f - fr))
                out["top_r_gap"] = max(out["top_r_gap"], kth - fr)
        out["malformed"] += bad
    return out


def merge(parts: list[dict]) -> dict[str, float]:
    """Counts add up, errors and gaps take the largest."""
    out: dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            if k in ("malformed", "beam_set_diff", "queries", "tie_excluded"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out
