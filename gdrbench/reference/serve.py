"""Plain float32 retrieval, the yardstick of the serving cells: the
encoder's query embedding, a trie-constrained beam search with progressive
widening that recomputes the decoder and the PAWA adaptor over each beam's
whole prefix at every step, and the dense re-rank of the beams' clusters
with the score fusion of every α.

It reads only the configuration, the weights and the store that the
benchmark makes, and the CID → documents map of the traffic's world; the
trie, the U table and the store's layout are worked out here again.
Besides the answer it reports, per query, the smallest gap at any step
between the last beam kept and the first one dropped, so that the
comparison knows where two correct searches may keep different beams.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gdrbench.reference import model as M

NEG = M.NEG


class Trie:
    """Nodes of every CID prefix: ``children`` [N, kary] (−1 absent),
    ``eos`` [N] (a whole CID ends there), ``cid`` of each node."""

    def __init__(self, cid_to_docs: dict[str, list[int]], kary: int):
        kids: list[dict[int, int]] = [{}]
        cids: list[tuple] = [()]
        eos = [False]
        for cid in cid_to_docs:
            node = 0
            digits = tuple(int(c) for c in cid.split("-"))
            for i, dgt in enumerate(digits):
                nxt = kids[node].get(dgt)
                if nxt is None:
                    nxt = len(kids)
                    kids[node][dgt] = nxt
                    kids.append({})
                    cids.append(digits[:i + 1])
                    eos.append(False)
                node = nxt
            eos[node] = True
        self.children = np.full((len(kids), kary), -1, np.int64)
        for n, ch in enumerate(kids):
            for dgt, c in ch.items():
                self.children[n, dgt] = c
        self.eos = np.asarray(eos)
        self.cid = cids
        self.kary = kary


@dataclass
class Beams:
    cids: list[list[tuple]]      # per query: valid beams' digit tuples, best first
    scores: list[np.ndarray]     # per query: their length-normalised scores
    cut_gap: np.ndarray          # [B] smallest kept − dropped score at a cut


def beam_search(w: dict, cfg: dict, ecfg: dict, ids: torch.Tensor,
                mask: torch.Tensor, trie: Trie, max_len: int
                ) -> tuple[Beams, torch.Tensor]:
    """Beam search over the trie (progressive widening 1, kary+1, … up to
    the beam width, early exit once every beam has finished) → the beams
    and the query embeddings [B, d]."""
    dev = ids.device
    kary, k = cfg["kary"], ecfg["num_beams"]
    b = ids.shape[0]
    enc = M.encode(w, cfg, ids, mask)
    q = M.query_embedding(w, cfg, enc)
    children = torch.as_tensor(trie.children, device=dev)
    eos_ok = torch.as_tensor(trie.eos, device=dev)
    tokens = torch.zeros((b, 1, 1), dtype=torch.long, device=dev)
    node = torch.zeros((b, 1), dtype=torch.long, device=dev)
    cum = torch.zeros((b, 1), device=dev)
    done = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    eos_pos = torch.full((b, 1), max_len - 1, dtype=torch.long, device=dev)
    gap = torch.full((b,), float("inf"), dtype=torch.float64)
    for pos in range(max_len):
        if not bool((~done & (cum > NEG / 2)).any()):
            break
        width = tokens.shape[1]
        flat_tok = tokens.reshape(b * width, pos + 1)
        hid = M.decode(w, cfg, flat_tok, enc, mask)[:, pos]
        ada = M.pawa(w, cfg, flat_tok)[:, pos]
        logits = M.candidate_logits(w, cfg, hid, ada, pos).view(b, width, -1)
        allowed = torch.cat([children[node] >= 0, eos_ok[node][..., None]], -1)
        lp = M.log_softmax_masked(logits, allowed)
        frozen = torch.full_like(lp, NEG)
        frozen[..., kary] = 0.0
        lp = torch.where(done[..., None], frozen, lp)
        cand = (cum[..., None] + lp).reshape(b, -1)
        out_w = min(width * (kary + 1), k)
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        n_valid = (cand > NEG / 2).sum(1)
        cut = (n_valid > out_w).cpu()
        if bool(cut.any()):
            g = (top[:, out_w - 1] - top[:, out_w]).double().cpu()
            gap = torch.where(cut, torch.minimum(gap, g), gap)
        top, idx = top[:, :out_w], idx[:, :out_w]
        src, opt = idx // (kary + 1), idx % (kary + 1)
        take = lambda t: torch.gather(t, 1, src)
        node, done_src, eos_src = take(node), take(done), take(eos_pos)
        is_eos = (opt == kary) & ~done_src
        tok = torch.where(done_src, torch.zeros_like(opt),
                          torch.where(is_eos, torch.ones_like(opt),
                                      pos * kary + 2 + opt))
        node = torch.where(opt < kary,
                           children[node, opt.clamp_max(kary - 1)], node)
        node = node.clamp_min(0)
        eos_pos = torch.where(is_eos, pos, eos_src)
        done = done_src | is_eos
        prev = torch.gather(tokens, 1, src[..., None].expand(-1, -1, pos + 1))
        tokens = torch.cat([prev, tok[..., None]], dim=2)
        cum = top
    norm = cum / (eos_pos + 1).double().pow(ecfg["length_penalty"]).float()
    valid = cum > NEG / 2
    out = Beams([], [], gap.numpy())
    for qi in range(b):
        keep = valid[qi].nonzero()[:, 0]
        order = keep[torch.argsort(-norm[qi, keep], stable=True)]
        out.scores.append(norm[qi, order].cpu().numpy())
        out.cids.append([trie.cid[int(n)] for n in node[qi, order].cpu()])
    return out, q


@dataclass
class Reranked:
    doc_ids: np.ndarray          # [A, B, R] top docs per α
    fused: np.ndarray            # [A, B, R] their fused scores
    sim: list[dict[int, float]]  # per query: doc → tanh(q·d) of every candidate
    prob: list[dict[int, float]]  # per query: doc → its beam's probability


def rerank(store: torch.Tensor, q: torch.Tensor, beams: Beams,
           cid_to_docs: dict[str, list[int]], alphas, top_r: int) -> Reranked:
    """Every beam's cluster expanded to its documents, each scored
    tanh(q·d) and fused with α × the softmax of the beam scores; the
    ``top_r`` best per α."""
    a_n, b = len(alphas), len(beams.cids)
    doc_ids = np.zeros((a_n, b, top_r), np.int64)
    fused = np.zeros((a_n, b, top_r), np.float32)
    sims, probs = [], []
    alphas_t = torch.tensor(list(alphas), device=store.device)
    for qi in range(b):
        docs, beam_of = [], []
        for j, cid in enumerate(beams.cids[qi]):
            for dd in cid_to_docs["-".join(map(str, cid))]:
                docs.append(dd)
                beam_of.append(j)
        docs_t = torch.as_tensor(docs, device=store.device)
        sim = torch.tanh(store[docs_t].float() @ q[qi].float())
        p = torch.softmax(torch.as_tensor(beams.scores[qi], device=store.device),
                          dim=0)
        pb = p[torch.as_tensor(beam_of, device=store.device)]
        f = sim[None] + alphas_t[:, None] * pb[None]
        k = min(top_r, len(docs))
        val, idx = torch.topk(f, k, dim=1)
        doc_ids[:, qi, :k] = docs_t[idx].cpu().numpy()
        fused[:, qi, :k] = val.cpu().numpy()
        if k < top_r:
            doc_ids[:, qi, k:] = -1
            fused[:, qi, k:] = NEG
        sims.append(dict(zip(docs, sim.double().cpu().numpy().tolist())))
        probs.append(dict(zip(docs, pb.double().cpu().numpy().tolist())))
    return Reranked(doc_ids, fused, sims, probs)


def retrieve(w: dict, cfg: dict, ecfg: dict, store: torch.Tensor, trie: Trie,
             cid_to_docs: dict, ids, mask, max_len: int
             ) -> tuple[Beams, Reranked]:
    """One batch's beams and re-rank, as the served retrieve returns them."""
    beams, q = beam_search(w, cfg, ecfg, ids, mask, trie, max_len)
    return beams, rerank(store, q, beams, cid_to_docs, ecfg["score_rates"],
                         ecfg["num_return_sequences"])
