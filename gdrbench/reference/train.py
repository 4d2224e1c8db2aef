"""Plain float32 training, the yardstick of the training cells: GDR's
stage-1 step (R-Drop over the doubled batch with input dropout, the
candidate-slot CID cross-entropy, the R-Drop Contrast term, the
cluster-adaptive InfoNCE against the store's positives and in-cluster
candidates) with autograd, the global-norm clip and six-group AdamW.

The batches are worked out again from the train set (:func:`batches`,
the sampling of a shuffled epoch iterator), and every random draw of a
step comes, in the order the step makes them, from a generator seeded as
the step's: the input-dropout gate and keep mask, then a keep mask for
each dropout site of the forward pass.  The weights are the benchmark's,
in float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gdrbench.reference import model as M

B1, B2 = 0.9, 0.999


def fold_in(seed: int, index: int) -> int:
    """The step generator's seed: ``seed`` and ``index`` mixed by numpy's
    SeedSequence into 64 bits."""
    return int(np.random.SeedSequence([seed, index])
               .generate_state(1, np.uint64)[0])


def batches(ts: dict, cluster_docs_of, batch: int, cands: int, seed: int,
            count: int) -> list[dict]:
    """The first ``count`` batches of a shuffled epoch: a permutation of
    the train set from ``seed``, and for each row its positive appended
    after up to ``cands`` − 1 other docs of its cluster, shuffled."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ts["pos_idx"]))
    out = []
    for start in range(0, count * batch, batch):
        idx = order[start:start + batch]
        cand_idx = np.zeros((batch, cands), np.int64)
        cand_mask = np.zeros((batch, cands), bool)
        for row, i in enumerate(idx):
            pos = int(ts["pos_idx"][i])
            others = [d for d in cluster_docs_of[pos] if d != pos]
            rng.shuffle(others)
            chosen = others[:cands - 1] + [pos]
            cand_idx[row, :len(chosen)] = chosen
            cand_mask[row, :len(chosen)] = True
        out.append({k: ts[k][idx] for k in ("input_ids", "attn_mask",
                                             "labels", "label_mask",
                                             "pos_idx")}
                   | {"cand_idx": cand_idx, "cand_mask": cand_mask})
    return out


def local_slots(labels: torch.Tensor, kary: int) -> torch.Tensor:
    """Label tokens → candidate slots: digit d of position l → d, EOS →
    kary (pads are masked by the caller)."""
    pos = torch.arange(labels.shape[1], device=labels.device)
    slot = labels.long() - (pos[None] * kary + 2)
    slot = torch.where(labels == 1, kary, slot)
    return slot.clamp(0, kary)


def loss(w: dict, m: dict, t: dict, batch: dict, store: torch.Tensor,
         gen: torch.Generator, rank_gens=None) -> torch.Tensor:
    """The stage-1 objective of one global batch (device tensors).  The
    input-dropout draws come from ``gen`` at the global batch's shape;
    the modules' dropout from ``gen`` too, or, over dp ranks, from each
    rank's generator in ``rank_gens`` over the rank's rows (the batch cut
    in equal slices, each doubled for R-Drop on its rank)."""
    dev = store.device
    bsz = batch["input_ids"].shape[0]
    dp = len(rank_gens) if rank_gens else 1
    b = bsz // dp
    keep_p = 1.0 - m["dropout_rate"]

    def rand(shape, g):
        return torch.rand(shape, generator=g, device=dev)

    keep = None
    if m["input_dropout"] > 0:
        gate = rand((), gen) < m["input_dropout"]
        keep = rand((2 * bsz, batch["input_ids"].shape[1]), gen) < 0.9
    halves, parts = ([], []), []
    for r in range(dp):
        g = rank_gens[r] if rank_gens else gen
        lo, hi = r * b, (r + 1) * b
        ids = torch.cat([batch["input_ids"][lo:hi]] * 2).long()
        attn = torch.cat([batch["attn_mask"][lo:hi]] * 2)
        labels = torch.cat([batch["labels"][lo:hi]] * 2).long()
        lmask = torch.cat([batch["label_mask"][lo:hi]] * 2).float()
        if keep is not None:
            k = torch.cat([keep[lo:hi], keep[bsz + lo:bsz + hi]])
            ids = torch.where(gate & ~k, torch.zeros_like(ids), ids)

        def drop(x, g=g):
            return torch.where(rand(x.shape, g) < keep_p, x / keep_p,
                               torch.zeros_like(x))

        dec_in = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]],
                           1)
        enc = M.encode(w, m, ids, attn, drop)
        hidden = M.decode(w, m, dec_in, enc, attn, self_mask=lmask, drop=drop)
        ada = M.pawa(w, m, dec_in, drop)
        logits = M.sequence_candidate_logits(w, m, hidden, ada)
        lp = torch.log_softmax(logits, -1).gather(
            -1, local_slots(labels, m["kary"])[..., None])[..., 0]
        h = hidden * m["d_model"] ** -0.5
        for half, sl in zip(halves, (slice(0, b), slice(b, 2 * b))):
            half.append((lp[sl], lmask[sl], h[sl]))
        parts.append(M.query_embedding(w, m, enc)[:b])
    rows = halves[0] + halves[1]           # the global twin layout [x; x']
    lp = torch.cat([r[0] for r in rows])
    lmask = torch.cat([r[1] for r in rows])
    h = torch.cat([r[2] for r in rows])
    ce = -(lp * lmask).sum() / lmask.sum().clamp_min(1.0)

    n2 = h.shape[0]                                        # R-Drop Contrast
    sims = torch.einsum("bld,cld->lbc", h, h)
    eye = torch.eye(n2, dtype=torch.bool, device=dev)[None]
    sims = torch.where(eye, torch.full_like(sims, -1e9), sims)
    idx = torch.arange(n2, device=dev)
    picked = torch.log_softmax(sims, -1)[:, idx, (idx + n2 // 2) % n2]
    lm = lmask.t()
    rdrop = -(picked * lm).sum() / lm.sum().clamp_min(1.0)

    q = torch.cat(parts)                                   # cluster InfoNCE
    pos = store[batch["pos_idx"].long()].float()
    cand = store[batch["cand_idx"].long()].float()
    tau = t["tau"]
    pos_sim = torch.tanh((q * pos).sum(-1))
    e = torch.exp(torch.tanh(torch.einsum("bd,jcd->bjc", q, cand)) / tau)
    e = torch.where(batch["cand_mask"].bool()[None], e, torch.zeros_like(e))
    own = torch.eye(bsz, dtype=torch.bool, device=dev)[:, :, None]
    intra = torch.where(own, e, torch.zeros_like(e)).sum((1, 2))
    inter = torch.where(own, torch.zeros_like(e), e).sum((1, 2))
    contrast = (-pos_sim / tau + torch.log(
        (t["intra_rate"] * intra + inter).clamp_min(1e-30))).mean()
    return ce + m["rdrop"] * rdrop + contrast


def no_decay(name: str, shape) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("bias", "scale") or (leaf == "weight" and len(shape) == 1)


def learning_rate(t: dict, peak: float, count: int) -> float:
    """Linear decay from ``peak`` over ``total_steps`` (no warmup), read
    at the update count before the step, in float32."""
    f = np.float32
    frac = max(f(0.0), (f(t["total_steps"]) - f(count))
               / f(max(t["total_steps"], 1)))
    return float(f(peak) * frac)


def adamw(w: dict, grads: dict, mu: dict, nu: dict, count: int, t: dict
          ) -> None:
    """Clip the gradients to ``max_grad_norm`` by their global norm, then
    AdamW per group (T5 encoder and shared embeddings at
    ``learning_rate``, the rest at ``decoder_learning_rate``; no decay on
    biases and norm scales), in place."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    factor = 1.0 if norm < t["max_grad_norm"] else t["max_grad_norm"] / norm
    c1 = count + 1
    bc1 = 1.0 - B1 ** c1
    bc2 = 1.0 - B2 ** c1
    with torch.no_grad():
        for n, p in w.items():
            g = grads[n] * float(factor)
            mu[n] = B1 * mu[n] + (1 - B1) * g
            nu[n] = B2 * nu[n] + (1 - B2) * g * g
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + t["adam_epsilon"])
            enc = n.startswith(("shared.", "encoder."))
            peak = t["learning_rate"] if enc else t["decoder_learning_rate"]
            if not no_decay(n, p.shape):
                u = u + t["weight_decay"] * p
            p -= learning_rate(t, peak, count) * u


def train(w0: dict, m: dict, t: dict, batch_list: list[dict],
          store: torch.Tensor, seed: int, dp: int = 1) -> dict:
    """Steps 0, 1, … over ``batch_list`` from the weights ``w0`` (a dict of
    float32 tensors, updated in place): each step's loss, the first
    step's gradient as the optimiser takes it (clipped) per leaf norm, and
    each leaf's norm of its change after the last step.  ``dp`` > 1: the
    modules' dropout of dp rank r draws from the seed folded with r."""
    dev = store.device
    start = {n: p.detach().clone() for n, p in w0.items()}
    w = {n: p.detach().requires_grad_(True) for n, p in w0.items()}
    mu = {n: torch.zeros_like(p) for n, p in w.items()}
    nu = {n: torch.zeros_like(p) for n, p in w.items()}
    losses, first = [], {}
    for step, host in enumerate(batch_list):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        gen = torch.Generator(device=dev).manual_seed(fold_in(seed, step))
        ranks = None if dp == 1 else [
            torch.Generator(device=dev).manual_seed(
                fold_in(fold_in(seed, r), step)) for r in range(dp)]
        total = loss(w, m, t, batch, store, gen, ranks)
        grads = torch.autograd.grad(total, list(w.values()),
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(w[n])).detach()
                 for n, g in zip(w, grads)}
        losses.append(float(total.detach()))
        adamw(w, grads, mu, nu, step, t)
        if step == 0:
            first = {n: M.l2_norm(mu[n] / (1 - B1)) for n in w}
        del grads, total
    delta = {n: M.l2_norm(w[n].detach() - start[n]) for n in w}
    return {"losses": losses, "grad_norms": first, "delta_norms": delta}


@contextlib.contextmanager
def computed_in(dtype):
    """Within the block every value that a program computing in ``dtype``
    would hold in it (``model.ROUND``'s sites) is rounded to ``dtype``,
    per tensor scaled to its range, the gradient passed straight through:
    the reference one precision below its configuration, the control of
    the comparison."""
    prev = M.ROUND

    def rnd(x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = amax / torch.finfo(dtype).max
        q = (x.detach() / scale).to(dtype).float() * scale
        return x + (q - x.detach())
    M.ROUND = rnd
    try:
        yield
    finally:
        M.ROUND = prev
