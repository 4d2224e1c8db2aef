"""AdamW over six parameter groups, mirroring ``gdr_tpu/train/optimizer.py``
(an ``optax.chain(clip_by_global_norm, multi_transform(adamw × 6))``, inside
``optax.MultiSteps`` when gradients accumulate).

The groups are {T5 encoder + shared embeddings, the decoder side, the doc
tower} × {decay, no decay}: no decay on biases and norm scales (T5's
RMSNorm ``scale``, the 1-D ``weight`` of a LayerNorm).  Each has its peak
learning rate (``learning_rate`` / ``decoder_learning_rate`` /
``doc_encoder_learning_rate``) under one schedule, linear (with warmup) or
``((T − x − 0.95) / T) ** 0.1``.

The arithmetic is optax's, on f32 tensors updated in place:

- one global-norm clip over all groups first: g ← g / ‖g‖ · max when
  ‖g‖ ≥ max (optax's rule, not ``clip_grad_norm_``'s max / (‖g‖ + 1e-6));
- Adam moments m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², bias-corrected
  with the count after the increment: u = m̂ / (√v̂ + ε);
- weight decay on the pre-update parameter, u ← u + wd·p;
- p ← p − lr(count)·u, the schedule read at the count before the
  increment;
- with ``gradient_accumulation_steps`` k > 1, the running mean of k
  micro-batches' gradients (Welford, as ``MultiSteps``) is applied every
  k-th call, and only those calls advance the count.

**Over a mesh** (``update(mesh=, cut=)``).  The masters, moments and
gradients of the leaves that ``parallel/mesh.py::tp_param_rules`` selects
(the keys in ``cut``) are this rank's mp part only, as ``gdr_tpu`` places
its params and ``opt_state`` over ``mp``: the column-parallel step
(``train/trainer.py``) computes only the part's gradient, summed over dp.
The clip's global norm is Σ‖part‖² over the cut leaves summed over the mp
row, plus the whole leaves' squares counted once (the same bits on every
rank of the row), so every rank agrees on it.  AdamW is elementwise, so
the parts compute ``gdr_tpu``'s update with nothing cut here.
"""

from __future__ import annotations

import numpy as np
import torch

from gdr_tpu_torch.config import TrainConfig

B1, B2 = 0.9, 0.999
GROUPS = ("enc_wd", "enc_nd", "dec_wd", "dec_nd", "doc_wd", "doc_nd")


def _is_no_decay(name: str, p: torch.Tensor) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("bias", "scale") or (leaf == "weight" and p.dim() == 1)


def param_labels(params: dict[str, dict[str, torch.Tensor]]
                 ) -> dict[str, str]:
    """The group of every parameter: keys ``generator/<name>`` and
    ``doc_encoder/<name>`` of the ``{"generator": ..., "doc_encoder": ...}``
    parameter dicts → one of :data:`GROUPS`."""
    labels = {}
    for tower, named in params.items():
        for name, p in named.items():
            if tower == "doc_encoder":
                g = "doc"
            else:
                g = "enc" if name.startswith(("shared.", "encoder.")) else "dec"
            labels[f"{tower}/{name}"] = \
                f"{g}_{'nd' if _is_no_decay(name, p) else 'wd'}"
    return labels


def flat(params: dict[str, dict[str, torch.Tensor]]
         ) -> dict[str, torch.Tensor]:
    return {f"{tower}/{name}": t for tower, named in params.items()
            for name, t in named.items()}


def learning_rate(cfg: TrainConfig, total: int, peak: float,
                  count: int) -> float:
    """The schedule at optimizer count ``count``, in f32 as the reference
    computes it."""
    f32 = np.float32
    step = f32(count)
    if cfg.scheduler == "linear":
        warmup = cfg.warmup_steps
        warm = step / f32(warmup) if warmup > 0 else f32(1.0)
        decay = max(f32(0.0), (f32(total) - step) / f32(max(total - warmup, 1)))
        return float(f32(peak) * (warm if step < warmup else decay))
    frac = max((f32(total) - step - f32(0.95)) / f32(total), f32(1e-6))
    return float(f32(peak) * frac ** f32(0.1))


def global_norm(tensors, mesh=None, cut=None) -> torch.Tensor:
    """sqrt(Σ Σ x²) over all tensors, f32, on their device.  ``mesh``,
    ``cut`` (a flag per tensor): the tensors flagged are this rank's mp
    parts, whose squares are summed over the mp row."""
    norms = torch._foreach_norm(list(tensors))
    if mesh is None or not any(cut or ()):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).square()
    flags = torch.as_tensor(cut, device=sq.device)
    parts = mesh.sum_mp(sq[flags].sum())
    return torch.sqrt(sq[~flags].sum() + parts)


class GroupedAdamW:
    """The six-group AdamW of :mod:`gdr_tpu_torch.train.optimizer`.
    ``labels``: flat parameter key → group (:func:`param_labels`);
    ``total_steps``: the schedule's horizon in optimizer updates."""

    def __init__(self, cfg: TrainConfig, labels: dict[str, str],
                 total_steps: int):
        self.cfg = cfg
        self.labels = labels
        self.total = total_steps
        peaks = {"enc": cfg.learning_rate, "dec": cfg.decoder_learning_rate,
                 "doc": cfg.doc_encoder_learning_rate}
        self.hyper = {g: (peaks[g[:3]],
                          cfg.weight_decay if g.endswith("wd") else 0.0)
                      for g in GROUPS}

    def init(self, params: dict[str, dict[str, torch.Tensor]]) -> dict:
        """Zero moments (and accumulator) shaped as the f32 parameters."""
        f = flat(params)
        state = {"count": 0, "mini_step": 0,
                 "mu": {k: torch.zeros_like(t) for k, t in f.items()},
                 "nu": {k: torch.zeros_like(t) for k, t in f.items()},
                 "acc": None}
        if self.cfg.gradient_accumulation_steps > 1:
            state["acc"] = {k: torch.zeros_like(t) for k, t in f.items()}
        return state

    @torch.no_grad()
    def update(self, params: dict[str, dict[str, torch.Tensor]],
               grads: dict[str, torch.Tensor], state: dict,
               mesh=None, cut=frozenset()) -> bool:
        """One call per micro-batch: ``grads`` (flat keys, f32) update
        ``params`` and ``state`` in place.  Returns whether the parameters
        changed (always, unless this call only accumulated).  ``mesh``,
        ``cut``: the flat keys whose parameter and gradient are this rank's
        mp part (:func:`global_norm`)."""
        f = flat(params)
        keys = list(f)
        g = [grads[k] for k in keys]
        k_steps = self.cfg.gradient_accumulation_steps
        if k_steps > 1:
            acc = [state["acc"][k] for k in keys]
            n = state["mini_step"]
            # acc + (g − acc) / (n + 1): the running mean of the micro-batches
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(g, acc), float(n + 1)))
            state["mini_step"] = (n + 1) % k_steps
            if n != k_steps - 1:
                return False
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        norm = (global_norm(g, mesh, [k in cut for k in keys]) if cut
                else global_norm(g))
        max_norm = self.cfg.max_grad_norm
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        torch._foreach_mul_(g, factor)

        count = state["count"]
        for group in GROUPS:
            idx = [i for i, k in enumerate(keys) if self.labels[k] == group]
            if not idx:
                continue
            peak, wd = self.hyper[group]
            adamw_update([f[keys[i]] for i in idx], [g[i] for i in idx],
                         [state["mu"][keys[i]] for i in idx],
                         [state["nu"][keys[i]] for i in idx], count,
                         learning_rate(self.cfg, self.total, peak, count), wd,
                         self.cfg.adam_epsilon)
        state["count"] = count + 1
        return True


def adamw_update(p, g, mu, nu, count: int, lr: float, wd: float,
                 eps: float = 1e-8) -> None:
    """optax's AdamW on lists of f32 tensors, in place: the moments, bias
    correction with the count after its increment, weight decay on the
    pre-update parameter, ``p -= lr · u``."""
    c1 = count + 1
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(c1))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(c1))
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, g, alpha=1 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, g, g, value=1 - B2)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    if wd:
        torch._foreach_add_(upd, p, alpha=wd)
    torch._foreach_add_(p, upd, alpha=-lr)


# optax.adamw's default weight decay: ``optax.adamw(lr)`` decays too
OPTAX_ADAMW_WD = 1e-4


class AdamW:
    """``optax.adamw`` at constant learning rates over named groups of a
    module's parameters, optionally after one global-norm clip over all of
    them (``optax.chain(clip_by_global_norm, multi_transform(...))``).
    ``hyper``: group → (lr, weight decay); ``labels``: parameter name →
    group.  The secondary modes and query generation train with it, on the
    module's own f32 parameters, updated in place."""

    def __init__(self, module: torch.nn.Module, hyper: dict[str, tuple],
                 labels: dict[str, str] | None = None,
                 max_grad_norm: float | None = None):
        self.params = dict(module.named_parameters())
        self.labels = labels or dict.fromkeys(self.params, "all")
        self.hyper = hyper
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply the gradients the last backward left in ``.grad`` (zeros
        where a parameter got none) and clear them.  Returns their global
        norm before the clip."""
        keys = list(self.params)
        g = [self.params[k].grad if self.params[k].grad is not None
             else torch.zeros_like(self.params[k]) for k in keys]
        g = [x.float() for x in g]
        norm = global_norm(g)
        if self.max_grad_norm is not None:
            torch._foreach_mul_(g, torch.where(
                norm < self.max_grad_norm, torch.ones_like(norm),
                self.max_grad_norm / norm))
        for group, (lr, wd) in self.hyper.items():
            idx = [i for i, k in enumerate(keys) if self.labels[k] == group]
            if idx:
                adamw_update([self.params[keys[i]] for i in idx],
                             [g[i] for i in idx],
                             [self.mu[keys[i]] for i in idx],
                             [self.nu[keys[i]] for i in idx], self.count,
                             lr, wd)
        self.count += 1
        for p in self.params.values():
            p.grad = None
        return norm


def build_optimizer(cfg: TrainConfig, params: dict[str, dict[str, torch.Tensor]],
                    total_steps: int) -> tuple[GroupedAdamW, dict[str, str]]:
    """(optimizer, labels) for the ``{"generator": ..., "doc_encoder":
    ...}`` parameter dicts."""
    labels = param_labels(params)
    return GroupedAdamW(cfg, labels, total_steps), labels
