"""The column-parallel step over a mesh's mp row, in one process: the mp
row's ranks are threads that exchange through shared slots
(:class:`ThreadRow`, the port's ``Mesh`` with its collectives replaced;
its sums run in rank order, so every rank gets the same bits, as from an
all-reduce).

- each mp Function of ``parallel/autograd.py`` (and the products built
  from them) at mp 2 and 4 against the one-process op, forward and
  backward;
- the leaves that ``tp_param_rules`` selects and each rank's part of them
  against ``gdr_tpu``'s placement: its rule on the flax tree, the flax
  leaf's columns, bridged by ``params_from_flax``;
- the mesh train step at mp 2 and 4 against the same step over a row of
  one rank, whose draws are the same (stage 1 and 2 with every loss on,
  gradient accumulation, the slow PAWA head with an untied lm-head, module
  dropout on): metrics,
  the masters after each step, the replicated masters bit-equal over the
  row after every step;
- a rank's modules and gradients hold only its parts in the step;
- the products of the model's forward and backward at mp = m are 1/m of
  one process's FLOPs (``torch.utils.flop_counter.FlopCounterMode``).
"""

import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from chip_smoke import KEY_BIAS_GRAD_TOL, NOISE_ONLY, _small_train_world
from gdr_tpu.config import tiny_config as jax_tiny_config
from gdr_tpu.models.dual_encoder import tiny_doc_encoder as jax_tiny_doc
from gdr_tpu.models.gdr import GenerativeRetriever as JaxRetriever
from gdr_tpu.models.gdr import init_params
from gdr_tpu.parallel.mesh import tp_param_rules as jax_tp_param_rules
from gdr_tpu_torch.convert import (doc_encoder_params_from_flax,
                                   params_from_flax)
from gdr_tpu_torch.data.dataset import (BatchIterator, cluster_docs_lookup,
                                        doc_label_arrays)
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, init_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.models.gdr import GenerativeRetriever, init_weights
from gdr_tpu_torch.ops.trie import prefix_node_embeddings
from gdr_tpu_torch.parallel import autograd as mpa
from gdr_tpu_torch.parallel.mesh import (Cut, Mesh, mp_slice, shard_params,
                                         tp_param_rules)
from gdr_tpu_torch.parallel.store import place_store
from gdr_tpu_torch.train.trainer import (compute_grads, init_train_state,
                                         load_masters, make_loss_fn,
                                         make_train_step, shard_state)

CPU = torch.device("cpu")
MPS = [2, 4]
FN_TOL = 1e-6                # the mp Functions vs the one-process op (f32)
LOSS_TOL = 1e-5              # each step's metrics, relative
MASTER_TOL = 1e-5            # f32 masters after each step, absolute
GRAD_TOL = 1e-5              # gradients, relative to the leaf's largest
STEPS = 3


class ThreadRow(Mesh):
    """Rank ``rank`` of an mp row of ``n`` (dp = 1) simulated by a thread:
    ``Mesh``'s gathers and sums over slots shared by the row's threads."""

    def __init__(self, n: int, rank: int, shared: dict):
        super().__init__(dp=1, mp=n, rank=rank, world=n, device=CPU,
                         comm_device=CPU)
        self.shared = shared

    def _exchange(self, t):
        self.shared["slots"][self.rank] = t.detach().clone()
        self.shared["barrier"].wait()
        out = list(self.shared["slots"])
        self.shared["barrier"].wait()
        return out

    def _gather(self, t, axis, dim):
        if self._size(axis) == 1:
            return t
        return torch.cat(self._exchange(t), dim=dim)

    def _sum(self, t, axis):
        if self._size(axis) == 1:
            return t
        parts = self._exchange(t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    def any_rank(self, flag):
        return any(bool(x) for x in self._exchange(torch.tensor(flag)))

    def barrier(self):
        self._exchange(torch.zeros(()))


def run_row(n: int, fn):
    """``fn(mesh)`` in each of ``n`` threads, one per rank: their results
    in rank order (the first exception is raised)."""
    shared = {"slots": [None] * n,
              "barrier": threading.Barrier(n, timeout=120)}
    out, errs = [None] * n, []

    def work(r):
        try:
            out[r] = fn(ThreadRow(n, r, shared))
        except BaseException as e:          # noqa: BLE001
            errs.append(e)
            shared["barrier"].abort()
    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errs if not isinstance(e, threading.BrokenBarrierError)]
    if real or errs:
        raise (real or errs)[0]
    return out


def _fake(mp: int, rank: int) -> Mesh:
    return Mesh(dp=1, mp=mp, rank=rank, world=mp, device=CPU,
                comm_device=CPU)


# ---------------------------------------------------------- mp Functions

def _randn(g, *shape):
    """N(0, 1/16) in f32: the products stay near 1, where an absolute
    tolerance is an f32 rounding one."""
    return torch.randn(*shape, generator=g, dtype=torch.float32) * 0.25


def _fn_case(name: str, n: int):
    """(one-process (value, grads), per-rank fn → (value, grads)) of one mp
    Function or product: grads of the rank's own leaves, compared with the
    one-process grads cut as the rank holds them."""
    g = torch.Generator().manual_seed(n)
    x, w = _randn(g, 5, 4 * n * 3), _randn(g, 5, 4 * n * 3)
    ws = [_randn(g, 5, 4 * n * 3) for _ in range(n)]
    lin, v = _randn(g, 6 * n, 4 * n * 3), _randn(g, 4 * n * 3, 7)
    blocks = 3 if name == "gather_from_mp_blocks" else 1
    cut = Cut(-1, blocks)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    if name == "copy_to_mp":
        def one():
            xx = leaf(x)
            sum((xx * wr).sum() for wr in ws).backward()
            return xx.detach(), [xx.grad]

        def rank(m):
            xx = leaf(x)
            y = mpa.copy_to_mp(xx, m)
            (y * ws[m.mp_rank]).sum().backward()
            return y.detach(), [xx.grad]
    elif name.startswith("gather_from_mp"):
        def one():
            xx = leaf(x)
            (xx * w).sum().backward()
            return xx.detach(), [xx.grad]

        def rank(m):
            xx = leaf(mp_slice(x, m, cut))
            y = mpa.gather_from_mp(xx, m, -1, blocks)
            (y * w).sum().backward()
            return y.detach(), [xx.grad, mp_slice(w, m, cut)]
    elif name == "reduce_from_mp":
        def one():
            parts = [leaf(wr) for wr in ws]
            y = sum(parts)
            (y * w).sum().backward()
            return y.detach(), [p.grad for p in parts]

        def rank(m):
            xx = leaf(ws[m.mp_rank])
            y = mpa.reduce_from_mp(xx, m)
            (y * w).sum().backward()
            return y.detach(), [xx.grad]
    elif name == "column_linear":
        def one():
            xx, ww = leaf(x), leaf(lin)
            y = F.linear(xx, ww)
            (y * _randn(torch.Generator().manual_seed(9), 5, 6 * n)
             ).sum().backward()
            return y.detach(), [xx.grad, ww.grad]

        def rank(m):
            xx, ww = leaf(x), leaf(mp_slice(lin, m, Cut(0)))
            y = mpa.column_linear(xx, ww, m)
            (y * _randn(torch.Generator().manual_seed(9), 5, 6 * n)
             ).sum().backward()
            return y.detach(), [xx.grad, ww.grad]
    else:                                   # mp_part: a cut contraction
        def one():
            xx, vv = leaf(x), leaf(v)
            y = xx @ vv
            (y * _randn(torch.Generator().manual_seed(9), 5, 7)
             ).sum().backward()
            return y.detach(), [xx.grad, vv.grad]

        def rank(m):
            xx, vv = leaf(x), leaf(mp_slice(v, m, Cut(0)))
            y = mpa.reduce_from_mp(mpa.mp_part(xx, m) @ vv, m)
            (y * _randn(torch.Generator().manual_seed(9), 5, 7)
             ).sum().backward()
            return y.detach(), [xx.grad, vv.grad]
    return one, rank


def _cut_like(name, m, want):
    """The one-process grads as rank ``m`` holds them."""
    if name == "reduce_from_mp":
        return [want[m.mp_rank]]
    if name == "column_linear":
        return [want[0], mp_slice(want[1], m, Cut(0))]
    if name == "mp_part":
        return [want[0], mp_slice(want[1], m, Cut(0))]
    if name.startswith("gather_from_mp"):
        return [want[0]]
    return want


FNS = ["copy_to_mp", "gather_from_mp", "gather_from_mp_blocks",
       "reduce_from_mp", "column_linear", "mp_part"]


@pytest.mark.parametrize("n", MPS)
@pytest.mark.parametrize("name", FNS)
def test_mp_function_matches_the_one_process_op(name, n):
    one, rank = _fn_case(name, n)
    want_y, want_g = one()

    def check(m):
        y, grads = rank(m)
        assert y.shape == want_y.shape
        assert float((y - want_y).abs().max()) <= FN_TOL, name
        if name.startswith("gather_from_mp"):   # its grad: w's part
            want = [grads[1]]
            grads = grads[:1]
        else:
            want = _cut_like(name, m, want_g)
        for a, b in zip(grads, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= FN_TOL, name
        return True
    assert all(run_row(n, check))


# --------------------------------------------------- placement vs gdr_tpu

TP_MIN = [64, 256]
TREES = {"default": {}, "slow-pawa": dict(adaptor_efficient=False),
         "denoise-untied-fusion": dict(denoising=True,
                                       tie_decode_embedding=False,
                                       concate_fusion=True)}


@functools.lru_cache(maxsize=None)
def _flax_tree(kind: str):
    """(gdr_tpu's flax tree of a tiny model or doc tower, its heads)."""
    if kind == "doc":
        enc = jax_tiny_doc(32)
        ids = np.zeros((2, 8), np.int32)
        params = enc.init(jax.random.PRNGKey(1), ids, np.ones_like(ids))
        return jax.tree_util.tree_map(np.asarray, params), enc.num_heads
    jcfg = dataclasses.replace(jax_tiny_config().model, **TREES[kind])
    tree = init_params(JaxRetriever(jcfg), jax.random.PRNGKey(2))
    return jax.tree_util.tree_map(np.asarray, tree), 0


def _gdr_tpu_part(tree, mp: int, rank: int, min_size: int):
    """gdr_tpu's placement of ``tree`` over mp: each leaf its rule puts on
    "mp" cut to rank ``rank``'s columns of its last axis."""
    rule = jax_tp_param_rules(mp=mp, min_size=min_size)

    def part(path, leaf):
        if "mp" not in tuple(rule(path, leaf)):
            return leaf
        c = leaf.shape[-1] // mp
        return leaf[..., rank * c:(rank + 1) * c]
    return jax.tree_util.tree_map_with_path(part, tree)


@pytest.mark.parametrize("min_size", TP_MIN)
@pytest.mark.parametrize("n", MPS)
@pytest.mark.parametrize("kind", list(TREES) + ["doc"])
def test_placement_equals_gdr_tpu(kind, n, min_size):
    tree, heads = _flax_tree(kind)
    bridge = doc_encoder_params_from_flax if kind == "doc" \
        else params_from_flax
    tower = "doc_encoder" if kind == "doc" else "generator"
    whole = bridge(tree)
    rule = tp_param_rules(n, min_size, doc_heads=heads)
    picked = set()
    for r in range(n):
        want = bridge(_gdr_tpu_part(tree, n, r, min_size))
        got, cuts = shard_params({tower: whole}, _fake(n, r), rule)
        assert got[tower].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[tower][k], v), (k, r)
        picked = {k.split("/", 1)[1] for k in cuts}
        assert picked == {k for k in want if want[k].shape != whole[k].shape}
    assert picked, "no leaf was cut"


def test_placement_cuts_the_output_axis():
    """Spot checks on the port's tensors: a Linear weight [out, in] on
    dim 0, the fused qkv by heads in each of q, k and v, an embedding and
    U on their last dim."""
    rule = tp_param_rules(2, 64)
    lin = torch.zeros(64, 32)
    assert rule("generator/encoder.blocks.0.ff.wi.weight", lin) == Cut(0)
    assert rule("generator/encoder.blocks.0.attn.qkv.weight",
                torch.zeros(96, 32)) == Cut(0, 3)
    assert rule("generator/shared.weight", torch.zeros(128, 32)) == Cut(1)
    assert rule("generator/pawa.u", torch.zeros(32, 17, 32)) == Cut(2)
    assert rule("generator/encoder.final_norm.scale", torch.zeros(32)) is None
    # flax [32, 3]: its last axis (the Linear's 3 outputs) does not divide
    assert rule("generator/head.weight", torch.zeros(3, 32)) is None
    q = torch.arange(8 * 4.0).reshape(8, 4)        # 2 heads of dh 4
    heads = tp_param_rules(2, 8, doc_heads=2)
    cut = heads("doc_encoder/blocks.0.attn.query.weight", q)
    assert cut == Cut(0, 2)
    assert torch.equal(mp_slice(q, _fake(2, 1), cut), q[[2, 3, 6, 7]])


# ------------------------------------------------------ the mesh step

def _world(kind: str, tp_min: int):
    """(cfg, index, train set, doc tokens, doc mask): the small f32 world
    with every loss on (``chip_smoke.py``'s) at module dropout 0.1, with
    two micro-batches an update, or its slow-PAWA variant with an untied
    lm-head; leaves of ``tp_min``+ elements are cut."""
    cfg, index, ts, _, dtok, dmask = _small_train_world(1, 0.1)
    if kind == "accum":
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, gradient_accumulation_steps=2))
    model = cfg.model
    if kind == "slow-pawa":
        model = dataclasses.replace(model, adaptor_efficient=False,
                                    tie_decode_embedding=False,
                                    weight_distillation=0.0)
    cfg = cfg.replace(model=model, mesh=dataclasses.replace(
        cfg.mesh, tp_min_size=tp_min))
    return cfg, index, ts, dtok, dmask


def _models(cfg, tower: bool):
    model = GenerativeRetriever(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    doc = None
    if tower:
        doc = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
        init_doc_encoder(doc, torch.Generator().manual_seed(1))
    return model, doc


def _batches(cfg, index, ts, dtok, dmask, stage: int, n: int) -> list:
    """The loop's first ``n`` batches of ``stage`` (train/loop.py)."""
    dl, dm = doc_label_arrays(index.paths, cfg.model)
    it = BatchIterator(ts, cluster_docs_lookup(index.cid_of_doc),
                       cfg.train.train_batch_size,
                       cfg.data.max_intraclass_num, seed=0,
                       sample_neg_num=cfg.data.sample_neg_num,
                       doc_labels=dl, doc_label_mask=dm)
    out = []
    for batch in it:
        if stage == 2:
            batch = dict(batch, pos_tokens=dtok[batch["pos_idx"]],
                         pos_tok_mask=dmask[batch["pos_idx"]],
                         cand_tokens=dtok[batch["cand_idx"]],
                         cand_tok_mask=dmask[batch["cand_idx"]])
        if cfg.model.weight_distillation > 0:
            pe, pm = prefix_node_embeddings(
                index.trie, batch["labels"], batch["label_mask"],
                cfg.model.kary, cfg.model.position)
            batch = dict(batch, prefix_emb=pe, prefix_emb_mask=pm)
        out.append(batch)
        if len(out) == n:
            return out
    return out


def _flat_masters(state) -> dict:
    return {f"{t}/{k}": v.detach().clone() for t, d in state.params.items()
            for k, v in d.items()}


def _run_steps(cfg, index, ts, dtok, dmask, stage: int, mesh) -> dict:
    """``STEPS`` steps of the mesh train step over ``mesh``'s row (a row of
    one: the reference, whose draws are the mesh step's): each step's
    metrics and masters."""
    model, doc = _models(cfg, tower=stage == 2)
    state, opt = init_train_state(cfg, model, doc, total_steps=100)
    rule = tp_param_rules(mesh.mp, cfg.mesh.tp_min_size,
                          doc_heads=doc.cfg.num_heads if doc else 0)
    state = shard_state(state, mesh, rule)
    load_masters(state, model, doc)
    step = make_train_step(model, doc, opt, cfg, stage=stage, mesh=mesh)
    store = place_store(index.store, mesh, CPU)
    rec = {"metrics": [], "masters": [], "cuts": dict(state.cuts)}
    for batch in _batches(cfg, index, ts, dtok, dmask, stage, STEPS):
        state, m = step(state, batch, store, 5)
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["masters"].append(_flat_masters(state))
    return rec


WORLDS = {"every-loss-stage1": ("every-loss", 1),
          "every-loss-stage2": ("every-loss", 2),
          "grad-accumulation": ("accum", 1),
          "slow-pawa-untied": ("slow-pawa", 1)}


@functools.lru_cache(maxsize=None)
def _step_runs(world: str, n: int):
    kind, stage = WORLDS[world]
    args = _world(kind, 64)
    one, = run_row(1, lambda m: _run_steps(*args, stage, m))
    ranks = run_row(n, lambda m: _run_steps(*args, stage, m))
    return one, ranks


def _part(want: torch.Tensor, cut, mesh) -> torch.Tensor:
    return want if cut is None else mp_slice(want, mesh, cut)


@pytest.mark.parametrize("n", MPS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_step_matches_one_process(world, n):
    one, ranks = _step_runs(world, n)
    assert ranks[0]["cuts"], "no leaf was cut"
    for r, rk in enumerate(ranks):
        m = _fake(n, r)
        for got, want in zip(rk["metrics"], one["metrics"]):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=LOSS_TOL,
                                               abs=1e-7), (k, r)
        assert len(rk["masters"]) == STEPS
        for got, want in zip(rk["masters"], one["masters"]):
            for k, v in want.items():
                ref = _part(v, rk["cuts"].get(k), m)
                assert got[k].shape == ref.shape, k
                if k.endswith(NOISE_ONLY):
                    # a zero gradient's rounding noise, which Adam scales
                    # to steps of up to ±lr (chip_smoke.py's NOISE_ONLY)
                    continue
                err = float((got[k] - ref).abs().max())
                assert err <= MASTER_TOL, (k, r, err)


@pytest.mark.parametrize("n", MPS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_replicated_masters_bit_equal_over_the_row(world, n):
    _, ranks = _step_runs(world, n)
    cuts = ranks[0]["cuts"]
    for s in range(STEPS):
        first = ranks[0]["masters"][s]
        assert any(k not in cuts for k in first)
        for rk in ranks[1:]:
            for k, v in first.items():
                if k not in cuts:
                    assert torch.equal(rk["masters"][s][k], v), (k, s)


def _grads_of(cfg, index, ts, dtok, dmask, stage, mesh=None):
    """One ``compute_grads`` of the first batch: (metrics, gradients, the
    modules' parameter shapes in the step, cuts)."""
    model, doc = _models(cfg, tower=stage == 2)
    state, _ = init_train_state(cfg, model, doc, total_steps=100)
    cuts = {}
    if mesh is not None:
        rule = tp_param_rules(mesh.mp, cfg.mesh.tp_min_size,
                              doc_heads=doc.cfg.num_heads if doc else 0)
        state = shard_state(state, mesh, rule)
        load_masters(state, model, doc)
        cuts = state.cuts
    batch = _batches(cfg, index, ts, dtok, dmask, stage, 1)[0]
    loss_fn = make_loss_fn(model, doc, cfg, stage)
    store = torch.as_tensor(index.store)
    dev = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    shapes = {}

    def loss(*a):
        for t, mod in (("generator", model), ("doc_encoder", doc)):
            if mod is not None:
                shapes.update({f"{t}/{k}": tuple(p.shape)
                               for k, p in mod.named_parameters()})
        return loss_fn(*a)
    metrics, grads = compute_grads(model, doc, loss, dev, store, gen,
                                   dropout_gen=torch.Generator()
                                   .manual_seed(4), mp=mesh)
    return metrics, grads, shapes, cuts


@pytest.mark.parametrize("n", MPS)
def test_rank_holds_and_computes_only_its_parts(n):
    args = _world("every-loss", 64)
    _, want, whole, _ = _grads_of(*args, 2)

    def rank(m):
        return _grads_of(*args, 2, mesh=m)
    for r, (_, grads, shapes, cuts) in enumerate(run_row(n, rank)):
        m = _fake(n, r)
        assert cuts and any(k.startswith("doc_encoder/") for k in cuts)
        for k, g in want.items():
            cut = cuts.get(k)
            ref = _part(g, cut, m)
            part = tuple(ref.shape)
            assert shapes[k] == part and tuple(grads[k].shape) == part, k
            if cut is not None:
                assert part != tuple(whole[k]), k
            err = float((grads[k] - ref).abs().max())
            if k.endswith(NOISE_ONLY):
                # zero but for rounding noise on both sides: at rounding
                # level of the same block's key weight (chip_smoke.py)
                key = want[k[:-len("bias")] + "weight"]
                assert err <= KEY_BIAS_GRAD_TOL * float(key.abs().max()), k
                continue
            assert err <= GRAD_TOL * float(g.abs().max()), (k, err)


def _flop_world():
    """A tiny retriever whose heads (T5's and PAWA's) divide over 2 and 4
    and whose every 2-D leaf is cut: every product of its forward and
    backward is over a cut leaf or a rank's heads."""
    from gdr_tpu_torch.config import tiny_config
    cfg = tiny_config(kary=4, max_output_length=4, d_model=32,
                      embedding_dim=16)
    model = dataclasses.replace(cfg.model, num_heads=4, d_kv=8,
                                adaptor_num_heads=4, dropout_rate=0.0)
    return cfg.replace(model=model, mesh=dataclasses.replace(
        cfg.mesh, tp_min_size=1))


def _model_flops(cfg, mesh=None) -> int:
    """FLOPs of the model's forward and backward in ``compute_grads`` on a
    seeded batch (its outputs weighted elementwise, so that nothing
    outside the model takes a product)."""
    model, _ = _models(cfg, tower=False)
    state, _ = init_train_state(cfg, model, None, total_steps=10)
    if mesh is not None:
        state = shard_state(state, mesh,
                            tp_param_rules(mesh.mp, cfg.mesh.tp_min_size))
        load_masters(state, model)
        assert len(state.cuts) == sum(p.dim() >= 2 for p in
                                      state.params["generator"].values())
    rng = np.random.default_rng(0)
    b, s, l = 4, 8, cfg.model.max_output_length
    ids = torch.as_tensor(rng.integers(2, cfg.model.vocab_size, (b, s)))
    labels = torch.as_tensor(rng.integers(2, 10, (b, l)))
    batch = {"input_ids": ids, "attn_mask": torch.ones_like(ids),
             "labels": labels, "label_mask": torch.ones_like(labels)}
    weights = {}

    def loss_fn(batch, *_):
        out = model(batch["input_ids"], batch["attn_mask"],
                    batch["labels"], batch["label_mask"], sliced_head=True)
        total = 0
        for k in sorted(out):
            g = torch.Generator().manual_seed(len(weights))
            w = weights.setdefault(k, torch.randn(out[k].shape, generator=g))
            total = total + (out[k].float() * w).sum()
        return total, {"loss": total}
    with FlopCounterMode(display=False) as fc:
        compute_grads(model, None, loss_fn, batch, None,
                      torch.Generator(), mp=mesh)
    return fc.get_total_flops()


@pytest.mark.parametrize("n", MPS)
def test_rank_product_flops_are_one_mp_th(n):
    cfg = _flop_world()
    one = _model_flops(cfg)
    got = run_row(n, lambda m: _model_flops(cfg, m))
    assert one > 0 and all(f * n == one for f in got), (one, got)
