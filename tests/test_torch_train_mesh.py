"""The port's training over several processes on the CPU (``gloo``):
``TrainLoop(mesh=)`` in 4 ranks at dp=4, dp=2 × mp=2 and mp=4 (the
column-parallel step; at mp=4 the tiny model's 2 heads do not divide, so
q, k and v are gathered before the core), on the plain and packed eval
layouts, against the port's one-process loop and ``gdr_tpu``'s
mesh ``TrainLoop`` (its 8 virtual devices at dp=4 × mp=2), on the tiny f32
world of ``tests/test_parallel.py``'s own mesh test with input dropout on
(``gdr_tpu``'s draws handed to the port); the mp parts of the masters and
moments, the replicated masters equal over each mp row; a stage-2 run with every loss on and ``embed_corpus(mesh=)`` at
dp=2; a mesh checkpoint resumed in new ranks and in one process; ``train
--mesh 2`` under ``torch.distributed.run``; the refusals; and each
batch-coupled loss split over ranks simulated in one process (threads).
Every subprocess runs with a timeout, so a hang fails one test."""

import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chip_smoke import _small_train_world, mesh_train_world, record_loop
from gdr_tpu.config import MeshConfig as JaxMeshConfig
from gdr_tpu.config import tiny_config as jax_tiny_config
from gdr_tpu.data.dataset import TrainSet as JaxTrainSet
from gdr_tpu.data.synthetic import build_synthetic_task as jax_task
from gdr_tpu.eval.evaluator import EvalData as JaxEvalData
from gdr_tpu.index.builder import Index as JaxIndex
from gdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gdr_tpu.train.loop import TrainLoop as JaxTrainLoop
from gdr_tpu_torch import cli as port_cli
from gdr_tpu_torch.convert import params_from_flax
from gdr_tpu_torch.index.builder import embed_corpus
from gdr_tpu_torch.index.io import save_index
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, init_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.ops import losses
from gdr_tpu_torch.parallel.autograd import DPShards
from gdr_tpu_torch.parallel.mesh import Mesh, mp_slice, tp_param_rules
from gdr_tpu_torch.train.loop import TrainLoop
from test_torch_parallel_ranks import _env, _free_port

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
SEED = 0
EPOCHS = 2
LOSS_TOL = 1e-5              # each step's loss, mesh vs one process
                             # (relative: the losses run to ~40 in f32)
MASTER_TOL = 1e-5            # f32 masters after each epoch, absolute
JAX_TOL = 2e-4               # avg_train_loss vs gdr_tpu (its own test's)
MESHES = {"dp4": dict(dp=4), "dp2xmp2": dict(dp=2, mp=2),
          "mp4": dict(dp=1, mp=4)}
LAYOUTS = {"plain": False, "packed": True}
STAGE2_MESH = dict(dp=2, mp=2)

WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from chip_smoke import _small_train_world, mesh_train_world, record_loop
from gdr_tpu_torch.cli import _mesh_from_flag
from gdr_tpu_torch.config import MeshConfig
from gdr_tpu_torch.index.builder import embed_corpus
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, init_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.parallel.distributed import initialize, shutdown
from gdr_tpu_torch.parallel.mesh import make_mesh
from gdr_tpu_torch.train.loop import TrainLoop

work, coord, rank, phase = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
spec = json.load(open(f"{work}/spec.json"))
initialize(coord, spec["world"], rank, backend="gloo")
noise = dict(np.load(f"{work}/noise.npz"))
weights = torch.load(f"{work}/weights.pt")
out = {}
for run in spec[phase]:
    mesh = make_mesh(MeshConfig(**run["mesh"]), device="cpu")
    if run["world"] == "tiny":
        cfg, index, ts, dev = mesh_train_world()
        loop = TrainLoop(cfg, index, ts, dev, f"{work}/{run['dir']}",
                         seed=0, mesh=mesh, packed_eval=run["packed"],
                         warm_start=lambda m, _: m.load_state_dict(weights),
                         device="cpu")
        rec = record_loop(loop, noise)
    else:
        cfg, index, ts, dev, dtok, dmask = _small_train_world(1, 0.0)
        tower = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
        init_doc_encoder(tower, torch.Generator().manual_seed(1))
        rec = {"embed": embed_corpus(tower, dtok, dmask, batch_size=9,
                                     mesh=mesh)}
        loop = TrainLoop(cfg, index, ts, dev, f"{work}/{run['dir']}",
                         seed=3, doc_tokens=dtok, doc_tok_mask=dmask,
                         doc_encoder=tower, mesh=mesh, device="cpu")
        rec.update(record_loop(loop))
    rec["start_epoch"] = loop.start_epoch
    best = loop.run(max_epochs=run["epochs"])
    rec.update(best=best, last=loop.last_epoch_metrics,
               dp_rank=mesh.dp_rank, mp_rank=mesh.mp_rank,
               store_rows=int(loop.store.shape[0]),
               eval_rows=int(loop.evaluator.store.shape[0]),
               moments={k: (tuple(loop.state.opt_state["mu"][k].shape),
                            tuple(loop.state.opt_state["nu"][k].shape))
                        for k in loop.state.opt_state["mu"]})
    full = loop.full_state()
    if full is not None:
        torch.save(dict(params=full.params, opt_state=full.opt_state,
                        step=full.step), f"{work}/{run['dir']}/full.pt")
    torch.save(rec, f"{work}/{run['dir']}/rank{rank}.pt")
try:
    _mesh_from_flag("3,2", "cpu")
except SystemExit as e:
    out["refusal"] = str(e)
json.dump(out, open(f"{work}/{phase}{rank}.json", "w"))
shutdown()
"""


def _start(work: Path, phase: str) -> list:
    coord = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(work), coord, str(r), phase],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]


def _wait(procs: list) -> None:
    """Wait for every rank (killing all on a timeout); each must exit 0."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _jax_world():
    """``tests/test_parallel.py:178-188``'s config and task in gdr_tpu."""
    cfg = jax_tiny_config(kary=3, max_output_length=5)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, train_batch_size=8,
                                  eval_batch_size=4, num_train_epochs=2,
                                  train_encoder_epoch=99, bf16=False,
                                  learning_rate=3e-3,
                                  decoder_learning_rate=3e-3),
        eval=dataclasses.replace(cfg.eval, num_beams=4,
                                 num_return_sequences=4, score_rates=(0.0,)),
        mesh=dataclasses.replace(cfg.mesh, tp_min_size=256))
    task = jax_task(n_docs=16, dim=16, kary=3, leaf_cap=4, seq_len=8,
                    vocab_size=cfg.model.vocab_size, max_output_length=5,
                    seed=0)
    index = JaxIndex(store=task.store, trie=task.trie, paths=task.paths,
                     cid_of_doc=task.cid_of_doc)
    ts = JaxTrainSet(input_ids=task.input_ids, attn_mask=task.attn_mask,
                     labels=task.labels, label_mask=task.label_mask,
                     pos_idx=task.pos_idx,
                     source=["gtq"] * len(task.pos_idx))
    dev = JaxEvalData(input_ids=task.input_ids, attn_mask=task.attn_mask,
                      gt_docs=task.gt_docs, gt_cids=task.gt_cids)
    return cfg, index, ts, dev


def _jax_draws(cfg, steps: int) -> dict:
    """gdr_tpu's input-dropout draws of each step (its loop's step key,
    split five ways in its loss)."""
    base = jax.random.fold_in(jax.random.PRNGKey(SEED), 17)
    b, s = cfg.train.train_batch_size, 8
    gate, keep = [], []
    for i in range(steps):
        _, kg, km, _, _ = jax.random.split(jax.random.fold_in(base, i), 5)
        gate.append(bool(jax.random.bernoulli(kg, cfg.model.input_dropout)))
        keep.append(np.asarray(jax.random.bernoulli(km, 0.9, (2 * b, s))))
    return dict(gate=np.asarray(gate), keep=np.stack(keep))


def _one_process(workdir, weights, noise, packed):
    cfg, index, ts, dev = mesh_train_world()
    loop = TrainLoop(cfg, index, ts, dev, str(workdir), seed=SEED,
                     packed_eval=packed,
                     warm_start=lambda m, _: m.load_state_dict(weights),
                     device="cpu")
    rec = record_loop(loop, noise)
    rec["best"] = loop.run(max_epochs=EPOCHS)
    rec["state"] = loop.state
    return rec


def _stage2_one_process(workdir):
    cfg, index, ts, dev, dtok, dmask = _small_train_world(1, 0.0)
    tower = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
    init_doc_encoder(tower, torch.Generator().manual_seed(1))
    rec = {"embed": embed_corpus(tower, dtok, dmask, batch_size=9)}
    loop = TrainLoop(cfg, index, ts, dev, str(workdir), seed=3,
                     doc_tokens=dtok, doc_tok_mask=dmask, doc_encoder=tower,
                     device="cpu")
    rec.update(record_loop(loop))
    rec["best"] = loop.run(max_epochs=EPOCHS)
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """gdr_tpu's mesh loop, the port's one-process loops and the 4 ranks'
    runs (phase A: every mesh and layout, a 2x2 run stopped after epoch 1,
    the stage-2 run; phase B: that run resumed in 4 new ranks).  The ranks
    run while this process runs the references."""
    torch.set_num_threads(2)
    work = tmp_path_factory.mktemp("train_mesh")
    jcfg, jindex, jts, jdev = _jax_world()
    cfg, index, ts, _ = mesh_train_world()
    for name in ("input_ids", "labels", "label_mask", "pos_idx"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(jts, name))
    np.testing.assert_array_equal(index.store, jindex.store)
    jmesh = jax_make_mesh(JaxMeshConfig(dp=4, mp=2))
    jloop = JaxTrainLoop(jcfg, jindex, jts, jdev, workdir=str(work / "jax"),
                         seed=SEED, mesh=jmesh)
    weights = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jloop.state.params["generator"]))
    steps = EPOCHS * (len(ts) // cfg.train.train_batch_size)
    noise = _jax_draws(jcfg, steps)
    torch.save(weights, work / "weights.pt")
    np.savez(work / "noise.npz", **noise)
    runs_a = [dict(dir=f"{m}_{lay}", mesh=MESHES[m], packed=packed,
                   world="tiny", epochs=EPOCHS)
              for m in MESHES for lay, packed in LAYOUTS.items()]
    runs_a.append(dict(dir="stopped", mesh=MESHES["dp2xmp2"], packed=False,
                       world="tiny", epochs=1))
    runs_a.append(dict(dir="stage2", mesh=STAGE2_MESH, packed=False,
                       world="stage2", epochs=EPOCHS))
    runs_b = [dict(dir="stopped", mesh=MESHES["dp2xmp2"], packed=False,
                   world="tiny", epochs=EPOCHS)]
    (work / "spec.json").write_text(json.dumps(dict(world=WORLD, A=runs_a,
                                                    B=runs_b)))
    procs = _start(work, "A")
    try:
        jbest = jloop.run(max_epochs=EPOCHS)
        one = {lay: _one_process(work / f"one_{lay}", weights, noise, packed)
               for lay, packed in LAYOUTS.items()}
        stage2 = _stage2_one_process(work / "one_stage2")
    finally:
        _wait(procs)
    _wait(_start(work, "B"))
    got = {r["dir"]: [torch.load(work / r["dir"] / f"rank{k}.pt",
                                 weights_only=False) for k in range(WORLD)]
           for r in runs_a}
    resumed = [torch.load(work / "stopped" / f"rank{k}.pt",
                          weights_only=False) for k in range(WORLD)]
    refusals = [json.loads((work / f"A{k}.json").read_text())["refusal"]
                for k in range(WORLD)]
    return dict(work=work, jbest=jbest, jloop=jloop, one=one, stage2=stage2,
                got=got, resumed=resumed, refusals=refusals, weights=weights,
                noise=noise, cfg=cfg)


def _rank_slice(key: str, want: torch.Tensor, mp: int, mp_rank: int,
                min_size: int, doc_heads: int = 0) -> torch.Tensor:
    """The one-process master ``key`` cut as the rank holds it (the
    placement's own axis, ``tp_param_rules``)."""
    cut = (tp_param_rules(mp, min_size, doc_heads)(key, want) if mp > 1
           else None)
    if cut is None:
        return want
    return mp_slice(want, Mesh(dp=1, mp=mp, rank=mp_rank, world=mp,
                               device=torch.device("cpu"),
                               comm_device=torch.device("cpu")), cut)


def _same_masters(got: dict, want: dict, mp: int, mp_rank: int, tol: float,
                  min_size: int, doc_heads: int = 0) -> float:
    assert got.keys() == want.keys()
    err = 0.0
    for k, g in got.items():
        ref = _rank_slice(k, want[k], mp, mp_rank, min_size, doc_heads)
        assert g.shape == ref.shape, k
        err = max(err, float((g - ref).abs().max()))
    assert err <= tol, err
    return err


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_loop_matches_one_process(runs, mesh, layout):
    one = runs["one"][layout]
    mp = MESHES[mesh].get("mp", 1)
    for rk in runs["got"][f"{mesh}_{layout}"]:
        np.testing.assert_allclose(rk["losses"], one["losses"],
                                   rtol=LOSS_TOL, atol=0)
        assert len(rk["masters"]) == EPOCHS
        for got, want in zip(rk["masters"], one["masters"]):
            _same_masters(got, want, mp, rk["mp_rank"], MASTER_TOL,
                          runs["cfg"].mesh.tp_min_size)
        assert rk["best"]["recall1"] == one["best"]["recall1"]
        assert rk["best"]["avg_train_loss"] == pytest.approx(
            one["best"]["avg_train_loss"], rel=LOSS_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_loop_matches_gdr_tpu_mesh_loop(runs, mesh, layout):
    jlast = runs["jloop"].last_epoch_metrics
    for rk in runs["got"][f"{mesh}_{layout}"]:
        np.testing.assert_allclose(rk["last"]["avg_train_loss"],
                                   jlast["avg_train_loss"], rtol=JAX_TOL,
                                   atol=JAX_TOL)
        assert rk["best"]["recall1"] == runs["jbest"]["recall1"]


def test_mp_ranks_hold_half_the_columns(runs):
    """On an mp=2 rank each leaf tp_param_rules selects (pawa.u among
    them), its mu and its nu hold half of the leaf's own cut axis (the
    output axis: dim 0 of a Linear weight, an embedding's last dim); the
    rank's master-and-moment bytes follow; no rank holds the whole
    store."""
    one = runs["one"]["plain"]["state"]
    rule = tp_param_rules(2, runs["cfg"].mesh.tp_min_size)
    full = {f"{t}/{n}": p for t, d in one.params.items() for n, p in d.items()}
    picked = {k: rule(k, p) for k, p in full.items() if rule(k, p)}
    assert "generator/pawa.u" in picked and len(picked) < len(full)
    assert picked["generator/encoder.blocks.0.ff.wi.weight"].dim == 0
    want_bytes = sum(p.numel() // (2 if k in picked else 1) * 4 * 3
                     for k, p in full.items())
    for rk in runs["got"]["dp2xmp2_plain"]:
        masters = rk["masters"][-1]
        held = 0
        for k, p in full.items():
            shape = list(p.shape)
            if k in picked:
                shape[picked[k].dim] //= 2
            assert list(masters[k].shape) == shape, k
            assert [list(s) for s in rk["moments"][k]] == [shape, shape], k
            held += masters[k].numel() * 4 * 3
        assert held == want_bytes
        assert rk["store_rows"] == rk["eval_rows"] == -(-16 // WORLD)


@pytest.mark.parametrize("mesh", [m for m in MESHES if "mp" in MESHES[m]])
def test_replicated_masters_equal_over_each_mp_row(runs, mesh):
    """The leaves no rank cuts are the same bits on every rank of an mp
    row after each epoch: the row's all-reduces hand every rank the same
    sum."""
    mp = MESHES[mesh]["mp"]
    rule = tp_param_rules(mp, runs["cfg"].mesh.tp_min_size)
    full = {f"{t}/{n}": p for t, d in
            runs["one"]["plain"]["state"].params.items() for n, p in d.items()}
    for layout in LAYOUTS:
        ranks = runs["got"][f"{mesh}_{layout}"]
        for row in range(WORLD // mp):
            members = ranks[row * mp:(row + 1) * mp]
            for e, first in enumerate(members[0]["masters"]):
                whole = [k for k in first if rule(k, full[k]) is None]
                assert whole and len(whole) < len(first)
                for rk in members[1:]:
                    for k in whole:
                        assert torch.equal(rk["masters"][e][k], first[k]), k


def test_stage2_and_embed_corpus_at_dp2(runs):
    want = runs["stage2"]
    for rk in runs["got"]["stage2"]:
        np.testing.assert_allclose(rk["embed"], want["embed"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(rk["losses"], want["losses"],
                                   rtol=LOSS_TOL, atol=0)
        for got, ref in zip(rk["masters"], want["masters"]):
            _same_masters(got, ref, 2, rk["mp_rank"], MASTER_TOL,
                          1 << 14, tiny_doc_encoder_config().num_heads)
        assert rk["best"]["recall1"] == want["best"]["recall1"]
        assert rk["last"]["stage"] == 2


def _equal_full(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    for part in ("params", "opt_state"):
        flat_a = _flatten(a[part])
        flat_b = _flatten(b[part])
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            x, y = flat_a[k], flat_b[k]
            if isinstance(x, torch.Tensor):
                assert torch.equal(x.cpu(), y.cpu()), k
            else:
                assert x == y, k


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_checkpoints_resume_in_new_ranks_and_in_one_process(runs):
    work = runs["work"]
    assert {rk["start_epoch"] for rk in runs["resumed"]} == {1}
    uninterrupted = torch.load(work / "dp2xmp2_plain" / "full.pt",
                               weights_only=False)
    resumed = torch.load(work / "stopped" / "full.pt", weights_only=False)
    _equal_full(resumed, uninterrupted)
    # one process restores the mesh run's resume point and holds its state
    cfg, index, ts, dev = mesh_train_world()
    loop = TrainLoop(cfg, index, ts, dev, str(work / "dp2xmp2_plain"),
                     seed=SEED, device="cpu")
    assert loop.start_epoch == EPOCHS
    st = loop.state
    _equal_full(dict(params=st.params, opt_state=st.opt_state, step=st.step),
                uninterrupted)
    for name, p in loop.model.named_parameters():
        assert torch.equal(p, st.params["generator"][name]), name


def test_refusals(runs):
    for msg in runs["refusals"]:
        assert "--mesh 3,2: mesh 3x2 != 4 processes" in msg
    cfg, index, ts, dev = mesh_train_world()
    three = Mesh(dp=3, mp=1, rank=0, world=3, device=torch.device("cpu"),
                 comm_device=torch.device("cpu"))
    with pytest.raises(ValueError, match="train_batch_size=8 must be "
                                         "divisible by the mesh dp axis"):
        TrainLoop(cfg, index, ts, dev, tempfile.mkdtemp(), mesh=three,
                  device="cpu")


def test_cli_auto_refuses_a_batch_that_does_not_divide_the_world(
        monkeypatch):
    from gdr_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    with pytest.raises(SystemExit, match="a batch of 3 does not divide over "
                                         "the world of 2 processes"):
        port_cli._train_mesh("auto", "cpu", (3, 3))


# ------------------------------------------------------------------ CLI

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
CLI_MODEL = ["--model-size", "tiny", "--kary", "3", "--max-output-length",
             "5", "--adaptor-layers", "1", "--beam", "4",
             "--max-input-length", "10", "--device", "cpu"]


def _cli(argv, nproc: int = 0) -> str:
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m", "gdr_tpu_torch.cli"]
              if nproc else [sys.executable, "-m", "gdr_tpu_torch.cli"])
    out = subprocess.run(launch + argv, cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_cli_train_mesh_under_torchrun_matches_one_process(tmp_path):
    _cli_mesh_matches_one_process(tmp_path, "2")


def test_cli_train_tensor_parallel_under_torchrun_matches_one_process(
        tmp_path):
    """``train --mesh 1,2``: the two ranks of one mp row, column-parallel."""
    _cli_mesh_matches_one_process(tmp_path, "1,2")


def _cli_mesh_matches_one_process(tmp_path, mesh: str):
    _, index, _, _ = mesh_train_world()
    save_index(str(tmp_path / "index.npz"), index)
    rng = np.random.default_rng(3)
    for name, n in (("train.tsv", 16), ("dev.tsv", 8)):
        (tmp_path / name).write_text("".join(
            f"{' '.join(rng.choice(WORDS, 4))}\t{i % 16}\n"
            for i in range(n)))
    common = ["--index", str(tmp_path / "index.npz"), "--dev",
              str(tmp_path / "dev.tsv"), *CLI_MODEL]
    train = ["train", *common, "--train", str(tmp_path / "train.tsv"),
             "--batch-size", "8", "--epochs", "2", "--dropout", "0",
             "--no-bf16", "--seed", "1"]
    one = json.loads(_cli(train + ["--workdir", str(tmp_path / "one")]))
    two = _cli(train + ["--workdir", str(tmp_path / "two"), "--mesh", mesh],
               nproc=2)
    assert len(two.splitlines()) == 1            # rank 0 alone prints
    two = json.loads(two)
    assert two.keys() == one.keys() and two["epoch"] == one["epoch"]
    assert two["avg_train_loss"] == pytest.approx(one["avg_train_loss"],
                                                  rel=LOSS_TOL)
    assert two["recall1"] == one["recall1"]
    drop = lambda m: {k: v for k, v in m.items()
                      if not k.endswith(("_total_s", "_mean_ms"))}
    ev = [drop(json.loads(_cli(["eval", *common, "--workdir",
                                str(tmp_path / w)])))
          for w in ("one", "two")]
    assert ev[0] == ev[1]


# ------------------------------------------------- losses over dp ranks

class ThreadMesh:
    """The dp column of ``n`` ranks simulated by threads of one process:
    the collectives that ``parallel/autograd.py`` calls, through shared
    slots and a barrier."""

    def __init__(self, n: int, rank: int, shared: dict):
        self.dp, self.mp, self.dp_rank, self.shared = n, 1, rank, shared

    def _exchange(self, t):
        self.shared["slots"][self.dp_rank] = t.detach().clone()
        self.shared["barrier"].wait()
        out = list(self.shared["slots"])
        self.shared["barrier"].wait()
        return out

    def all_gather_dp(self, t):
        return torch.cat(self._exchange(t))

    def all_reduce_dp(self, tensors):
        for t in tensors:
            t.copy_(sum(self._exchange(t)))

    def sum_dp(self, t):
        return sum(self._exchange(t))


def _split_run(n: int, fn, inputs: list, rows: list):
    """Each simulated rank's loss on its rows of the ``rows``-marked inputs
    (others shared, as a weight): (SUM of the ranks' losses, SUM of their
    gradients of every input)."""
    shared = {"slots": [None] * n, "barrier": threading.Barrier(n)}
    res = [None] * n

    def work(r):
        leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
                  for x in inputs]
        parts = [x.chunk(n)[r] if split else x
                 for x, split in zip(leaves, rows)]
        loss = fn(DPShards(ThreadMesh(n, r, shared)), *parts)
        loss.backward()
        res[r] = (loss.detach(), [x.grad for x in leaves])
    threads = [threading.Thread(target=work, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return (sum(r[0] for r in res),
            [None if res[0][1][i] is None else sum(r[1][i] for r in res)
             for i in range(len(inputs))])


def _one_batch(fn, inputs: list):
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in inputs]
    loss = fn(None, *leaves)
    loss.backward()
    return loss.detach(), [x.grad for x in leaves]


def _batch_losses():
    """name → (loss of (dp, *inputs), inputs, which inputs are rows).  A
    shared weight ``w`` feeds every loss, so its gradient sums over the
    ranks; the R-Drop rows come as the two halves [x; x'] of each rank."""
    g = torch.Generator().manual_seed(0)
    b, l, d, c, v = 8, 5, 6, 3, 7
    r = lambda *s: torch.randn(*s, generator=g) * 0.5
    h1, h2, w = r(b, l, d), r(b, l, d), r(d, d)
    lm = (torch.rand(b, l, generator=g) > 0.3).float()
    lm[:, 0] = 1
    q, pos, cand = r(b, d), r(b, d), r(b, c, d)
    cmask = torch.rand(b, c, generator=g) > 0.2
    logits, labels = r(b, l, v), torch.randint(0, v, (b, l), generator=g)
    ids = torch.randint(2, v, (b, l), generator=g)
    ids[:, 3] = 1
    gathered = lambda dp, x: x if dp is None else dp.gather(x)
    return {
        "masked_cross_entropy": (
            lambda dp, x, y, m, w: losses.masked_cross_entropy(
                x @ w[:v, :v], y, m, dp),
            [logits, labels, lm, r(v, v)], [1, 1, 1, 0]),
        "rdrop_contrast": (
            lambda dp, x1, x2, m, w: losses.rdrop_contrast_loss(
                torch.cat([x1, x2]) @ w, torch.cat([m, m]), dp),
            [h1, h2, lm, w], [1, 1, 1, 0]),
        "rdrop_l2": (
            lambda dp, x1, x2, w: losses.rdrop_l2_loss(
                torch.cat([x1, x2]) @ w, norm_cols=9, dp=dp),
            [h1, h2, w], [1, 1, 0]),
        "query_token_infonce": (
            lambda dp, x, hh, m, w: losses.query_token_infonce(
                x @ w, hh, m, dp),
            [q, h1, lm, w], [1, 1, 1, 0]),
        "cluster_infonce": (
            lambda dp, x, p, cd, w: losses.cluster_infonce(
                x @ w, p, gathered(dp, cd @ w), cmask, tau=0.5, dp=dp),
            [q, pos, cand, w], [1, 1, 1, 0]),
        "doc_reweight": (
            lambda dp, x, y, m, qq, p, w: losses.doc_reweight_loss(
                x, y, m, qq @ w, p, dp),
            [logits, labels, lm, q, pos.abs(), w], [1, 1, 1, 1, 1, 0]),
        "embedding_distillation": (
            lambda dp, hh, t, p, w: losses.embedding_distillation_loss(
                hh @ w, t, p, dp),
            [h1, ids, pos, w], [1, 1, 1, 0]),
        "weight_distillation": (
            lambda dp, hh, t, m, w: losses.weight_distillation_loss(
                hh @ w, t, m, dp),
            [h1, h2, lm, w], [1, 1, 1, 0]),
        "margin_ranking": (
            lambda dp, p, n, w: losses.margin_ranking_loss(
                (p @ w)[:, :1], n, margin=0.5, dp=dp),
            [pos, r(b, c), w], [1, 1, 0]),
    }


LOSSES = _batch_losses()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_shares_sum_to_the_one_batch_loss(name, n):
    fn, inputs, rows = LOSSES[name]
    want, want_g = _one_batch(fn, inputs)
    got, got_g = _split_run(n, fn, inputs, rows)
    assert float(abs(got - want)) <= 1e-6, (float(got), float(want))
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        if b is None:
            continue
        assert float((a - b).abs().max()) <= 1e-6, (name, i)
