"""The port's serving over several processes on the CPU (``gloo``):
``initialize`` / ``process_info`` with explicit arguments, with torchrun's
environment and with neither; ``Evaluator(mesh=)`` in 4 ranks at dp=4 and
dp=2 × mp=2 on the plain, packed and packed int8 layouts against the
port's one-process retrieve and gdr_tpu's mesh evaluator (a tiny model
bridged from gdr_tpu); and ``retrieve`` / ``eval --mesh 2`` under
``torch.distributed.run`` against the one-process CLI.  Every subprocess
runs with a timeout, so a hang fails one test."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gdr_tpu.config import EvalConfig as JaxEvalConfig
from gdr_tpu.config import MeshConfig as JaxMeshConfig
from gdr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gdr_tpu_torch.config import EvalConfig
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator
from gdr_tpu_torch.index.io import Index, save_index
from gdr_tpu_torch.ops.packed_store import pack_layout_sharded
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.parallel.distributed import (initialize, local_card,
                                                process_info)
from torch_port_helpers import TINY, queries, small_cid_map, tiny_pair

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
EV = dict(num_beams=10, num_return_sequences=16, max_output_length=5)
MESHES = {"dp4": dict(dp=4), "dp2xmp2": dict(dp=2, mp=2)}
LAYOUTS = {"plain": {}, "packed": dict(packed=True),
           "packed int8": dict(packed=True, quantize=True)}
TIMEOUT = 240
TIMER_KEYS = ("_total_s", "_mean_ms")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return env


def _run_all(argvs: list[list[str]], envs: list[dict]) -> list[str]:
    """Start every process, wait for all (killing all on a timeout) and
    return their standard outputs; each must exit 0."""
    procs = [subprocess.Popen(a, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_initialize_without_environment_returns_false(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() is False
    assert process_info() == (0, 1)
    with pytest.raises(ValueError, match="num_processes"):
        initialize("127.0.0.1:1")


def test_initialize_under_torchrun_raises_when_the_join_fails(monkeypatch):
    """torchrun's environment with MASTER_ADDR missing: the join raises,
    never a quiet world of one."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize(backend="gloo")
    assert process_info() == (0, 1)


@pytest.mark.parametrize("env, rank, world, cards, want", [
    ({}, 1, 2, 4, (1, 2)),                  # one host, fewer ranks
    ({}, 5, 8, 4, (1, 4)),                  # second of two 4-card hosts
    ({}, 3, 4, 1, (0, 1)),                  # four 1-card hosts
    ({}, 0, 6, 4, None),                    # 6 do not fill 4-card hosts
    ({}, 0, 1, 0, None),                    # no card
    (dict(LOCAL_RANK="2", LOCAL_WORLD_SIZE="3"), 6, 7, 4, (2, 3)),
    (dict(LOCAL_RANK="0", LOCAL_WORLD_SIZE="5"), 0, 5, 4, None),
    (dict(LOCAL_WORLD_SIZE="2"), 0, 2, 1, None),
])
def test_local_card_of_a_rank(monkeypatch, env, rank, world, cards, want):
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is None:
        with pytest.raises(ValueError, match="NCCL needs one card per rank"):
            local_card(rank, world, cards)
    else:
        assert local_card(rank, world, cards) == want


ENV_WORKER = r"""
import torch
from gdr_tpu_torch.config import MeshConfig
from gdr_tpu_torch.parallel.distributed import (initialize, process_info,
                                                shutdown)
from gdr_tpu_torch.parallel.mesh import make_mesh
assert initialize(backend="gloo") is True
rank, world = process_info()
mesh = make_mesh(MeshConfig())
assert (mesh.dp, mesh.mp, mesh.rank, mesh.world) == (2, 1, rank, 2)
got = mesh.all_gather(torch.full((1, 2), float(rank))).tolist()
try:
    make_mesh(MeshConfig(dp=4))
    raise SystemExit("a 4x1 mesh over 2 processes did not raise")
except ValueError:
    pass
print(rank, world, got)
shutdown()
"""


def test_initialize_from_torchrun_environment():
    port = str(_free_port())
    envs = [dict(_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            for r in range(2)]
    outs = _run_all([[sys.executable, "-c", ENV_WORKER]] * 2, envs)
    for r, out in enumerate(outs):
        assert out.split("\n")[0] == f"{r} 2 [[0.0, 0.0, 1.0, 1.0]]"


MESH_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from gdr_tpu_torch.config import EvalConfig, MeshConfig, ModelConfig
from gdr_tpu_torch.eval.evaluator import EvalData, Evaluator
from gdr_tpu_torch.models.gdr import GenerativeRetriever
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.parallel.distributed import (initialize, process_info,
                                                shutdown)
from gdr_tpu_torch.parallel.mesh import make_mesh

work, coord, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
spec = json.load(open(f"{work}/spec.json"))
ok = initialize(coord, spec["world"], rank, backend="gloo")
info = process_info()
model = GenerativeRetriever(ModelConfig(**spec["model"]))
model.load_state_dict(torch.load(f"{work}/weights.pt"))
model.eval()
trie = build_trie(spec["cid_to_docs"], spec["model"]["kary"])
z = np.load(f"{work}/inputs.npz")
store = np.load(f"{work}/store.npy", mmap_mode="r")
out = {"initialized": np.asarray(ok), "info": np.asarray(info)}
metrics = {}
for mesh_name, mcfg in spec["meshes"].items():
    mesh = make_mesh(MeshConfig(**mcfg), device="cpu")
    for layout, kw in spec["layouts"].items():
        ev = Evaluator(model, trie, store, EvalConfig(**spec["ev"]),
                       mesh=mesh, **kw)
        res, rr = ev.retrieve(z["ids"], z["mask"])
        key = f"{mesh_name}/{layout}"
        for name, t in (("sequences", res.sequences), ("valid", res.valid),
                        ("doc_ids", rr.doc_ids), ("scores", rr.scores),
                        ("doc_valid", rr.doc_valid)):
            out[f"{key}/{name}"] = t.numpy()
        held = ev.store.values if kw.get("quantize") else ev.store
        out[f"{key}/rows_held"] = np.asarray(held.shape[0])
        if mesh_name == "dp4":
            m = ev.evaluate(EvalData(z["ids"], z["mask"], spec["gt_docs"],
                                     spec["gt_cids"]), batch_size=2)
            metrics[layout] = m
np.savez(f"{work}/rank{rank}.npz", **out)
json.dump(metrics, open(f"{work}/metrics{rank}.json", "w"))
shutdown()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The tiny bridged model, its one-process and JAX results, and the
    4 ranks' results (each rank's npz and evaluate metrics)."""
    work = tmp_path_factory.mktemp("mesh_ranks")
    jm, params, tm = tiny_pair(seed=1, encoder_d_model=16)
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, TINY["kary"])
    n = sum(len(v) for v in cid_to_docs.values())
    rng = np.random.default_rng(2)
    store = rng.normal(size=(n, 16)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    ids, mask = queries(rng, 4, 8, TINY["vocab_size"])
    cid_of = {d: cid for cid, docs in cid_to_docs.items() for d in docs}
    gt = rng.integers(0, n, size=len(ids))
    gt_docs, gt_cids = [[str(d)] for d in gt], [[cid_of[int(d)]] for d in gt]
    np.save(work / "store.npy", store)
    np.savez(work / "inputs.npz", ids=ids, mask=mask)
    torch.save(tm.state_dict(), work / "weights.pt")
    (work / "spec.json").write_text(json.dumps(dict(
        world=WORLD, model={**TINY, "encoder_d_model": 16}, ev=EV,
        cid_to_docs=cid_to_docs, meshes=MESHES, layouts=LAYOUTS,
        gt_docs=gt_docs, gt_cids=gt_cids)))
    coord = f"127.0.0.1:{_free_port()}"
    _run_all([[sys.executable, "-c", MESH_WORKER, str(work), coord, str(r)]
              for r in range(WORLD)], [_env()] * WORLD)
    got = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    metrics = [json.loads((work / f"metrics{r}.json").read_text())
               for r in range(WORLD)]
    data = EvalData(ids, mask, gt_docs, gt_cids)
    return dict(jm=jm, params=params, tm=tm, trie=trie, store=store, ids=ids,
                mask=mask, data=data, got=got, metrics=metrics, n=n)


def test_initialize_with_explicit_arguments(ranks):
    for r, got in enumerate(ranks["got"]):
        assert bool(got["initialized"])
        assert tuple(got["info"]) == (r, WORLD)


def _close(got: dict, key: str, res, rr, atol: float) -> None:
    valid = res.valid.numpy() if isinstance(res.valid, torch.Tensor) \
        else np.asarray(res.valid)
    np.testing.assert_array_equal(got[f"{key}/valid"], valid)
    np.testing.assert_array_equal(got[f"{key}/sequences"][valid],
                                  np.asarray(res.sequences)[valid])
    dv = np.asarray(rr.doc_valid)
    assert dv.sum() > 0
    np.testing.assert_array_equal(got[f"{key}/doc_valid"], dv)
    np.testing.assert_array_equal(got[f"{key}/doc_ids"][dv],
                                  np.asarray(rr.doc_ids)[dv])
    np.testing.assert_allclose(got[f"{key}/scores"][dv],
                               np.asarray(rr.scores)[dv], rtol=0, atol=atol)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_evaluator_matches_one_process_and_jax(ranks, mesh, layout):
    key = f"{mesh}/{layout}"
    got = ranks["got"]
    for r in range(1, WORLD):                    # every rank: one result
        for name in ("sequences", "valid", "doc_ids", "scores", "doc_valid"):
            np.testing.assert_array_equal(got[r][f"{key}/{name}"],
                                          got[0][f"{key}/{name}"])
    # each rank holds its shard's rows alone
    kw = LAYOUTS[layout]
    shard_rows = (pack_layout_sharded(ranks["trie"], WORLD,
                                      align=32 if kw.get("quantize") else 8)[4]
                  if kw else -(-ranks["n"] // WORLD))
    assert {int(g[f"{key}/rows_held"]) for g in got} == {shard_rows}
    one = Evaluator(ranks["tm"], ranks["trie"], ranks["store"],
                    EvalConfig(**EV), **kw)
    res, rr = one.retrieve(ranks["ids"], ranks["mask"])
    _close(got[0], key, res, rr, atol=1e-5)
    jmesh = jax_make_mesh(JaxMeshConfig(**MESHES[mesh]),
                          devices=jax.devices()[:WORLD])
    jev = JaxEvaluator(ranks["jm"], ranks["trie"], ranks["store"],
                       JaxEvalConfig(**EV), mesh=jmesh, **kw)
    res_j, rr_j = jev.retrieve(ranks["params"], ranks["ids"], ranks["mask"])
    _close(got[0], key, res_j, rr_j, atol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_evaluate_metrics_match_one_process(ranks, layout):
    drop = lambda m: {k: v for k, v in m.items() if not k.endswith(TIMER_KEYS)}
    one = Evaluator(ranks["tm"], ranks["trie"], ranks["store"],
                    EvalConfig(**EV), **LAYOUTS[layout])
    want = drop(one.evaluate(ranks["data"], batch_size=2))
    for m in ranks["metrics"]:
        assert drop(m[layout]) == pytest.approx(want, abs=1e-9)


# the torchrun CLI: retrieve and eval over a small index, seeded weights
MODEL_FLAGS = ["--model-size", "tiny", "--kary", "4", "--max-output-length",
               "5", "--adaptor-layers", "1", "--max-input-length", "12",
               "--device", "cpu"]
QUERIES = ["alpha beta gamma", "what is the delta of epsilon", "zeta eta",
           "theta iota kappa", "lambda mu"]


@pytest.fixture(scope="module")
def cli_index(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    cid_to_docs = small_cid_map()
    trie = build_trie(cid_to_docs, 4)
    n = sum(len(v) for v in cid_to_docs.values())
    paths = [None] * n
    for cid, docs in cid_to_docs.items():
        for d in docs:
            paths[d] = [int(x) for x in cid.split("-")]
    store = np.random.default_rng(5).normal(size=(n, 16)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    path = tmp / "index.npz"
    save_index(str(path), Index(store=store, trie=trie, paths=paths,
                                cid_of_doc=["-".join(map(str, p))
                                            for p in paths]))
    dev = tmp / "dev.tsv"
    dev.write_text("".join(f"{q}\t{i * 7 % n}\n"
                           for i, q in enumerate(QUERIES)))
    return tmp, str(path), str(dev)


def test_cli_refuses_more_nccl_ranks_than_cards(monkeypatch, cli_index):
    """Under --device cuda a world larger than the host's cards exits
    before any rank joins the group."""
    from gdr_tpu_torch import cli as port_cli

    _, index, _ = cli_index
    cards = torch.cuda.device_count()
    for k, v in dict(RANK="0", WORLD_SIZE=str(cards + 1),
                     LOCAL_WORLD_SIZE=str(cards + 1),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="NCCL needs one card per rank"):
        port_cli.main(["retrieve", "--index", index, "--workdir", "run",
                       "--query", "x", "--mesh", "auto", "--device",
                       "cuda"])


def _cli(argv, nproc: int = 0) -> str:
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc), "-m", "gdr_tpu_torch.cli"]
              if nproc else [sys.executable, "-m", "gdr_tpu_torch.cli"])
    return _run_all([launch + argv], [_env()])[0]


def test_cli_retrieve_and_eval_under_torchrun_match_one_process(cli_index):
    tmp, index, dev = cli_index
    common = ["--index", index, "--workdir", str(tmp / "run"), *MODEL_FLAGS,
              "--beam", "8"]
    retrieve = ["retrieve", *common, "--top-k", "6", "--batch-size", "2",
                "--packed", "--json"]
    for q in QUERIES:
        retrieve += ["--query", q]
    want = _cli(retrieve)
    got = _cli(retrieve + ["--mesh", "2"], nproc=2)
    assert got == want and len(want.splitlines()) == len(QUERIES)
    evaluate = ["eval", *common, "--dev", dev, "--eval-batch-size", "2",
                "--packed", "--int8-store"]
    tsv = tmp / "mesh.tsv"
    one = json.loads(_cli(evaluate + ["--result-tsv", str(tmp / "one.tsv")]
                          ).split("\n", 1)[1])
    out = _cli(evaluate + ["--mesh", "2", "--result-tsv", str(tsv)], nproc=2)
    assert out.count("wrote result TSV") == 1     # rank 0 alone writes
    two = json.loads(out.split("\n", 1)[1])
    drop = lambda m: {k: v for k, v in m.items() if not k.endswith(TIMER_KEYS)}
    assert drop(two) == drop(one)
    assert tsv.read_bytes() == (tmp / "one.tsv").read_bytes()


def test_cli_retrieve_with_coordinator_matches_one_process(cli_index):
    """The explicit bootstrap: two processes given --coordinator,
    --num-processes and --process-id, over gloo; rank 0 prints what one
    process prints, rank 1 nothing."""
    tmp, index, _ = cli_index
    retrieve = ["retrieve", "--index", index, "--workdir", str(tmp / "run"),
                *MODEL_FLAGS, "--beam", "8", "--top-k", "6", "--json"]
    for q in QUERIES:
        retrieve += ["--query", q]
    want = _cli(retrieve)
    coord = f"127.0.0.1:{_free_port()}"
    launch = [sys.executable, "-m", "gdr_tpu_torch.cli", "--coordinator",
              coord, "--num-processes", "2"]
    outs = _run_all([launch + ["--process-id", str(r), *retrieve, "--mesh",
                               "2"] for r in range(2)], [_env()] * 2)
    assert outs == [want, ""] and len(want.splitlines()) == len(QUERIES)
