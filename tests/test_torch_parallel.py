"""The port's sharded store (parallel/, ops/packed_store.py) against
gdr_tpu's on the same inputs: the shard-aware packed layout bit for bit,
the store padding, the mesh's shape rules, and each sharded re-rank with
every shard's body run in this process and merged by hand, against JAX's
``shard_map`` over the virtual CPU devices (tests/conftest.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdr_tpu.config import MeshConfig as JaxMeshConfig
from gdr_tpu.ops.packed_store import pack_layout_sharded as jax_pack_sharded
from gdr_tpu.ops.packed_store import pack_store_by_cluster as jax_pack_store
from gdr_tpu.ops.quantize import pack_quantized_rows as jax_pack_quantized
from gdr_tpu.ops.trie import build_trie as jax_build_trie
from gdr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gdr_tpu.parallel.store import pad_store as jax_pad_store
from gdr_tpu.parallel.store import place_packed_store as jax_place_packed
from gdr_tpu.parallel.store import place_store as jax_place_store
from gdr_tpu.parallel.store import sharded_rerank_from_beams as jax_sharded
from gdr_tpu.parallel.store import sharded_rerank_packed as jax_sharded_packed
from gdr_tpu_torch.config import MeshConfig
from gdr_tpu_torch.ops.packed_store import (pack_layout_sharded,
                                            pack_store_by_cluster)
from gdr_tpu_torch.ops.quantize import PackedQuantizedStore
from gdr_tpu_torch.ops.rerank import NEG_INF, padded_top_k
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.parallel import store as S
from gdr_tpu_torch.parallel.mesh import make_mesh

D = 16


def _cid_map(seed: int = 3) -> dict[str, list[int]]:
    """Clusters of uneven sizes (1 to 11 docs), so that the bin-packing
    and the 8- and 32-row alignments all matter."""
    rng = np.random.default_rng(seed)
    cid_to_docs, doc = {}, 0
    for a in range(4):
        for b in range(3):
            n = int(rng.integers(1, 12))
            cid_to_docs[f"{a}-{b}"] = list(range(doc, doc + n))
            doc += n
    return cid_to_docs


@pytest.fixture(scope="module")
def world():
    cid_to_docs = _cid_map()
    n = sum(len(v) for v in cid_to_docs.values())
    trie = build_trie(cid_to_docs, 4, max_docs_per_cluster=16)
    jtrie = jax_build_trie(cid_to_docs, 4, max_docs_per_cluster=16,
                           use_native=False)
    rng = np.random.default_rng(7)
    store = rng.normal(size=(n, D)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    return trie, jtrie, store


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("align", [8, 32])
def test_sharded_layout_bit_equal_to_jax(world, n_shards, align):
    trie, jtrie, _ = world
    got = pack_layout_sharded(trie, n_shards, align=align)
    want = jax_pack_sharded(jtrie, n_shards, align=align)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3:] == want[3:]
    starts, counts, row_to_doc, cap, shard_rows = got
    # every block, with its cap margin, stays inside its shard
    assert np.all(starts // shard_rows
                  == (starts + cap - 1) // shard_rows)
    assert np.all(starts % align == 0) and len(row_to_doc) == n_shards * \
        shard_rows


@pytest.mark.parametrize("cap", [None, 16, 32])
def test_pack_store_by_cluster_bit_equal_to_jax(world, cap):
    trie, jtrie, store = world
    got = pack_store_by_cluster(trie, store, cap=cap)
    want = jax_pack_store(jtrie, store, cap=cap)
    for f in ("rows", "starts", "counts", "row_to_doc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.cap == want.cap and got.num_rows == want.num_rows


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_pad_store_and_place_store(world, n_shards):
    store = world[2]
    padded = S.pad_store(store, n_shards)
    np.testing.assert_array_equal(padded, jax_pad_store(store, n_shards))
    rows = padded.shape[0] // n_shards
    for rank in range(n_shards):
        mesh = dataclasses.replace(make_mesh(MeshConfig(dp=1)), dp=n_shards,
                                   rank=rank, world=n_shards)
        assert mesh.store_range(len(store)) == (rank * rows,
                                                (rank + 1) * rows)
        for src in (store, torch.as_tensor(store)):
            got = S.place_store(src, mesh)
            np.testing.assert_array_equal(
                got.numpy(), padded[rank * rows:(rank + 1) * rows])


def test_mesh_config_and_make_mesh_shapes():
    want = JaxMeshConfig()
    assert (MeshConfig().dp, MeshConfig().mp) == (want.dp, want.mp)
    mesh = make_mesh()                   # no process group: a world of one
    assert (mesh.rank, mesh.world, mesh.size) == (0, 1, 1)
    assert (mesh.dp, mesh.mp) == (1, 1)
    assert mesh.device == mesh.comm_device == torch.device("cpu")
    assert make_mesh(MeshConfig(dp=1, mp=1), device="cpu").size == 1
    t = torch.arange(6.0).reshape(1, 2, 3)
    assert mesh.all_gather(t) is t
    for cfg in (MeshConfig(dp=2), MeshConfig(dp=1, mp=2),
                MeshConfig(dp=2, mp=2)):
        with pytest.raises(ValueError, match="processes"):
            make_mesh(cfg)


def _beams(trie, rng, b: int, k: int):
    """k distinct cluster nodes per query (the last beam of the last query
    invalid), their scores, and the validity mask."""
    nodes = np.stack([rng.choice(trie.cluster_node_ids, size=k,
                                 replace=False) for _ in range(b)])
    valid = np.ones((b, k), bool)
    valid[-1, -1] = False
    scores = rng.normal(size=(b, k)).astype(np.float32)
    return nodes.astype(np.int32), scores, valid


def _merged(bodies, top_r):
    """Every shard's (scores, payload), concatenated in shard order and
    merged as ``gather_merge`` merges them."""
    scores = torch.cat([s for s, _ in bodies], dim=-1)
    payload = torch.cat([p for _, p in bodies], dim=-1)
    return padded_top_k(scores, payload, top_r)


def _same(got_ids, got_scores, want):
    ok = np.asarray(want.doc_valid)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got_scores.numpy() > NEG_INF / 2, ok)
    np.testing.assert_array_equal(got_ids.numpy()[ok],
                                  np.asarray(want.doc_ids)[ok])
    np.testing.assert_allclose(got_scores.numpy()[ok],
                               np.asarray(want.scores)[ok], rtol=0,
                               atol=1e-6)


LAYOUTS = ["plain", "packed", "packed int8"]


@pytest.mark.parametrize("per_beam", [False, True], ids=["B,d", "B,K,d"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_rerank_matches_jax(world, n_shards, layout, per_beam):
    trie, jtrie, store = world
    rng = np.random.default_rng(n_shards)
    b, k, top_r = 3, 4, 12
    nodes, beam_scores, valid = _beams(trie, rng, b, k)
    q = rng.normal(size=(b, k, D) if per_beam else (b, D)).astype(np.float32)
    alphas = np.asarray([0.0, 0.5, 2.0], np.float32)
    t = {name: torch.as_tensor(v) for name, v in dict(
        q=q, nodes=nodes, scores=beam_scores, valid=valid, alphas=alphas,
        con=trie.cluster_of_node, cdocs=trie.cluster_docs,
        cmask=trie.cluster_doc_mask).items()}
    j = {name: jnp.asarray(v.numpy()) for name, v in t.items()}
    jmesh = jax_make_mesh(JaxMeshConfig(dp=n_shards),
                          devices=jax.devices()[:n_shards])

    if layout == "plain":
        want = jax_sharded(jmesh, jax_place_store(store, jmesh), j["q"],
                           j["nodes"], j["scores"], j["valid"], j["con"],
                           j["cdocs"], j["cmask"], j["alphas"], top_r=top_r)
        padded = torch.as_tensor(S.pad_store(store, n_shards))
        rows = padded.shape[0] // n_shards
        docs, mask = S.expand_candidates(t["nodes"], t["valid"], t["con"],
                                         t["cdocs"], t["cmask"])
        probs = S._beam_probs(t["scores"], t["valid"])
        bodies = [S.rerank_shard(padded[s * rows:(s + 1) * rows], s, t["q"],
                                 docs, mask, probs, t["alphas"], top_r)
                  for s in range(n_shards)]
        got_scores, got_ids = _merged(bodies, top_r)
    else:
        align = 32 if layout == "packed int8" else 8
        starts, counts, row_to_doc, cap, shard_rows = pack_layout_sharded(
            trie, n_shards, align=align)
        full = np.zeros((len(row_to_doc), D), np.float32)
        full[row_to_doc >= 0] = store[row_to_doc[row_to_doc >= 0]]
        if layout == "packed int8":
            jrows = jax_pack_quantized(jnp.asarray(store),
                                       jnp.asarray(row_to_doc))
            jrows = type(jrows)(values=np.array(jrows.values),
                                scales=np.array(jrows.scales))
            shard = lambda s: PackedQuantizedStore(
                values=torch.as_tensor(
                    jrows.values[s * shard_rows:(s + 1) * shard_rows]),
                scales=torch.as_tensor(
                    jrows.scales[s * shard_rows:(s + 1) * shard_rows]))
        else:
            jrows = full
            shard = lambda s: torch.as_tensor(
                full[s * shard_rows:(s + 1) * shard_rows])
        want = jax_sharded_packed(
            jmesh, jax_place_packed(jrows, jmesh), jnp.asarray(starts),
            jnp.asarray(counts), jnp.asarray(row_to_doc), cap, shard_rows,
            j["q"], j["nodes"], j["scores"], j["valid"], j["con"],
            j["alphas"], top_r=top_r)
        ts, tc = torch.as_tensor(starts), torch.as_tensor(counts)
        bodies = [S.packed_shard(shard(s), s, shard_rows, ts, tc, cap,
                                 t["q"], t["nodes"], t["scores"], t["valid"],
                                 t["con"], t["alphas"], top_r)
                  for s in range(n_shards)]
        got_scores, got_rows = _merged(bodies, top_r)
        got_ids = torch.as_tensor(row_to_doc)[got_rows.long()]
    assert got_scores.shape == (len(alphas), b, top_r)
    _same(got_ids, got_scores, want)


def test_place_packed_store_builds_only_the_ranks_rows(world):
    """Each rank's rows of the packed layout, plain and int8, equal the
    whole packed store's slice (the int8 one gdr_tpu's quantization)."""
    trie, _, store = world
    for quantize, align in ((False, 8), (True, 32)):
        starts, counts, row_to_doc, cap, shard_rows = pack_layout_sharded(
            trie, 4, align=align)
        whole = jax_pack_quantized(jnp.asarray(store),
                                   jnp.asarray(row_to_doc))
        for rank in range(4):
            mesh = dataclasses.replace(make_mesh(), dp=4, rank=rank, world=4)
            got = S.place_packed_store(np.asarray(store), row_to_doc, mesh,
                                       quantize=quantize)
            sl = slice(rank * shard_rows, (rank + 1) * shard_rows)
            if quantize:
                np.testing.assert_array_equal(got.values.numpy(),
                                              np.asarray(whole.values)[sl])
                np.testing.assert_array_equal(got.scales.numpy(),
                                              np.asarray(whole.scales)[sl])
            else:
                r2d = row_to_doc[sl]
                want = np.where((r2d >= 0)[:, None],
                                store[np.maximum(r2d, 0)], 0)
                np.testing.assert_array_equal(got.numpy(), want)


def test_gather_merge_carries_ids_bit_for_bit():
    mesh = make_mesh()
    scores = torch.tensor([[[0.5, NEG_INF, 0.25]]])
    ids = torch.tensor([[[2**31 - 1, -7, 123456789]]], dtype=torch.int32)
    s, p = S.gather_merge(mesh, scores, ids, 3)
    assert s.tolist() == [[[0.5, 0.25, NEG_INF]]]
    assert p.dtype == torch.int32
    assert p.tolist() == [[[2**31 - 1, 123456789, -7]]]
    s, p = S.gather_merge(mesh, scores, ids, 5)     # padded past 3
    assert s[..., :2].tolist() == [[[0.5, 0.25]]] and s.shape[-1] == 5
