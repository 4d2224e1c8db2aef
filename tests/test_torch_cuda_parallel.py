"""The sharded re-rank's shard bodies (parallel/store.py) on the card
against the same bodies on the CPU: each shard's rows scored through its
layout's kernel (``rerank_scores`` on the plain store, ``packed_scores`` /
``packed_scores_int8`` on the packed ones), one launch per shard, and the
merged result equal to the CPU's (ids where valid, scores at the f32
tolerance).  Without a CUDA device every test skips; the file imports
neither JAX nor the reference package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py
"""

import numpy as np
import pytest
import torch

from gdr_tpu_torch import kernels
from gdr_tpu_torch.ops.packed_store import pack_layout_sharded
from gdr_tpu_torch.ops.quantize import PackedQuantizedStore, quantize_store
from gdr_tpu_torch.ops.rerank import (NEG_INF, _beam_probs,
                                      expand_candidates, padded_top_k)
from gdr_tpu_torch.ops.trie import build_trie
from gdr_tpu_torch.parallel import store as S

pytestmark = pytest.mark.cuda
D, B, K, TOP_R = 64, 3, 5, 20
SCORER = {"plain": "rerank_scores", "packed": "packed_scores",
          "packed int8": "packed_scores_int8"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scorer kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda", 0)


def _world(seed: int = 0):
    rng = np.random.default_rng(seed)
    cid_to_docs, doc = {}, 0
    for a in range(4):
        for b in range(4):
            n = int(rng.integers(1, 30))
            cid_to_docs[f"{a}-{b}"] = list(range(doc, doc + n))
            doc += n
    trie = build_trie(cid_to_docs, 4, max_docs_per_cluster=32)
    store = rng.normal(size=(doc, D)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    nodes = np.stack([rng.choice(trie.cluster_node_ids, size=K,
                                 replace=False) for _ in range(B)])
    valid = np.ones((B, K), bool)
    valid[-1, -1] = False
    return dict(trie=trie, store=store, nodes=nodes.astype(np.int32),
                scores=rng.normal(size=(B, K)).astype(np.float32),
                valid=valid,
                q=rng.normal(size=(B, K, D)).astype(np.float32),
                alphas=np.asarray([0.0, 1.0], np.float32))


def _bodies(w, layout: str, n: int, device):
    """Every shard's body on ``device``, merged as ``gather_merge`` merges
    them; returns (scores, doc ids) and each body's launches."""
    t = {k: torch.as_tensor(w[k], device=device)
         for k in ("nodes", "scores", "valid", "q", "alphas")}
    trie = w["trie"]
    tab = {k: torch.as_tensor(getattr(trie, k), device=device)
           for k in ("cluster_of_node", "cluster_docs", "cluster_doc_mask")}
    parts, launches = [], []
    if layout == "plain":
        padded = torch.as_tensor(S.pad_store(w["store"], n), device=device)
        rows = padded.shape[0] // n
        docs, mask = expand_candidates(t["nodes"], t["valid"],
                                       tab["cluster_of_node"],
                                       tab["cluster_docs"],
                                       tab["cluster_doc_mask"])
        probs = _beam_probs(t["scores"], t["valid"])
        for s in range(n):
            kernels.reset_launch_counts()
            parts.append(S.rerank_shard(
                padded[s * rows:(s + 1) * rows].contiguous(), s, t["q"],
                docs, mask, probs, t["alphas"], TOP_R))
            launches.append(kernels.launch_counts())
        row_to_doc = None
    else:
        quant = layout == "packed int8"
        starts, counts, row_to_doc, cap, shard_rows = pack_layout_sharded(
            trie, n, align=32 if quant else 8)
        full = np.zeros((len(row_to_doc), D), np.float32)
        full[row_to_doc >= 0] = w["store"][row_to_doc[row_to_doc >= 0]]
        full = torch.as_tensor(full, device=device)
        if quant:
            q = quantize_store(full)
            q.scales[torch.as_tensor(row_to_doc < 0, device=device)] = 0
        for s in range(n):
            sl = slice(s * shard_rows, (s + 1) * shard_rows)
            local = (PackedQuantizedStore(q.values[sl].contiguous(),
                                          q.scales[sl].contiguous())
                     if quant else full[sl].contiguous())
            kernels.reset_launch_counts()
            parts.append(S.packed_shard(
                local, s, shard_rows, torch.as_tensor(starts, device=device),
                torch.as_tensor(counts, device=device), cap, t["q"],
                t["nodes"], t["scores"], t["valid"], tab["cluster_of_node"],
                t["alphas"], TOP_R))
            launches.append(kernels.launch_counts())
    scores, payload = padded_top_k(torch.cat([p[0] for p in parts], -1),
                                   torch.cat([p[1] for p in parts], -1),
                                   TOP_R)
    if row_to_doc is not None:
        payload = torch.as_tensor(row_to_doc, device=device)[payload.long()]
    return scores.cpu(), payload.cpu(), launches


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layout", list(SCORER))
def test_shard_bodies_on_the_card_match_cpu(dev, layout, n):
    w = _world()
    want_s, want_ids, _ = _bodies(w, layout, n, torch.device("cpu"))
    got_s, got_ids, launches = _bodies(w, layout, n, dev)
    for counts in launches:       # one launch of the layout's scorer
        assert counts == {**dict.fromkeys(counts, 0), SCORER[layout]: 1}
    ok = want_s > NEG_INF / 2
    assert ok.sum() > 0
    assert torch.equal(got_s > NEG_INF / 2, ok)
    assert torch.equal(got_ids[ok], want_ids[ok])
    torch.testing.assert_close(got_s[ok], want_s[ok], atol=1e-4, rtol=1e-5)
