"""The port's k-means (``gdr_tpu_torch/ops/kmeans.py``) against ``gdr_tpu``'s.

Torch and JAX draw different random numbers, so the draws are injected:
``gdr_tpu``'s k-means++ centroids (its ``iters=0`` fit) start the port's
Lloyd; its minibatch seed and batch indices, replayed eagerly as
``_minibatch_core`` makes them, drive the port's minibatch.  The
small-corpus host path is a copy and gives the same paths bit for bit; the
device recursion gives the same paths when both packages' group fits are
replaced by one deterministic function.  Under the port's own draws the
invariants hold: every doc has a path, leaves respect the cap, a seed
repeats its paths, identical points still split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdr_tpu.ops import kmeans as jax_kmeans
from gdr_tpu_torch.ops import kmeans


def _points(n: int, d: int, seed: int, clusters: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(clusters, d)) * 3
    return (centres[rng.integers(0, clusters, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d,k,iters,pad", [
    (300, 8, 5, 10, 20),          # padded rows masked out
    (64, 16, 30, 25, 0),          # k near n: clusters empty out and stay put
    (200, 4, 3, 0, 7),            # no iteration: the assignment to the init
])
def test_lloyd_from_injected_init_matches_gdr_tpu(n, d, k, iters, pad):
    x = _points(n, d, seed=n)
    mask = np.arange(n) < n - pad
    key = jax.random.PRNGKey(n + k)
    init, _ = jax_kmeans.kmeans_fit(x, mask, k=k, iters=0, key=key)
    want_c, want_a = jax_kmeans.kmeans_fit(x, mask, k=k, iters=iters, key=key)
    got_c, got_a = kmeans.kmeans_fit(torch.as_tensor(x), k, iters,
                                     init=torch.as_tensor(np.array(init)),
                                     mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def _jax_minibatch_draws(key, n: int, k: int, iters: int, batch: int):
    """``_minibatch_core``'s draws over an all-real mask, eagerly."""
    probs0 = jnp.ones(n) / n
    key0, key_seq = jax.random.split(key)
    seed_idx = jax.random.choice(key0, n, shape=(k,), replace=False, p=probs0)
    batches = []
    for _ in range(iters):
        key_seq, sub = jax.random.split(key_seq)
        batches.append(jax.random.choice(sub, n, shape=(batch,), p=probs0))
    return np.array(seed_idx), np.stack([np.asarray(b) for b in batches])


@pytest.mark.parametrize("n,d,k,iters,batch", [(1500, 8, 30, 25, 1024),
                                               (400, 6, 5, 7, 64)])
def test_minibatch_with_replayed_draws_matches_gdr_tpu(n, d, k, iters, batch):
    x = _points(n, d, seed=7)
    x /= np.linalg.norm(x, axis=1, keepdims=True)      # unit rows, as a store
    key = jax.random.PRNGKey(11)
    want_c, want_a = jax_kmeans.kmeans_fit_minibatch(
        x, np.ones(n, bool), k=k, iters=iters, batch_size=batch, key=key)
    seed_idx, batch_idx = _jax_minibatch_draws(key, n, k, iters, batch)
    got_c, got_a = kmeans.kmeans_fit_minibatch(
        torch.as_tensor(x), k, iters, batch, seed_idx=seed_idx,
        batch_idx=batch_idx)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_batched_fits_equal_each_cluster_alone():
    # G padded clusters in one batched product give each cluster's own fit
    sizes, d, k = (50, 31, 77), 5, 4
    xs = [_points(s, d, seed=s) for s in sizes]
    b = max(sizes)
    X = torch.as_tensor(np.concatenate(xs))
    starts = np.cumsum((0,) + sizes[:-1])
    idx = torch.zeros(len(sizes), b, dtype=torch.long)
    for j, (s, n) in enumerate(zip(starts, sizes)):
        idx[j, :n] = torch.arange(s, s + n)
    counts = torch.as_tensor(sizes)
    w = kmeans._real_weights(counts, b)
    init = torch.stack([torch.as_tensor(x[:k]) for x in xs])
    cent, assign = kmeans._lloyd(X[idx], w, init, 9)
    batch_idx = torch.stack([
        torch.randint(0, n, (6, 16), generator=torch.Generator().manual_seed(n))
        for n in sizes])
    mb_cent, mb_assign = kmeans._minibatch(X[idx], init, batch_idx)
    for j, (x, n) in enumerate(zip(xs, sizes)):
        c, a = kmeans.kmeans_fit(torch.as_tensor(x), k, 9, init=init[j])
        torch.testing.assert_close(cent[j], c, rtol=0, atol=1e-6)
        assert torch.equal(assign[j, :n], a)
        c, a = kmeans.kmeans_fit_minibatch(torch.as_tensor(x), k, 6, 16,
                                           seed_idx=torch.arange(k),
                                           batch_idx=batch_idx[j])
        torch.testing.assert_close(mb_cent[j], c, rtol=0, atol=1e-6)
        assert torch.equal(mb_assign[j, :n], a)


@pytest.mark.parametrize("suffix", [False, True], ids=["gdr", "nci"])
@pytest.mark.parametrize("n,d,kary,leaf_cap", [(500, 8, 4, 8),
                                               (1500, 16, 30, 30)])
def test_small_corpus_paths_equal_gdr_tpu(n, d, kary, leaf_cap, suffix):
    x = _points(n, d, seed=3)
    want = jax_kmeans.hierarchical_kmeans(x, kary, leaf_cap, iters=10,
                                          seed=5, doc_level_suffix=suffix)
    for store in (x, torch.as_tensor(x)):
        assert kmeans.hierarchical_kmeans(store, kary, leaf_cap, iters=10,
                                          seed=5, doc_level_suffix=suffix,
                                          device="cpu") == want
    assert kmeans.paths_to_cid_mapping(want) == \
        jax_kmeans.paths_to_cid_mapping(want)


def _shared_fit(points: np.ndarray, n_real: np.ndarray, k: int) -> np.ndarray:
    """A deterministic stand-in for a group fit: each real row's digit from
    its first coordinate and position; clusters under 64 points put every
    row in one cluster, which takes the round-robin fallback."""
    pos = np.arange(points.shape[1])[None]
    a = (np.floor(np.abs(points[..., 0]) * 7919).astype(np.int64) + pos) % k
    a[n_real < 64] = 0
    return a


@pytest.mark.parametrize("threshold,suffix", [(0, False), (3000, False),
                                              (3000, True)])
def test_device_recursion_equals_gdr_tpu_under_a_shared_fit(
        monkeypatch, threshold, suffix):
    x = _points(20_000, 3, seed=9)

    def jax_fit(X, idx, masks, k, iters, *rest):
        idx = np.asarray(idx)
        return _shared_fit(np.asarray(X)[idx], np.asarray(masks).sum(1), k)

    def port_fit(X, idx, counts, k, iters, *rest):
        return torch.as_tensor(_shared_fit(X[idx].numpy(), counts.numpy(), k))

    for mod, fit in ((jax_kmeans, jax_fit), (kmeans, port_fit)):
        monkeypatch.setattr(mod, "_fit_gather_batch", fit)
        monkeypatch.setattr(mod, "_fit_gather_minibatch_batch", fit)
    kw = dict(kary=30, leaf_cap=30, iters=3, seed=1, doc_level_suffix=suffix,
              minibatch_threshold=threshold)
    want = jax_kmeans.hierarchical_kmeans(x, **kw)
    got = kmeans.hierarchical_kmeans(x, device="cpu", **kw)
    assert got == want
    assert len({len(p) for p in got}) > 1      # leaves at several depths


def _check_tree(paths, n, kary, leaf_cap, max_depth=8):
    mapping = kmeans.paths_to_cid_mapping(paths)
    assert sum(len(v) for v in mapping.values()) == n
    assert all(p for p in paths)                         # no doc at the root
    assert all(0 <= c < kary for p in paths for c in p)
    for cid, docs in mapping.items():
        assert len(docs) <= leaf_cap or cid.count("-") + 1 == max_depth
    cids = sorted(mapping)
    assert not any(b.startswith(a + "-") for a, b in zip(cids, cids[1:]))


def test_device_recursion_invariants_under_the_ports_draws():
    x = _points(20_000, 8, seed=4, clusters=40)
    kw = dict(kary=30, leaf_cap=30, iters=5, minibatch_threshold=1000,
              device="cpu")
    paths = kmeans.hierarchical_kmeans(x, seed=7, **kw)
    _check_tree(paths, len(x), 30, 30)
    assert kmeans.hierarchical_kmeans(x, seed=7, **kw) == paths
    assert kmeans.hierarchical_kmeans(x, seed=8, **kw) != paths


@pytest.mark.parametrize("n,threshold", [(500, 100), (20_000, 0)],
                         ids=["minibatch", "lloyd"])
def test_identical_points_still_split(n, threshold):
    x = np.ones((n, 2), np.float32)
    paths = kmeans.hierarchical_kmeans(x, 30, 30, iters=3,
                                       minibatch_threshold=threshold,
                                       device="cpu")
    _check_tree(paths, n, 30, 30)
    assert [p[0] for p in paths[:31]] == list(range(30)) + [0]  # round-robin


def test_draws_need_a_generator_and_the_card_must_exist():
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="generator"):
        kmeans.kmeans_fit(x, 3, 2)
    with pytest.raises(ValueError, match="generator"):
        kmeans.kmeans_fit_minibatch(x, 3, 2, 4, seed_idx=torch.arange(3))
    g = torch.Generator().manual_seed(0)
    a = kmeans.kmeans_fit(torch.as_tensor(_points(90, 3, 0)), 4, 5,
                          generator=g)
    b = kmeans.kmeans_fit(torch.as_tensor(_points(90, 3, 0)), 4, 5,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmeans.hierarchical_kmeans(np.zeros((20_000, 2), np.float32), 30, 30)
