"""Port vs JAX: retrieval.  Exact kNN, IVF-PQ search on a JAX-built index
carried across with ``repro_torch.bridge.index_from_jax`` (equal ids),
the port's own index (its k-means draws from a torch generator, so it is
held to recall@k instead), and the backends the engine consumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval import backend as jbe
from repro.retrieval import exact as jexact
from repro.retrieval import ivf_pq as jivf
from repro.retrieval import kmeans as jkm
from repro_torch import bridge
from repro_torch.retrieval import backend as tbe
from repro_torch.retrieval import exact as texact
from repro_torch.retrieval import ivf_pq as tivf
from repro_torch.retrieval import kmeans as tkm

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


def _vectors(n=400, d=32, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def jax_index():
    vecs = _vectors()
    idx = jivf.build_index(jax.random.PRNGKey(1), jnp.asarray(vecs),
                           n_lists=20, n_subq=8)
    tidx = bridge.index_from_jax(idx.centroids, idx.codebooks, idx.list_ids,
                                 idx.list_codes, idx.n_vectors, device="cpu")
    return vecs, idx, tidx


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
def test_knn_matches_jax(metric):
    db = _vectors(200, 16, seed=1) * 3.0
    q = _vectors(7, 16, seed=2)
    js, ji = jexact.knn(jnp.asarray(q), jnp.asarray(db), k=5, metric=metric)
    ts, ti = texact.knn(torch.tensor(q), torch.tensor(db), k=5,
                        metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_top_k_breaks_ties_by_lower_index():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = texact.top_k(scores, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0] * 3]
    _, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    assert idx.tolist() == np.asarray(jidx).tolist()


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_wrapper"])
@pytest.mark.parametrize("nprobe,k", [(4, 10), (1, None)],
                         ids=["probe4", "padded_tail"])
def test_search_on_carried_index_gives_jax_ids(jax_index, use_kernel,
                                               nprobe, k):
    """Same index, same queries: equal ids (the padded tail included)."""
    vecs, idx, tidx = jax_index
    q = vecs[:12] + 0.05 * _vectors(12, 32, seed=3)
    padded = k is None
    if padded:                   # a whole list: shorter lists pad with -1
        k = idx.list_ids.shape[1]
    jd, ji = jivf.search(idx, jnp.asarray(q), nprobe=nprobe, k=k)
    td, ti = tivf.search(tidx, torch.tensor(q), nprobe=nprobe, k=k,
                         use_kernel=use_kernel)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    if padded:                         # probed list shorter than k: -1, +inf
        assert (ti.numpy() == -1).any()
        assert np.isinf(td.numpy()[ti.numpy() == -1]).all()


def test_adc_tables_and_pq_codec_match_jax(jax_index):
    vecs, idx, tidx = jax_index
    q = vecs[:3]
    probe = np.asarray([[0, 1], [2, 3], [4, 5]])
    jt = jivf.adc_tables(idx, jnp.asarray(q), idx.centroids[probe])
    tt = tivf.adc_tables(tidx, torch.tensor(q), tidx.centroids[probe])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    books = np.asarray(idx.codebooks)
    jcodes = jkm.pq_encode(jnp.asarray(vecs), jnp.asarray(books))
    tcodes = tkm.pq_encode(torch.tensor(vecs), torch.tensor(books))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(
        tkm.pq_decode(tcodes, torch.tensor(books)).numpy(),
        np.asarray(jkm.pq_decode(jcodes, jnp.asarray(books))), atol=0)


def test_port_built_index_recall(jax_index):
    """The port's own index reaches at least 0.9 of the JAX index's
    recall@10 on the same data."""
    vecs, idx, _ = jax_index
    q = vecs[::10] + 0.1 * _vectors(40, 32, seed=4)
    want = jivf.recall_at_k(idx, jnp.asarray(vecs), jnp.asarray(q), k=10,
                            nprobe=4)
    tidx = tivf.build_index(torch.Generator().manual_seed(1),
                            torch.tensor(vecs), n_lists=20, n_subq=8)
    got = tivf.recall_at_k(tidx, torch.tensor(vecs), torch.tensor(q), k=10,
                           nprobe=4)
    assert tidx.n_lists == 20 and tidx.n_subq == 8
    assert int((tidx.list_ids >= 0).sum()) == len(vecs)
    assert got >= 0.9 * want, (got, want)


def test_kmeans_is_a_lloyd_fixed_point():
    """After convergence each point sits with its nearest centroid and
    each non-empty centroid is the mean of its points."""
    x = torch.tensor(_vectors(300, 8, seed=5))
    cent, assign = tkm.kmeans(torch.Generator().manual_seed(0), x, 6,
                              iters=100, tol=0.0)
    d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)
    assert torch.equal(assign, d2.argmin(-1))
    for c in range(6):
        members = x[assign == c]
        if len(members):
            torch.testing.assert_close(cent[c], members.mean(0),
                                       rtol=1e-4, atol=1e-5)
    assert tkm.train_pq_codebooks(torch.Generator().manual_seed(0),
                                  x[:20], 2).shape == \
        (2, 256, 4)


def test_backends_match_jax(jax_index):
    vecs, idx, tidx = jax_index
    q = vecs[:6]
    je = jbe.ExactBackend(vecs)
    te = tbe.ExactBackend(vecs, device="cpu")
    js, ji = je.search(jnp.asarray(q), 3)
    ts, ti = te.search(torch.tensor(q), 3)
    np.testing.assert_array_equal(ti, ji)
    assert te.bytes_per_query == je.bytes_per_query
    jp = jbe.IVFPQBackend(vecs, nprobe=4)
    tp = tbe.IVFPQBackend.from_index(
        bridge.index_from_jax(jp.index.centroids, jp.index.codebooks,
                              jp.index.list_ids, jp.index.list_codes,
                              jp.index.n_vectors, device="cpu"),
        nprobe=4, device="cpu")
    assert tp.use_kernel is False and tp.nprobe == jp.nprobe
    js, ji = jp.search(jnp.asarray(q), 5)
    ts, ti = tp.search(torch.tensor(q), 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    assert tp.bytes_per_query == jp.bytes_per_query
    assert tbe.measure_scan_bw(tp, torch.tensor(q), k=3, iters=1) > 0


class _Failing:
    name = "broken"
    bytes_per_query = 1.0

    def search(self, queries, k):
        raise tbe.RetrievalError("down")


class _Injector:
    def __init__(self, point):
        self.point = point

    def fire(self, point):
        return True if point == self.point else None


def test_fallback_chain_degrades_like_jax():
    vecs = _vectors(50, 8)
    exact = tbe.ExactBackend(vecs, device="cpu")
    q = torch.tensor(vecs[:2])
    chain = tbe.FallbackBackend([_Failing(), exact])
    _, ids = chain.search(q, 3)
    assert chain.last_level == 1 and chain.metrics["fallbacks"] == 1
    assert chain.name == "broken"
    np.testing.assert_array_equal(ids, exact.search(q, 3)[1])
    chain = tbe.FallbackBackend([exact], injector=_Injector(
        "retrieval_blackout"))
    scores, ids = chain.search(q, 3)
    assert chain.last_level == -1 and (ids == -1).all()
    assert np.isneginf(scores).all()
    with pytest.raises(ValueError):
        tbe.FallbackBackend([])
    with pytest.raises(ValueError, match="unknown retrieval backend"):
        tbe.make_backend("annoy", vecs, device="cpu")
    assert isinstance(tbe.make_backend("ivfpq", vecs, device="cpu"),
                      tbe.IVFPQBackend)
