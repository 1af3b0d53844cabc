"""Port vs JAX: the paged KV pool.  One sequence of pool operations --
alloc, content-addressed ``write_prefix`` (with a shared prefix),
``prepare_append`` with copy-on-extend, release, eviction under page
pressure, export and import -- runs on both pools, which must end with
equal page tables, refcounts, metrics, page bytes and handoff checksums.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro.serving import kv_cache as jkv
from repro_torch import bridge
from repro_torch.models import transformer as tr
from repro_torch.serving import kv_cache as tkv

FIELDS = dict(name="pg", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_head=8, d_ff=64, vocab_size=64)

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)


def _pools(**kw):
    return (jkv.PagedKVCachePool(jtr.TransformerConfig(**FIELDS), **kw),
            tkv.PagedKVCachePool(tr.TransformerConfig(**FIELDS),
                                 device="cpu", **kw))


def _prefill(p, seed):
    """A fabricated prefill product (L, 1, P, H_kv, D) in bf16, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (FIELDS["n_layers"], 1, p, FIELDS["n_kv_heads"],
             FIELDS["d_head"])
    return {k: rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
            for k in ("k", "v")}


def _bits(a) -> np.ndarray:
    """bf16 bits of a JAX array or a port tensor as uint16."""
    if isinstance(a, torch.Tensor):
        return tkv.to_host(a).view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _assert_same(jp, tp):
    assert tp.page_tables == jp.page_tables
    np.testing.assert_array_equal(tp.ref, jp.ref)
    np.testing.assert_array_equal(tp.lengths, jp.lengths)
    assert tp.metrics == jp.metrics
    assert tp.free == jp.free and tp.free_pages == jp.free_pages
    assert tp.prefix_index == jp.prefix_index
    assert list(tp._evictable) == list(jp._evictable)
    np.testing.assert_array_equal(tp.block_tables(), jp.block_tables())
    for k in ("k", "v"):
        np.testing.assert_array_equal(_bits(tp.cache[k]),
                                      _bits(jp.cache[k]))


def _both(jp, tp, method, *args, cache=None, **kw):
    if cache is not None:
        ja = ({k: jnp.asarray(v) for k, v in cache.items()},)
        ta = ({k: bridge.tensor_from_numpy(v) for k, v in cache.items()},)
    else:
        ja = ta = ()
    rj = getattr(jp, method)(*args[:1], *ja, *args[1:], **kw)
    rt = getattr(tp, method)(*args[:1], *ta, *args[1:], **kw)
    return rj, rt


def test_pool_operation_sequence_matches_jax():
    jp, tp = _pools(n_slots=3, s_max=12, page_size=4, spare_pages=1)
    prompt = np.arange(11, dtype=np.int32)
    pre = _prefill(11, seed=0)
    a = _both(jp, tp, "alloc", 100)
    assert a[0] == a[1]
    _both(jp, tp, "write_prefix", a[0], 11, cache=pre, tokens=prompt,
          key_salt=b"16")
    b = _both(jp, tp, "alloc", 101)
    # same prompt, same bucket: the two full pages are shared
    _both(jp, tp, "write_prefix", b[0], 11, cache=pre, tokens=prompt,
          key_salt=b"16")
    _assert_same(jp, tp)
    assert tp.metrics["pages_shared"] == 2
    # appending into a shared, content-addressed page copies it first
    tp.lengths[b[1]] = jp.lengths[b[0]] = 6
    _both(jp, tp, "prepare_append", b[0], 5)
    _assert_same(jp, tp)
    assert tp.metrics["pages_cow"] >= 1
    _both(jp, tp, "advance", [a[0]])
    np.testing.assert_array_equal(np.asarray(jp.positions()),
                                  tp.positions().numpy())
    # export/import round trip + checksums over identical bytes
    (jpre, jlen), (tpre, tlen) = _both(jp, tp, "export_slot", a[0])
    assert jlen == tlen and jpre.keys == tpre.keys
    assert jkv.payload_checksum(jpre) == tkv.payload_checksum(tpre)
    assert jkv.payload_nbytes(jpre) == tkv.payload_nbytes(tpre)
    assert jkv.payload_summary(jpre, jlen) == tkv.payload_summary(tpre,
                                                                  tlen)
    # release both sharers: keyed pages stay cached, then page pressure
    # evicts them in LRU order
    _both(jp, tp, "release", a[0])
    _both(jp, tp, "release", b[0])
    _assert_same(jp, tp)
    for rid, seed in ((102, 1), (103, 2), (104, 3)):
        s = _both(jp, tp, "alloc", rid)
        _both(jp, tp, "write_prefix", s[0], 9, cache=_prefill(9, seed),
              tokens=np.arange(seed, seed + 9, dtype=np.int32))
    _assert_same(jp, tp)
    assert tp.metrics["pages_evicted"] > 0
    # import into fresh pools: equal stats, bytes and tables
    jq, tq = _pools(n_slots=2, s_max=32, page_size=4)
    js, ts = jq.alloc(7), tq.alloc(7)
    stats_j = jq.import_slot(js, jpre)
    stats_t = tq.import_slot(ts, tpre)
    assert tuple(stats_j) == tuple(stats_t)
    _assert_same(jq, tq)


def test_import_rejects_what_jax_rejects():
    _, tp = _pools(n_slots=1, s_max=8, page_size=4)
    slot = tp.alloc(0)
    with pytest.raises(TypeError):
        tp.import_slot(slot, {"k": None, "v": None}, 4)
    with pytest.raises(ValueError, match="page_size"):
        tp.import_slot(slot, tkv.PagedPrefix(8, 4, [None], {}))
    with pytest.raises(ValueError, match="s_max"):
        tp.import_slot(slot, tkv.PagedPrefix(4, 12, [None] * 3, {}))
    with pytest.raises(AssertionError, match="s_max"):
        tp.prepare_append(slot, 9)


def test_pool_needs_a_device_it_can_use():
    """Without ``device="cpu"`` the pool asks for the GPU and refuses to
    fall back to the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.PagedKVCachePool(tr.TransformerConfig(**FIELDS), n_slots=1,
                             s_max=8)


def test_host_copies_keep_bf16_bits():
    t = torch.randn(3, 5).to(torch.bfloat16)
    host = tkv.to_host(t)
    assert host.dtype == np.int16
    back = tkv.from_host(host, torch.bfloat16, "cpu")
    assert torch.equal(back, t)
    as_ml = host.view(ml_dtypes.bfloat16)
    assert torch.equal(tkv.from_host(as_ml, torch.bfloat16, "cpu"), t)
