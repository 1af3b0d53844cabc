"""The port's flash attention: its plain version against the JAX package on
the CPU, the model's full-sequence path through it, and (on a GPU only)
the CUDA kernel against the plain version.

* The plain version (``flash_attention_ref``) against JAX's
  ``repro.kernels.flash_attention.ops.flash_attention`` -- the Pallas
  kernel in interpret mode behind its wrapper's KV repeat and S padding --
  at ``tests/test_kernels.py``'s sweep (S 64/100/128/96/257; GQA 4:4, 4:2,
  8:1; causal and full; bf16), and against ``flash_attention_pallas``
  called directly with ``kv_len < S``.  Both keep f32 softmax statistics
  and sum in other orders: float32 agrees to ``2e-5``; bf16 to one bf16
  step of an output of order one (``2e-2``), since both round an f32
  result once.
* ``forward`` and ``encode`` with the plain flash op against JAX's
  ``forward``/``encode`` at ``compute_dtype=float32``, on a tiny causal GQA
  generator (the naive and the chunked JAX paths) and a tiny bidirectional
  encoder.  With f32 probabilities the two differ only in summation
  order (``2e-5``).
* A ``"cuda"`` engine hands the flash op to prefill, the encoder and
  every executor, and the dense decode op to greedy generation.

Tests marked ``cuda`` need a card and skip without one; run them on a GPU
with ``python -m pytest -m cuda tests/test_torch_flash.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_attention)
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import transformer as tr

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

TOL = {"bf16": 2e-2, "f32": 2e-5}
JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(b, s, h, h_kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, h_kv, d)).astype(np.float32),
            rng.standard_normal((b, s, h_kv, d)).astype(np.float32))


def _jax_bits(x, dt):
    """numpy -> JAX array in ``dt`` -> float32 numpy (the rounded inputs
    both sides see)."""
    return np.asarray(jnp.asarray(x, JDT[dt]).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Plain version vs the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's flash sweep (B=2, blocks of 32), plus bf16
SWEEP = [(64, 4, 4, 32, True, "f32"), (100, 4, 2, 16, True, "f32"),
         (128, 8, 1, 64, True, "f32"), (96, 2, 2, 32, False, "f32"),
         (257, 4, 4, 32, True, "f32"), (64, 2, 2, 32, True, "bf16"),
         (100, 4, 2, 16, False, "bf16")]


@pytest.mark.parametrize("s,h,h_kv,d,causal,dt", SWEEP)
def test_plain_version_matches_jax_kernel(s, h, h_kv, d, causal, dt):
    q, k, v = (_jax_bits(x, dt) for x in _qkv(2, s, h, h_kv, d))
    want = jax_flash_attention(*(jnp.asarray(x, JDT[dt]) for x in (q, k, v)),
                               causal=causal, block_q=32, block_k=32)
    got = flash_attention_ref(*(torch.tensor(x).to(TDT[dt])
                                for x in (q, k, v)), causal=causal)
    assert got.dtype == TDT[dt] and got.shape == (2, s, h, d)
    np.testing.assert_allclose(bridge.tensor_to_numpy(got),
                               np.asarray(want, np.float32), rtol=0,
                               atol=TOL[dt])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_version_matches_pallas_kv_len(causal):
    """The Pallas kernel called directly, with keys from ``kv_len`` on
    masked: (BH, S, D) is (B, S, 1, D) to the port."""
    bh, s, d, kv_len = 3, 64, 32, 41
    q, k, v = (x[:, :, 0] for x in _qkv(bh, s, 1, 1, d, seed=3))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=32,
                                  block_k=32, kv_len=kv_len, interpret=True)
    got = flash_attention_ref(*(torch.tensor(x[:, :, None])
                                for x in (q, k, v)), causal=causal,
                              kv_len=kv_len)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want),
                               rtol=0, atol=TOL["f32"])


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version and leaves the launch count
    alone; the launcher refuses CPU tensors outright."""
    fa.flash_attention.launches = 0
    q, k, v = map(torch.tensor, _qkv(1, 9, 4, 2, 16))
    got = fa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, False))
    assert fa.flash_attention.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# The model's full-sequence path through the flash op vs JAX
# ---------------------------------------------------------------------------

def _models(causal, **kw):
    cfg = jtr.TransformerConfig(name="fl", n_layers=2, d_model=32,
                                n_heads=4, n_kv_heads=2 if causal else 4,
                                d_head=8, d_ff=48, vocab_size=64,
                                causal=causal, **kw)
    jp = jtr.init_params(jax.random.PRNGKey(7), cfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return cfg, jp, bridge.config_from_jax(dataclasses.asdict(cfg)), tp


@pytest.mark.parametrize("threshold", [2048, 16], ids=["naive", "chunked"])
def test_forward_through_flash_matches_jax(threshold):
    """A causal GQA generator; at threshold 16 JAX takes its chunked
    online-softmax path (S=40 in blocks of 16)."""
    jcfg, jp, tcfg, tp = _models(True, chunked_attn_threshold=threshold,
                                 attn_block_kv=16)
    tokens = np.random.default_rng(1).integers(0, 64, (2, 40)).astype(
        np.int32)
    jl, _, jcache = jtr.forward(jp, jnp.asarray(tokens), jcfg, jnp.float32,
                                collect_cache=True)
    tl, _, tcache = tr.forward(tp, torch.tensor(tokens), tcfg, torch.float32,
                               collect_cache=True,
                               attn_impl=fa.flash_attention)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL["f32"])
    for key in ("k", "v"):          # the cache comes before attention
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=0,
                                   atol=TOL["f32"])


def test_encode_through_flash_matches_jax():
    jcfg, jp, tcfg, tp = _models(False)
    tokens = np.random.default_rng(2).integers(0, 64, (3, 24)).astype(
        np.int32)
    want = jtr.encode(jp, jnp.asarray(tokens), jcfg)
    got = tr.encode(tp, torch.tensor(tokens), tcfg,
                    attn_impl=fa.flash_attention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["f32"])


def test_engine_hands_its_attention_ops_to_the_executors():
    """``attn_impl="cuda"`` gives the flash op to prefill, the encoder and
    every executor, and the dense decode op to greedy generation;
    ``"ref"`` gives none."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.serving import engine as te
    _, _, gcfg, gp = _models(True)
    _, _, ecfg, ep = _models(False)
    gen, enc = te.Component(gcfg, gp), te.Component(ecfg, ep)
    corpus = np.random.default_rng(0).integers(0, 64, (8, 6)).astype(
        np.int32)
    for impl, seq, dec in (("cuda", fa.flash_attention, decode_attention),
                           ("ref", None, None)):
        cfg = te.EngineConfig(attn_impl=impl, rewrite_tokens=2,
                              fanout_queries=2, rerank=True,
                              safety_threshold=0.0)
        eng = te.RAGEngine(gen, enc, corpus, cfg, rewriter=gen,
                           reranker=enc, safety=enc, device="cpu")
        assert (eng.seq_attn, eng.dense_attn) == (seq, dec)
        ex = {e.name: e for e in eng.executors}
        for name in ("rewrite", "multi_query"):
            assert ex[name]._gen.attn_impl is seq
            assert ex[name]._gen.decode_attn_impl is dec
        for name in ("rerank", "safety_filter"):
            assert ex[name]._encode.attn_impl is seq


def test_sliding_window_has_no_flash_path():
    _, _, tcfg, tp = _models(True, attention="sliding_window", window=8)
    tokens = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sliding window"):
        tr.forward(tp, tokens, tcfg, torch.float32,
                   attn_impl=fa.flash_attention)
    tr.forward(tp, tokens, tcfg, torch.float32)       # the reference runs


# ---------------------------------------------------------------------------
# On a GPU: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

#: (B, S, H, H_kv, D, kv_len): ragged S against the kernel's 64-row and
#: 32-key tiles, GQA ratios, every head width, and a kv_len mask
CUDA_CASES = {
    "prefill": (1, 1024, 32, 8, 64, None),
    "encoder": (4, 256, 12, 12, 64, None),
    "ragged": (2, 257, 4, 2, 32, None),
    "short": (3, 5, 8, 1, 16, None),
    "wide": (1, 200, 4, 4, 128, None),
    "kv_len": (2, 100, 4, 2, 64, 37),
}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernel_matches_plain_version(cuda, case, dt, causal):
    b, s, h, h_kv, d, kv_len = CUDA_CASES[case]
    q, k, v = (torch.tensor(x, device=cuda).to(TDT[dt])
               for x in _qkv(b, s, h, h_kv, d))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal, kv_len)
    want = flash_attention_ref(q, k, v, causal, kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dt] if dt == "bf16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_kernel_zeros_a_row_with_no_visible_key(cuda):
    q, k, v = (torch.tensor(x, device=cuda) for x in _qkv(1, 40, 2, 2, 16))
    assert not fa.flash_attention_cuda(q, k, v, False, 0).any()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = (torch.tensor(x, device=cuda) for x in _qkv(1, 40, 4, 2, 16))
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k[:, :20], v[:, :20])
    with pytest.raises(ValueError):                  # 4 heads over 3
        fa.flash_attention_cuda(q, *(torch.cat([x, x[:, :, :1]], 2)
                                     for x in (k, v)))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(*(x[..., :8].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(k.numel() + 1, device=cuda)
        fa.flash_attention_cuda(q, flat[1:].view(k.shape), v)
