"""The dense decode kernel's partial entry (one rank's shard of a split-K
decode: ``ops.decode_attention_partial``).

* On the CPU: the wrapper takes its plain version,
  ``ref.local_decode_attn_ref``, which mirrors JAX's
  ``_local_decode_attn`` (held against it in
  ``test_torch_distributed.py``); the shards' partials, combined as
  ``distributed/decode_attn.py`` combines them, give
  ``decode_attention_ref`` on the whole cache (float32, ``1e-6``); a
  shard with nothing visible gives m = -inf, l = 0, acc = 0 exactly.
* On a GPU only (marker ``cuda``): the kernel against its plain version
  over shards that are empty (offset at or past the length), partly and
  wholly visible, S a multiple of the tile and not, one split (the split
  writes the partials itself) and several (the merge pass writes them),
  G of 4, 8 and 16, D of 64 and 128, bf16 and f32.  m and l to ``1e-5``
  in float32 (relative), acc / l to ``1e-5``; bf16 ``2e-2`` (the plain
  version scores in bf16 and rounds p to bf16 before P V, as JAX's does;
  the kernel keeps both in float32).  Empty rows exactly -inf / 0 / 0.

Run the GPU part with ``python -m pytest -m cuda
tests/test_torch_decode_partial.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      local_decode_attn_ref)

torch.set_num_threads(1)

TOL = {"bf16": 2e-2, "f32": 1e-5}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, s, h_kv, g, d, dtype, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h_kv * g, d), np.float32)
    k = rng.standard_normal((b, s, h_kv, d), np.float32)
    v = rng.standard_normal((b, s, h_kv, d), np.float32)
    return tuple(torch.tensor(a).to(TDT[dtype]).to(device) for a in (q, k, v))


def _combine(parts):
    """The ranks' combine of ``distributed/decode_attn.py``."""
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    m_safe = torch.where(torch.isfinite(m_g), m_g, 0.0)
    out, l_g = 0, 0
    for acc, m, l in parts:
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        out = out + acc * corr[..., None]
        l_g = l_g + l * corr
    return out / torch.clamp(l_g, min=1e-30)[..., None]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_plain_partials_combine_to_the_whole(n_shards):
    b, s, h_kv, g, d = 4, 48, 2, 4, 16
    q, k, v = _inputs(b, s, h_kv, g, d, "f32")
    lens = torch.tensor([0, 1, 30, 48], dtype=torch.int32)
    s_loc = s // n_shards
    parts = [da.decode_attention_partial(
        q, k[:, i * s_loc:(i + 1) * s_loc].contiguous(),
        v[:, i * s_loc:(i + 1) * s_loc].contiguous(), lens, i * s_loc)
        for i in range(n_shards)]
    got = _combine(parts)
    want = decode_attention_ref(q[:, 0].reshape(b, h_kv, g, d), k, v, lens)
    np.testing.assert_allclose(got.numpy(),
                               want.reshape(b, h_kv * g, d).numpy(),
                               rtol=1e-6, atol=1e-6)
    # a shard past a row's length: -inf / 0 / 0 exactly
    acc, m, l = parts[-1]
    if n_shards > 1:
        assert torch.isneginf(m[1]).all() and (l[1] == 0).all()
        assert (acc[1] == 0).all()
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all()


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = _inputs(2, 20, 2, 4, 16, "bf16")
    lens = torch.tensor([7, 30], dtype=torch.int32)
    before = da.decode_attention_partial.launches
    got = da.decode_attention_partial(q, k, v, lens, 5)
    want = local_decode_attn_ref(q, k, v, lens, 5, 4)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert da.decode_attention_partial.launches == before


def _check(got, want, dtype):
    (acc, m, l), (racc, rm, rl) = got, want
    empty = rl == 0
    assert torch.equal(torch.isneginf(m), torch.isneginf(rm))
    assert torch.isneginf(m[empty]).all() and (l[empty] == 0).all()
    assert (acc[empty] == 0).all()
    tol = TOL[dtype]
    live = ~empty
    torch.testing.assert_close(m[live], rm[live], rtol=tol, atol=tol)
    torch.testing.assert_close(l[live], rl[live], rtol=tol, atol=tol)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               racc[live] / rl[live][..., None],
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [4, 8, 16])
def test_partial_kernel_matches_plain(cuda, dtype, d, g):
    h_kv = 2
    for b, s, offset, lens in (
            (3, 1000, 0, [0, 1, 999]),             # S not a tile multiple
            (3, 1000, 1000, [999, 1000, 2500]),    # empty, empty, whole
            (4, 256, 512, [600, 0, 768, 700]),     # partial, offset past
            (1, 40_000, 20_000, [45_000]),         # several splits
            (8, 64, 64, [100, 64, 65, 0, 128, 127, 1, 90])):
        q, k, v = _inputs(b, s, h_kv, g, d, dtype, device=cuda)
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = da.decode_attention_partial(q, k, v, ln, offset)
        torch.cuda.synchronize()
        want = local_decode_attn_ref(q, k, v, ln, offset, g)
        _check(got, want, dtype)


@pytest.mark.cuda
def test_partial_kernel_counts_and_refuses(cuda):
    q, k, v = _inputs(2, 64, 2, 4, 64, "bf16", device=cuda)
    ln = torch.tensor([10, 64], dtype=torch.int32, device=cuda)
    before = da.decode_attention_partial.launches
    da.decode_attention_partial(q, k, v, ln, 0)
    assert da.decode_attention_partial.launches == before + 1
    with pytest.raises(TypeError):
        da.decode_attention_partial(q, k, v, ln.long(), 0)
    with pytest.raises(ValueError):
        da.decode_attention_partial(q, k, v, ln.cpu(), 0)
    with pytest.raises(ValueError):
        da.decode_attention_partial(q, k, v, ln, -1)
    assert math.isfinite(float(da.decode_attention_partial(
        q, k, v, ln, 0)[1].max()))
