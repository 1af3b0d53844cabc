"""Port vs JAX: the decode steps' cache writes, which drop rows on the
device as JAX does, with no read of the device from the host.

JAX scatters every row and drops the out-of-bounds ones
(``mode="drop"``); the port writes in place with its indices kept in
bounds on the device:

* dense ``decode_step``: row b writes at ``min(pos, S_max - 1)`` of its
  own row, the bytes already there when it is dropped (``pos == S_max``
  or ``write_mask`` False);
* ``paged_decode_step``: a dropped row (``write_mask`` False, or its
  position past the table) repeats the write of the first kept row, and
  with no kept row every row writes back the bytes at row 0's target.
  An idle slot's table is zeros, so its own clamped target may be a live
  row's target: the cases below put a dropped row on one.

Both steps run on the tiny config of ``tests/test_torch_model.py``
against ``jtr.decode_step`` / ``jtr.paged_decode_step`` on the same numpy
inputs.  Tolerances: logits and the written cache rows to ``1e-5`` in
f32 and ``BF16_TOL`` in bf16 (see ``tests/test_torch_model.py``); every
byte that JAX leaves alone is bit-equal to the input.  JAX's dense step
has no mask: its engine merges the old cache back into the rows that do
not step, and so does the comparison here.  A ``TorchDispatchMode``
fails either step on any op whose output shape depends on data or that
reads a scalar (``aten.nonzero``, ``aten.masked_select``,
``aten._local_scalar_dense``, ...): on the card each is a sync.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import transformer as tr

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 6e-2          # see tests/test_torch_model.py
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
L, H_KV, D = 2, 2, 16
S_MAX = 16                      # dense cache positions
PAGE, M, N_PAGES = 4, 3, 12     # paged pool


@pytest.fixture(scope="module")
def model():
    jcfg = jtr.TransformerConfig(name="tiny", n_layers=L, d_model=48,
                                 n_heads=4, n_kv_heads=H_KV, d_head=D,
                                 d_ff=64, vocab_size=96)
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = bridge.config_from_jax(dataclasses.asdict(jcfg))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


aten = torch.ops.aten
#: ops tagged with a data-dependent shape only for a boolean index
_INDEX_OPS = (aten.index.Tensor, aten.index_put.default,
              aten.index_put_.default, aten._index_put_impl_.default)


class NoHostRead(TorchDispatchMode):
    """Raises on an op whose output shape depends on the data or that
    reads a value to the host (its op tags say so; an indexing op only
    with a boolean index); keeps the names of the ops it saw."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(str(func))
        if func in _INDEX_OPS:
            host = any(i is not None and i.dtype in (torch.bool, torch.uint8)
                       for i in args[1])
        else:
            host = (torch.Tag.dynamic_output_shape in func.tags
                    or torch.Tag.data_dependent_output in func.tags)
        if host:
            raise AssertionError(f"{func} reads the device from the host")
        return func(*args, **(kwargs or {}))


def _f32(t) -> np.ndarray:
    return bridge.tensor_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol: float) -> None:
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _cache(shape, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _check_cache(tc: dict, before: dict, jc: dict, written: np.ndarray,
                 tol: float) -> None:
    """The whole post-step cache against JAX's; ``written`` (the cache's
    leading dims but the last two) marks the rows JAX writes: every other
    byte equals the input's."""
    for k in ("k", "v"):
        got, want = _f32(tc[k]), _f32(jc[k])
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        same = ~written
        assert np.array_equal(got[same], _f32(before[k])[same]), k
        assert np.array_equal(want[same], _f32(before[k])[same]), k
        # and JAX does write those rows (the step is not a no-op there)
        assert not np.array_equal(want[written], _f32(before[k])[written])


# ---------------------------------------------------------------------------
# Dense decode_step
# ---------------------------------------------------------------------------

DENSE_CASES = {
    # row 1 at pos == S_max (JAX drops it out of bounds), row 2 masked,
    # row 3 at the last position
    "mixed": ([6, S_MAX, 3, S_MAX - 1], [True, True, False, True]),
    "no_mask": ([0, 9, S_MAX, 2], None),
    "none_kept": ([4, S_MAX, 7, 0], [False, True, False, False]),
}


def _dense_step(model, dt, pos, mask, seed=1):
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    cache = _cache((L, len(pos), S_MAX, H_KV, D), seed)
    token = np.asarray([3, 5, 7, 90], np.int32)
    pos = np.asarray(pos, np.int32)
    jl, jc = jtr.decode_step(
        jparams, {k: jnp.asarray(v, jdt) for k, v in cache.items()},
        jnp.asarray(token), jnp.asarray(pos), jcfg, jdt)
    keep = np.ones(len(pos), bool) if mask is None else np.asarray(mask)
    # JAX's engine merges the old cache back into the rows not stepping
    old = {k: jnp.asarray(v, jdt) for k, v in cache.items()}
    jc = {k: jnp.where(jnp.asarray(keep)[None, :, None, None, None],
                       jc[k], old[k]) for k in jc}
    tcache = {k: torch.tensor(v).to(tdt) for k, v in cache.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    tl, tc = tr.decode_step(
        tparams, tcache, torch.tensor(token), torch.tensor(pos), tcfg, tdt,
        write_mask=None if mask is None else torch.tensor(keep))
    assert tc is tcache                        # written in place
    written = np.zeros((L, len(pos), S_MAX), bool)
    rows = keep & (pos < S_MAX)
    written[:, rows, pos[rows]] = True
    return jl, tl, jc, tc, before, written, keep, tol


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_decode_step_drops_rows_as_jax(model, dt, case):
    pos, mask = DENSE_CASES[case]
    jl, tl, jc, tc, before, written, keep, tol = _dense_step(
        model, dt, pos, mask)
    # a masked row attends over the bytes it did not write; JAX's
    # unmasked step attends over its new K/V there: those logits are the
    # engine's to ignore
    _close(tl[keep], np.asarray(jl, np.float32)[keep], tol)
    if written.any():
        _check_cache(tc, before, jc, written, tol)
    else:
        for k in ("k", "v"):
            assert torch.equal(tc[k], before[k])


# ---------------------------------------------------------------------------
# paged_decode_step
# ---------------------------------------------------------------------------

# rows: 0 live (target page 5, offset 1); 1 live on page 0 (offset 1);
# 2 idle, table zeros, its own clamped target page 0 offset 1 = row 1's;
# 3 at a position past its table, whose clamped target is row 0's; 4
# live.  Each aliasing row comes after the row it aliases, so a write of
# its own old bytes there would land last on the CPU.
TABLES = np.asarray([[2, 5, 7], [0, 3, 4], [0, 0, 0], [8, 9, 5],
                     [6, 10, 11]], np.int32)
ALIASED_POS = [5, 1, 1, M * PAGE + 1, 8]
PAGED_CASES = {
    "aliased": (ALIASED_POS, [True, True, False, True, True]),
    # every row kept but row 3: row 2's own position, not row 1's
    "no_mask": ([5, 1, 2, M * PAGE + 1, 8], None),
    "none_kept": (ALIASED_POS, [False, False, False, True, False]),
    # the first kept row is row 1, aliased by the idle row after it
    "first_kept_late": ([5, 1, 1, 0, 8], [False, True, False, False, False]),
}


def _paged_step(model, dt, pos, mask, seed=2):
    jdt, tdt, tol = DTYPES[dt]
    jcfg, jparams, tcfg, tparams = model
    pool = _cache((L, N_PAGES, PAGE, H_KV, D), seed)
    token = np.asarray([3, 5, 7, 11, 90], np.int32)
    pos = np.asarray(pos, np.int32)
    keep = np.ones(len(pos), bool) if mask is None else np.asarray(mask)
    jl, jc = jtr.paged_decode_step(
        jparams, {k: jnp.asarray(v, jdt) for k, v in pool.items()},
        jnp.asarray(token), jnp.asarray(pos), jnp.asarray(TABLES), jcfg,
        jdt, write_mask=None if mask is None else jnp.asarray(keep))
    tcache = {k: torch.tensor(v).to(tdt) for k, v in pool.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    tl, tc = tr.paged_decode_step(
        tparams, tcache, torch.tensor(token), torch.tensor(pos),
        torch.tensor(TABLES), tcfg, tdt,
        write_mask=None if mask is None else torch.tensor(keep))
    assert tc is tcache
    written = np.zeros((L, N_PAGES, PAGE), bool)
    for b in np.flatnonzero(keep & (pos // PAGE < M)):
        written[:, TABLES[b, pos[b] // PAGE], pos[b] % PAGE] = True
    return jl, tl, jc, tc, before, written, tol


@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_decode_step_drops_rows_as_jax(model, dt, case):
    pos, mask = PAGED_CASES[case]
    jl, tl, jc, tc, before, written, tol = _paged_step(model, dt, pos, mask)
    # every row attends over the same pool bytes in both (the dropped
    # rows' writes are dropped in JAX too)
    _close(tl, jl, tol)
    if written.any():
        _check_cache(tc, before, jc, written, tol)
    else:
        for k in ("k", "v"):
            assert torch.equal(tc[k], before[k])


def test_paged_aliased_live_write_is_kept_exactly(model):
    """The live row whose target an idle row's clamped target aliases
    (row 1, page 0 offset 1) gets its own K/V: the bytes equal those of
    the same step with the idle row absent from the batch."""
    _, _, tcfg, tparams = model
    pool = _cache((L, N_PAGES, PAGE, H_KV, D), 3)
    pos = torch.tensor(ALIASED_POS, dtype=torch.int32)
    token = torch.tensor([3, 5, 7, 11, 90], dtype=torch.int32)
    keep = torch.tensor([True, True, False, True, True])
    full = {k: torch.tensor(v) for k, v in pool.items()}
    tr.paged_decode_step(tparams, full, token, pos, torch.tensor(TABLES),
                         tcfg, torch.float32, write_mask=keep)
    rows = [0, 1, 3, 4]
    alone = {k: torch.tensor(v) for k, v in pool.items()}
    tr.paged_decode_step(tparams, alone, token[rows], pos[rows],
                         torch.tensor(TABLES[rows]), tcfg, torch.float32,
                         write_mask=keep[rows])
    for k in ("k", "v"):
        assert torch.equal(full[k], alone[k])
        assert not torch.equal(full[k][:, 0, 1],
                               torch.tensor(pool[k])[:, 0, 1])


# ---------------------------------------------------------------------------
# No host read
# ---------------------------------------------------------------------------

def test_guard_catches_a_host_read():
    with pytest.raises(AssertionError, match="nonzero"):
        with NoHostRead():
            torch.nonzero(torch.tensor([True, False]))
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with NoHostRead():
            torch.tensor([1.0]).item()
    x = torch.arange(4.0)
    with pytest.raises(AssertionError, match="index"):
        with NoHostRead():
            x[x > 1]
    with NoHostRead():
        x[torch.tensor([2, 0])]


@pytest.mark.parametrize("kernel", [False, True], ids=["ref", "kernel_op"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_steps_read_nothing_to_the_host(model, paged, kernel):
    """Both steps under the guard, with the reference attention and with
    the kernel's wrapper (its plain version on the CPU); the write's ops
    run, and the result equals the unguarded step's."""
    _, _, tcfg, tparams = model
    if paged:
        attn = paged_decode_attention if kernel else None
        pool = _cache((L, N_PAGES, PAGE, H_KV, D), 4)
        args = (torch.tensor([3, 5, 7, 11, 90], dtype=torch.int32),
                torch.tensor(ALIASED_POS, dtype=torch.int32),
                torch.tensor(TABLES))
        mask = torch.tensor([True, True, False, True, True])
        step, write_op = tr.paged_decode_step, "aten.index_copy_.default"
    else:
        attn = decode_attention if kernel else None
        pool = _cache((L, 4, S_MAX, H_KV, D), 4)
        args = (torch.tensor([3, 5, 7, 90], dtype=torch.int32),
                torch.tensor([6, S_MAX, 3, S_MAX - 1], dtype=torch.int32))
        mask = torch.tensor([True, True, False, True])
        step, write_op = tr.decode_step, "aten.scatter_.src"
    outs = []
    for guard in (NoHostRead(), None):
        cache = {k: torch.tensor(v) for k, v in pool.items()}
        if guard is None:
            lg, _ = step(tparams, cache, *args, tcfg, torch.float32,
                         attn_impl=attn, write_mask=mask)
        else:
            with guard:
                lg, _ = step(tparams, cache, *args, tcfg, torch.float32,
                             attn_impl=attn, write_mask=mask)
            assert write_op in guard.seen
        outs.append((lg, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    for k in ("k", "v"):
        assert torch.equal(outs[0][1][k], outs[1][1][k])
