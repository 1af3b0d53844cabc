"""Port vs JAX: the architecture registry, int8 serving weights,
``prefill`` and the serving launcher, on the CPU.

* The registry holds the reference's ten ids in its order, and
  ``all_cells()`` its 35 official and 40 total cells.  Every LM
  ``ArchSpec`` of ``repro_torch.configs`` (config, ``reduced()``, shapes,
  source) equals the reference's, configs compared through
  ``bridge.config_from_jax(dataclasses.asdict(...))``; every GNN and
  recsys ``ArchSpec`` too, configs field for field
  (``dataclasses.asdict``), and PNA's ``config_for_shape`` at each shape.
* ``quantize_for_serving`` gives JAX's int8 tree: ``q`` bit-equal, scales
  within 1e-6 relative (both divide the same float32 amax by 127), also
  when it quantizes a slice of axis 0 at a time; a JAX int8 tree carried
  across runs the same quantized ``forward`` (f32 compute, 1e-5).
* ``launch.serve.main([..., "--device", "cpu"])`` serves every LM arch
  at its reduced size; both launchers refuse a non-LM arch with
  ``ValueError``, as the reference's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models import common as cm
from repro_torch.models import transformer as tr
from repro_torch.serving.request import State

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

LM_IDS = [a for a in jbase.ARCH_IDS if jget_arch(a).family == "lm"]
NON_LM_IDS = [a for a in jbase.ARCH_IDS if jget_arch(a).family != "lm"]
F32_TOL = 1e-5
BF16_TOL = 6e-2          # see tests/test_torch_model.py


def test_registry_holds_the_reference_lm_ids():
    """Every id of the reference, LMs first, in its order; its cells."""
    assert list(tconfigs.ARCH_IDS) == list(jbase.ARCH_IDS)
    assert list(tconfigs.ARCH_IDS[:5]) == LM_IDS and len(NON_LM_IDS) == 5
    assert set(tconfigs.__all__) == set(
        __import__("repro.configs", fromlist=["__all__"]).__all__)
    for skipped in (False, True):
        cells = list(tconfigs.all_cells(include_skipped=skipped))
        assert [(a.arch_id, s.name) for a, s in cells] == [
            (a.arch_id, s.name)
            for a, s in jbase.all_cells(include_skipped=skipped)]
        assert len(cells) == (40 if skipped else 35)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_arch_spec_is_a_copy(arch_id):
    j, t = jget_arch(arch_id), get_arch(arch_id)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family,
                                               j.source)
    for jc, tc in ((j.config, t.config), (j.reduced(), t.reduced())):
        assert bridge.config_from_jax(dataclasses.asdict(jc)) == tc
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert [dataclasses.asdict(s) for s in t.shapes] == \
        [dataclasses.asdict(s) for s in j.shapes]
    assert t.shape("decode_32k").dims == j.shape("decode_32k").dims
    with pytest.raises(KeyError):
        t.shape("nope")


def test_non_lm_ids_raise():
    """Every GNN and recsys id resolves to the reference's ``ArchSpec``
    (the family, source and shapes; configs in
    ``test_non_lm_arch_spec_is_a_copy``); an unknown id raises."""
    for arch_id in NON_LM_IDS:
        j, t = jget_arch(arch_id), get_arch(arch_id)
        assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family,
                                                   j.source)
        assert t.family in ("gnn", "recsys")
        assert [dataclasses.asdict(s) for s in t.shapes] == \
            [dataclasses.asdict(s) for s in j.shapes]
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch_id", NON_LM_IDS)
def test_non_lm_arch_spec_is_a_copy(arch_id):
    """Config and ``reduced()`` field for field, of the same class name;
    PNA's ``config_for_shape`` at every shape."""
    j, t = jget_arch(arch_id), get_arch(arch_id)
    for jc, tc in ((j.config, t.config), (j.reduced(), t.reduced())):
        assert type(tc).__name__ == type(jc).__name__
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert [f.name for f in dataclasses.fields(tc)] == \
            [f.name for f in dataclasses.fields(jc)]
    if arch_id == "pna":
        from repro.configs import pna as jpna
        from repro_torch.configs import pna as tpna
        for shape in j.shapes:
            assert dataclasses.asdict(tpna.config_for_shape(
                t.shape(shape.name))) == dataclasses.asdict(
                    jpna.config_for_shape(shape))
    elif hasattr(j.config, "tables"):
        jt, tt = j.config.tables(), t.config.tables()
        assert (tt.total_rows, tt.dim) == (jt.total_rows, jt.dim)


# ---------------------------------------------------------------------------
# int8 serving weights
# ---------------------------------------------------------------------------

def _reduced(arch_id, dtype=jnp.float32):
    jcfg = jget_arch(arch_id).reduced()
    jparams = jtr.init_params(jax.random.PRNGKey(0), jcfg, dtype)
    return jcfg, jparams, bridge.config_from_jax(dataclasses.asdict(jcfg))


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict) and "q" not in tree[key]:
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch_id", ["moonshot-v1-16b-a3b", "minitron-8b"])
def test_quantize_for_serving_matches_jax(arch_id, dt):
    """The same weights through both quantizers: the same tree, int8
    bit-equal; norms untouched."""
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    _, jparams, _ = _reduced(arch_id, jdt)
    jq = jax.tree_util.tree_map(np.asarray, jtr.quantize_for_serving(jparams))
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tq = tr.quantize_for_serving(tparams).tree()
    jleaves, tleaves = dict(_leaves(jq)), dict(_leaves(tq))
    assert set(jleaves) == set(tleaves)
    for path, jl in jleaves.items():
        tl = tleaves[path]
        if path[-1].startswith("ln"):
            np.testing.assert_array_equal(bridge.tensor_to_numpy(tl),
                                          np.asarray(jl, np.float32))
            continue
        assert tl["q"].dtype == torch.int8 and tl["q"].shape == jl["q"].shape
        np.testing.assert_array_equal(tl["q"].numpy(), jl["q"])
        np.testing.assert_allclose(tl["scale"].numpy(), jl["scale"],
                                   rtol=1e-6)


def test_quantize_in_slices_equals_whole():
    """Quantizing a slice of axis 0 at a time gives the whole weight's
    numbers (the scale runs along the last axis)."""
    rng = np.random.default_rng(0)
    for shape in ((5, 3, 8, 6), (7, 16)):
        w = torch.tensor(rng.standard_normal(shape)).to(torch.bfloat16)
        whole = cm.quantize_int8(w)
        for step_elems in (1, 20, 10 ** 9):
            part = tr._quantize_int8_sliced(w, max_elems=step_elems)
            assert torch.equal(part["q"], whole["q"])
            assert torch.equal(part["scale"], whole["scale"])


@pytest.mark.parametrize("arch_id", ["moonshot-v1-16b-a3b", "chatglm3-6b"])
def test_quantized_forward_matches_jax(arch_id):
    """JAX's int8 tree carried across bit-exact, and the port's own
    quantization, run JAX's quantized forward (f32 compute)."""
    jcfg, jparams, tcfg = _reduced(arch_id)
    jq = jtr.quantize_for_serving(jparams)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jl, _ = jtr.forward(jq, jnp.asarray(tokens), jcfg, jnp.float32)
    carried = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                                     device="cpu")
    assert carried["layers"]["w_up"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(carried["layers"]["w_up"]["q"].numpy(),
                                  np.asarray(jq["layers"]["w_up"]["q"]))
    own = tr.quantize_for_serving(bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    for params in (carried, own):
        tl, _ = tr.forward(params, torch.tensor(tokens), tcfg,
                           torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_at_cache_len_past_s(dt):
    """Granite reduced: last-token logits and the cache zero-padded from
    S = 11 to 24, as JAX's; ``cache_len`` at or below S leaves it at S."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, F32_TOL) if dt == "f32"
                     else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    jcfg, jparams, tcfg = _reduced("granite-3-2b")
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 512, (2, 11)).astype(
        np.int32)
    jl, jc = jtr.prefill(jparams, jnp.asarray(tokens), jcfg, cache_len=24,
                         compute_dtype=jdt)
    tl, tc = tr.prefill(tparams, torch.tensor(tokens), tcfg, cache_len=24,
                        compute_dtype=tdt)
    np.testing.assert_allclose(bridge.tensor_to_numpy(tl),
                               np.asarray(jl, np.float32), rtol=tol,
                               atol=tol)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape == (2, 2, 24, 2, 16)
        np.testing.assert_allclose(bridge.tensor_to_numpy(tc[k]),
                                   np.asarray(jc[k], np.float32), rtol=tol,
                                   atol=tol)
        assert not tc[k][:, :, 11:].any()
    _, short = tr.prefill(tparams, torch.tensor(tokens), tcfg, cache_len=8)
    assert short["k"].shape[2] == 11


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", LM_IDS)
def test_launch_serve_serves_every_lm_arch(arch_id, capsys):
    done = tserve.main(["--arch", arch_id, "--requests", "3",
                        "--device", "cpu"])
    assert len(done) == 3
    for r in done:
        assert r.state is State.DONE and len(r.output) == 8
        assert all(0 <= t < get_arch(arch_id).reduced().vocab_size
                   for t in r.output)
    assert f"[serve] {arch_id} (reduced): 3 requests, 24 tokens" in \
        capsys.readouterr().out


def test_launch_serve_iterative_and_refusals():
    done = tserve.main(["--arch", "moonshot-v1-16b-a3b", "--requests", "2",
                        "--iterative", "4", "--device", "cpu"])
    assert all(r.state is State.DONE and r.retrievals_done >= 1
               for r in done)
    with pytest.raises(ValueError, match="not a language model"):
        tserve.main(["--arch", "pna", "--device", "cpu"])
    from repro_torch.launch import train as ttrain
    with pytest.raises(ValueError, match="not a language model"):
        ttrain.main(["--arch", "dlrm-rm2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--arch", "granite-3-2b"])
