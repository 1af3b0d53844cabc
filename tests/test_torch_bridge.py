"""The port stands alone and mirrors the JAX package's data structures.

* ``repro_torch`` and every module in it import with ``jax`` blocked, and
  no source line of the port (nor of a script at the repository's root:
  ``chip_smoke.py`` and the benches) imports ``jax`` or anything of
  ``repro``.
* The config dataclasses have the JAX ones' fields and defaults (the
  ``attn_impl`` values excepted: the port's kernel value is "cuda").
* Weights, configs and indexes carried across by ``repro_torch.bridge``
  keep their exact bits, bfloat16 included.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_3_2b as jgranite
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro_torch import bridge
from repro_torch.configs import granite_3_2b as tgranite
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as tengine

# parallel test workers share the CPU: one torch thread each keeps this
# file from slowing the wall-clock-gated tests that run beside it
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25          # every module was loaded


def test_port_has_every_module_of_the_reference():
    """Every module of ``repro`` has its counterpart under the same name
    in ``repro_torch``, but ``distributed/compat.py`` (it only picks JAX's
    ``shard_map`` import) and the Pallas kernel files, whose counterparts
    are the CUDA sources and their wrappers."""
    ref = ROOT / "src" / "repro"
    missing = []
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref)
        if rel.name == "__init__.py" or rel.as_posix() in (
                "distributed/compat.py",) or rel.parts[0] == "kernels":
            continue
        if not (PORT / rel).exists():
            missing.append(rel.as_posix())
    assert not missing, missing


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import repro\b|from repro\b|"
        r"from repro\.)")
    # the package and every script at the root (chip_smoke.py and the
    # benches beside it)
    scripts = sorted(ROOT.glob("*.py"))
    assert {"chip_smoke.py", "paged_decode_bench.py"} <= {
        f.name for f in scripts}
    files = sorted(PORT.rglob("*.py")) + scripts
    bad = [f"{f}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad


def _fields(cls) -> dict:
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory
                     if f.default_factory is not dataclasses.MISSING
                     else None)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("pair", [
    (jtr.TransformerConfig, tr.TransformerConfig),
    (jtr.MoEConfig, tr.MoEConfig),
    (jengine.EngineConfig, tengine.EngineConfig),
], ids=["TransformerConfig", "MoEConfig", "EngineConfig"])
def test_config_fields_and_defaults_match_jax(pair):
    jcls, tcls = pair
    assert list(_fields(tcls)) == list(_fields(jcls))
    assert _fields(tcls) == _fields(jcls)


def test_engine_config_validation_matches_jax():
    for kw in ({"s_max": 8, "max_new_tokens": 7}, {"page_size": 0},
               {"iter_query_tokens": 0}, {"attn_num_buffers": 1},
               {"prefill_chunk": 0}, {"prefill_chunk": 4, "paged": False},
               {"attn_impl": "fancy"}):
        with pytest.raises(ValueError):
            jengine.EngineConfig(**kw)
        with pytest.raises(ValueError):
            tengine.EngineConfig(**kw)
    # the kernel value differs: "pallas" in JAX, "cuda" here; "splitk" is
    # in both
    with pytest.raises(ValueError, match="'cuda'"):
        tengine.EngineConfig(attn_impl="pallas")
    assert tengine.EngineConfig(attn_impl="cuda").attn_impl == "cuda"
    assert tengine.EngineConfig(attn_impl="splitk").attn_impl == "splitk"
    assert tengine.EngineConfig(fused_decode=False).paged is False


def test_granite_config_is_a_copy():
    for j, t in ((jgranite.CONFIG, tgranite.CONFIG),
                 (jgranite.reduced(), tgranite.reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.padded_vocab == j.padded_vocab
    assert bridge.config_from_jax(
        dataclasses.asdict(jgranite.CONFIG)) == tgranite.CONFIG
    moe = jtr.TransformerConfig(name="m", n_layers=1, d_model=8, n_heads=2,
                                n_kv_heads=1, d_head=4, d_ff=8,
                                vocab_size=16, moe=jtr.MoEConfig(4, 2))
    assert bridge.config_from_jax(dataclasses.asdict(moe)).moe == \
        tr.MoEConfig(4, 2)
    with pytest.raises(ValueError, match="lacks"):
        bridge.config_from_jax({**dataclasses.asdict(moe), "extra": 1})


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_params_round_trip_bit_exact(dtype):
    cfg = jtr.TransformerConfig(name="rt", n_layers=2, d_model=16,
                                n_heads=2, n_kv_heads=1, d_head=8, d_ff=32,
                                vocab_size=40)
    jp = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jax.random.PRNGKey(0), cfg, dtype))
    params = bridge.params_from_jax(jp, device="cpu")
    assert isinstance(params, torch.nn.Module)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    tree = params.tree()
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tree
        for k in keys:
            t = t[k]
        if keys[-1].startswith("ln"):
            assert t.dtype == torch.float32     # norms stay float32
        else:
            assert t.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                               else torch.float32)
        np.testing.assert_array_equal(bridge.tensor_to_numpy(t),
                                      np.asarray(leaf, np.float32))
    assert tree["layers"]["wq"].shape == (2, 16, 16)  # still stacked
    cast = bridge.params_from_jax(jp, device="cpu", dtype=torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["ln_f"].dtype == torch.float32


def test_int8_leaves_are_kept():
    cfg = jtr.TransformerConfig(name="q", n_layers=1, d_model=8, n_heads=2,
                                n_kv_heads=1, d_head=4, d_ff=16,
                                vocab_size=16)
    jp = jtr.quantize_for_serving(jtr.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    wq = params["layers"]["wq"]
    assert set(wq) == {"q", "scale"} and wq["q"].dtype == torch.int8
    np.testing.assert_array_equal(wq["q"].numpy(),
                                  np.asarray(jp["layers"]["wq"]["q"]))
    tokens = np.arange(6, dtype=np.int32)[None]
    jl, _ = jtr.forward(jp, jnp.asarray(tokens), cfg, jnp.float32)
    tl, _ = tr.forward(params, torch.tensor(tokens),
                       bridge.config_from_jax(dataclasses.asdict(cfg)),
                       torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


def test_index_from_jax_dtypes():
    idx = bridge.index_from_jax(np.zeros((3, 8)), np.zeros((2, 256, 4)),
                                -np.ones((3, 8)), np.zeros((3, 8, 2)), 0,
                                device="cpu")
    assert idx.centroids.dtype == torch.float32
    assert idx.list_ids.dtype == torch.int32
    assert idx.list_codes.dtype == torch.uint8
    assert (idx.n_lists, idx.n_subq) == (3, 2)


def test_entry_points_refuse_a_missing_gpu():
    """Without ``device="cpu"`` the entry points ask for the GPU and raise
    when there is none; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_jax({"ln_f": np.ones(4, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.tensor_from_numpy(np.ones(4, np.float32))
    assert bridge.tensor_from_numpy(np.ones(4, np.float32),
                                    device="cpu").device.type == "cpu"
    from repro_torch.retrieval.backend import ExactBackend, IVFPQBackend
    for make in (lambda: ExactBackend(np.zeros((4, 2), np.float32)),
                 lambda: IVFPQBackend(np.zeros((4, 2), np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the cache constructors: the GPU by default, the JAX-shaped zeroed
    # cache when the CPU is asked for
    cfg = tr.TransformerConfig(name="c", n_layers=2, d_model=32, n_heads=4,
                               n_kv_heads=2, d_head=8, d_ff=64, vocab_size=64)
    jcfg = jtr.TransformerConfig(**dataclasses.asdict(cfg))
    for make, jmake, args in ((tr.make_cache, jtr.make_cache, (3, 16)),
                              (tr.make_paged_cache, jtr.make_paged_cache,
                               (5, 4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg, *args)
        got, want = make(cfg, *args, device="cpu"), jmake(jcfg, *args)
        for k in ("k", "v"):
            assert got[k].device.type == "cpu"
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == torch.bfloat16 and not got[k].any()
