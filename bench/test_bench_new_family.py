"""A model family that is not the dense one is new files and entries only,
for the benchmark's own tests too.

A copy of ``BENCHMARK.json`` and ``bench/`` gets, as new files beside the
ones there: a toy family whose ``model`` group is named after Moonlight-
16B-A3B's published keys and has none of the dense family's
``head_dim``, ``num_key_value_heads``, ``intermediate_size`` or
``partial_rotary_factor``; its self-contained reference; a configuration;
a traffic mix; and a per-layer metric's reader.  Entries: the
configuration, one cell (appended to ``answers_per_s``'s workloads) and
the metric.  The copy's own tests that go over every configuration or
cell then run on it in a subprocess, and each of the toy's cases is
collected and passes.
"""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from bench.core import spec

TOKEN = "toyshared"            # in the name of every piece the toy adds
CONFIG, CELL = TOKEN, TOKEN + "-closed"
METRIC = TOKEN + "_ffn_bound_ms"

BLOCK = '''"""A toy family named after a latent-attention MoE decoder's keys, and
served by the program's dense decoder: full multi-head attention whose
query-key head is ``qk_nope_head_dim`` + ``qk_rope_head_dim`` wide (RoPE
on its leading ``qk_rope_head_dim`` dims, interleaved pairs) and as wide
as ``v_head_dim``; an FFN that is the sum of ``n_shared_experts`` SwiGLU
experts of ``moe_intermediate_size``, which the program serves as one
SwiGLU over their concatenated width."""

import math

import torch

from bench.core import counts as C

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=16,
            n_shared_experts=2, moe_intermediate_size=64, vocab_size=512)
REFERENCE = "lm_toyshared"


def _sizes(m):
    hd = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    if hd != m["v_head_dim"]:
        raise ValueError("the toy's q.k and v heads are one width")
    return (m["num_hidden_layers"], m["hidden_size"],
            m["num_attention_heads"], hd,
            m["n_shared_experts"] * m["moe_intermediate_size"])


def program_config(m, name):
    from repro_torch.models.transformer import TransformerConfig
    L, d, h, hd, f = _sizes(m)
    return TransformerConfig(
        name=name, n_layers=L, d_model=d, n_heads=h, n_kv_heads=h,
        d_head=hd, d_ff=f, vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]),
        rotary_frac=m["qk_rope_head_dim"] / hd,
        norm_eps=float(m["rms_norm_eps"]))


def draw_weights(m, program_cfg, seed, device):
    """Normal bf16 weights over sqrt(fan-in) (the embedding times 0.02),
    drawn on ``device`` one stacked tensor a call; the experts side by
    side on the FFN axis."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, d, h, hd, f = _sizes(m)

    def normal(shape, fan_in=None, scale=None):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.bfloat16)
        return w.mul_(scale or 1 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    v = program_cfg.padded_vocab
    layers = {"ln1": ones(L, d), "ln2": ones(L, d),
              "wq": normal((L, d, h * hd), d),
              "wk": normal((L, d, h * hd), d),
              "wv": normal((L, d, h * hd), d),
              "wo": normal((L, h * hd, d), h * hd),
              "w_gate": normal((L, d, f), d), "w_up": normal((L, d, f), d),
              "w_down": normal((L, f, d), m["moe_intermediate_size"])}
    return {"embed": normal((v, d), scale=0.02), "head": normal((d, v), d),
            "ln_f": ones(d), "layers": layers}


def program_component(m, weights, name, control):
    from repro_torch.models import transformer as tr
    params = tr.TransformerParams(weights)
    if control:
        params = tr.quantize_for_serving(params)
    return program_config(m, name), params


def _layer_weights(m):
    L, d, h, hd, f = _sizes(m)
    return 4 * d * h * hd + 3 * d * f


def prefill_flops(m, n):
    L, d, h, hd, f = _sizes(m)
    return (2.0 * L * _layer_weights(m) * n + 2.0 * d * m["vocab_size"]
            + 4.0 * h * hd * L * n * (n + 1) / 2)


def decode_flops(m, ctxs):
    L, d, h, hd, f = _sizes(m)
    return (2.0 * (L * _layer_weights(m) + d * m["vocab_size"]) * len(ctxs)
            + 4.0 * h * hd * L * float(sum(ctxs)))


def _bound(bytes_, flops):
    return max(bytes_ / C.HBM_BYTES_S, flops / C.BF16_FLOPS)


def prefill_bounds(m, n):
    L, d, h, hd, f = _sizes(m)
    return {"toyshared_prefill_bound_s": L * _bound(
        4 * n * h * hd * 2, 4.0 * h * hd * n * (n + 1) / 2)}


def decode_bounds(m, ctxs):
    L, d, h, hd, f = _sizes(m)
    rows, ctx = len(ctxs), float(sum(ctxs))
    return {"toyshared_decode_bound_s": L * _bound(
                ctx * 2 * h * hd * 2 + 2 * rows * h * hd * 2,
                4.0 * h * hd * ctx),
            "toyshared_ffn_bound_s": L * _bound(3 * d * f * 2,
                                                2.0 * 3 * d * f * rows)}
'''

REFERENCE = '''"""Float32 reference of the toy shared-experts decoder, one sequence at a
time: RMSNorm, causal multi-head attention whose heads rotate their
leading ``qk_rope_head_dim`` dims by position in interleaved pairs, and
the sum of ``n_shared_experts`` SwiGLU experts, each on its own slice of
the FFN weights."""

import math

import torch


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta, d_rot):
    """x: (S, H, D); pairs (2i, 2i+1) of the first ``d_rot`` dims."""
    pos = torch.arange(x.shape[0], dtype=torch.float64, device=x.device)
    i = torch.arange(0, d_rot, 2, dtype=torch.float64, device=x.device)
    ang = pos[:, None] / theta ** (i / d_rot)[None]
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    out = x.clone()
    a, b = x[..., 0:d_rot:2], x[..., 1:d_rot:2]
    out[..., 0:d_rot:2] = a * cos - b * sin
    out[..., 1:d_rot:2] = b * cos + a * sin
    return out


def attention(q, k, v):
    s = q.shape[0]
    sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(sc.masked_fill(mask, -math.inf), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def layer(x, lw, m):
    s = x.shape[0]
    h, d_rot = m["num_attention_heads"], m["qk_rope_head_dim"]
    hd = m["qk_nope_head_dim"] + d_rot
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    xn = rms_norm(x, lw["ln1"], eps)
    q = rope((xn @ lw["wq"]).reshape(s, h, hd), theta, d_rot)
    k = rope((xn @ lw["wk"]).reshape(s, h, hd), theta, d_rot)
    v = (xn @ lw["wv"]).reshape(s, h, m["v_head_dim"])
    x = x + attention(q, k, v).reshape(s, -1) @ lw["wo"]
    xn = rms_norm(x, lw["ln2"], eps)
    f = m["moe_intermediate_size"]
    for e in range(m["n_shared_experts"]):
        cols = slice(e * f, (e + 1) * f)
        g = xn @ lw["w_gate"][:, cols]
        x = x + (g * torch.sigmoid(g) * (xn @ lw["w_up"][:, cols])) \\
            @ lw["w_down"][cols]
    return x


def decoder_logits(weights, m, seqs, wants):
    eps, vocab = m["rms_norm_eps"], m["vocab_size"]
    hs = [weights["embed"][s].float() for s in seqs]
    for i in range(m["num_hidden_layers"]):
        lw = {k: v[i].float() for k, v in weights["layers"].items()}
        hs = [layer(x, lw, m) for x in hs]
    ln_f = weights["ln_f"].float()
    head = weights["head"][:, :vocab].float()
    return [rms_norm(x[want], ln_f, eps) @ head
            for x, want in zip(hs, wants)]
'''

METRIC_READER = '''"""Kernels: the least time of the toy's shared-experts FFN summed over
the traced slice's decode steps (ms)."""


def read(obs):
    s = obs.work.get("toyshared_ffn_bound_s")
    return 1e3 * s if s else None
'''

# the dense family's keys the toy's model group does without
DENSE_ONLY = ("head_dim", "num_key_value_heads", "intermediate_size",
              "partial_rotary_factor")
# the copy's tests that go over every configuration or cell, and those
# that read every configuration, cell or file at once
TEST_FILES = ["test_bench_blocks.py", "test_bench_control.py",
              "test_bench_counts.py", "test_bench_faults.py",
              "test_bench_imports.py", "test_bench_reference.py",
              "test_bench_spec.py", "test_bench_tick.py",
              "test_bench_traffic.py"]
WHOLE = ["test_counts_read_the_published_widths",
         "test_tiny_copy_keeps_every_cell", "test_top_level_shape",
         "test_names_and_units", "test_every_file_is_found",
         "test_metrics_per_cell",
         "test_readers_return_nothing_on_an_empty_window",
         "test_reference_imports_nothing_of_the_program",
         "test_every_family_is_scanned",
         "test_harness_loads_no_jax_in_a_run_process",
         "test_each_metric_has_its_entry_and_reader"]
FAULTS = ("answer_altered", "half_batch_left_out", "state_unchanged",
          "token_altered")
TOY_CASES = (
    [f"test_bench_blocks.py::test_every_config_names_its_family[{CONFIG}]",
     f"test_bench_blocks.py::test_traced_toy_run_counts_its_family_work"
     f"[{CELL}]"]
    + [f"test_bench_control.py::test_control_reads_far_above_the_program"
       f"[{CONFIG}-{seed}]" for seed in (1, 2, 3)]
    + [f"test_bench_reference.py::{t}[{CONFIG}]" for t in (
        "test_decoder_matches_program_forward",
        "test_decoder_matches_paged_decode_step",
        "test_encoder_and_exact_retrieval_match_the_program")]
    + [f"test_bench_faults.py::test_sound_run_is_correct[{CELL}]"]
    + [f"test_bench_faults.py::test_fault_is_not_correct[{CELL}-{f}]"
       for f in FAULTS]
    + [f"test_bench_imports.py::test_family_reference_imports_nothing_of_"
       f"the_program[{TOKEN}]"]
    + [f"test_bench_imports.py::test_no_module_of_bench_imports_jax_or_the_"
       f"jax_package[{p}]" for p in (f"blocks/{TOKEN}.py",
                                     f"reference/lm_{TOKEN}.py",
                                     f"metrics/{METRIC}.py")]
    + [f"test_bench_traffic.py::{t}[{CELL}]" for t in (
        "test_same_seed_same_traffic",
        "test_other_seed_same_work_other_data",
        "test_lengths_within_the_mix")])


def files(root) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and p.name != "BENCHMARK.json"
            and "__pycache__" not in p.parts}


def add_toy_family(root) -> None:
    """The toy's files and entries, beside the copy's own."""
    bench = root / "bench"
    (bench / "blocks" / f"{TOKEN}.py").write_text(BLOCK)
    (bench / "reference" / f"lm_{TOKEN}.py").write_text(REFERENCE)
    (bench / "metrics" / f"{METRIC}.py").write_text(METRIC_READER)
    bm = spec.load_benchmark(root)
    base = spec.load_config(bm, bm["workloads"][0]["config"], root)
    toy = {"name": CONFIG,
           "source": "https://huggingface.co/moonshotai/Moonlight-16B-A3B",
           "model": {"block": TOKEN, "model_type": "toy",
                     "num_hidden_layers": 2, "hidden_size": 64,
                     "num_attention_heads": 4, "qk_nope_head_dim": 8,
                     "qk_rope_head_dim": 8, "v_head_dim": 16,
                     "n_shared_experts": 2, "moe_intermediate_size": 64,
                     "vocab_size": 512, "hidden_act": "silu",
                     "rms_norm_eps": 1e-5, "rope_theta": 50000.0,
                     "torch_dtype": "bfloat16"}}
    for group in ("encoder", "corpus", "retrieval", "serving"):
        toy[group] = base[group]
    assert not set(DENSE_ONLY) & set(toy["model"])
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(toy))
    mix = spec.load_traffic("chatglm3-iterative-closed", bench)
    spec.traffic_path(CELL, bench).write_text(json.dumps(mix))
    bm["configs"].append({"name": CONFIG, "source": toy["source"],
                          "file": f"bench/configs/{CONFIG}.json",
                          "reduced": [], "why": "a toy family of new files"})
    bm["workloads"].append({"name": CELL, "config": CONFIG, "traffic": CELL,
                            "chips": 1, "why": "the toy family, closed loop"})
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    e2e["answers_per_s"]["workloads"].append(CELL)
    bm["per_layer"].append({"name": METRIC, "unit": "ms", "better": "lower",
                            "source": "program_counter", "layer": "kernels",
                            "moves": "answers_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm, indent=1))


def test_a_family_that_is_not_dense_is_new_files_only(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = files(tmp_path)
    bm0 = spec.load_benchmark(tmp_path)
    add_toy_family(tmp_path)
    after = files(tmp_path)
    assert {p: after[p] for p in before} == before
    bm = spec.load_benchmark(tmp_path)
    for kind in ("configs", "workloads", "per_layer"):
        assert bm[kind][:len(bm0[kind])] == bm0[kind], kind

    xml = tmp_path / "cases.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "PYTHON"))}
    env.update(PYTHONPATH=str(spec.ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", f"--junitxml={xml}",
         "-k", " or ".join([TOKEN] + WHOLE),
         *[f"bench/{f}" for f in TEST_FILES]],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    passed = set()
    for case in ET.parse(xml).getroot().iter("testcase"):
        if not any(c.tag in ("failure", "error", "skipped") for c in case):
            module = case.get("classname").rsplit(".", 1)[-1]
            passed.add(f"{module}.py::{case.get('name')}")
    assert set(TOY_CASES) <= passed, sorted(set(TOY_CASES) - passed)
    assert {n.split("::")[1].split("[")[0] for n in passed} >= set(WHOLE)
