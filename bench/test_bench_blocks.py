"""Model families found by name (``bench/blocks/<block>.py``): every
configuration names one; a traced toy run of every cell is correct and
counts the work its family names; where the family is the dense one, it
counts the same work and draws the same weights as the dense code it
wraps; a configuration without a family, or naming one that is not
there, stops a run; and a second family, the dense decoder with
Minitron-8B's squared-ReLU FFN, is served and judged through the real
harness on the CPU from new files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import tiny
from bench.core import cell as cell_mod
from bench.core import counts as C
from bench.core import model as M
from bench.core import spec
from bench.core.cell import run_cell
from bench.test_bench_imports import imported_top_levels

BM = spec.load_benchmark()
CONFIG_FILES = sorted((spec.BENCH_DIR / "configs").glob("*.json"))
CELLS = [w["name"] for w in BM["workloads"]]
# the dense code's numbers hold where the family is the dense one
DENSE_FILES = [p for p in CONFIG_FILES
               if json.loads(p.read_text())["model"].get("block") == "dense"]
DENSE_CELLS = [c for c in CELLS if spec.load_config(
    BM, spec.workload(BM, c)["config"])["model"].get("block") == "dense"]
INTERFACE = ("TINY", "REFERENCE", "program_config", "draw_weights",
             "program_component", "prefill_flops", "decode_flops",
             "prefill_bounds", "decode_bounds")


@pytest.fixture
def one_thread():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_every_config_names_its_family(path):
    cfg = json.loads(path.read_text())
    assert spec.block_path(cfg["model"]["block"]).is_file()
    fam = spec.family(cfg)
    for name in INTERFACE:
        assert hasattr(fam, name), name
    assert callable(fam.reference.decoder_logits)
    assert set(fam.TINY) <= set(cfg["model"])


# ---------------- the dense family: the same numbers -----------------------

def leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("path", DENSE_FILES, ids=lambda p: p.stem)
def test_dense_family_draws_the_same_weights(path):
    cfg = tiny.tiny_config(json.loads(path.read_text()))
    m = cfg["model"]
    fam = spec.family(cfg)
    prog = fam.program_config(m, cfg["name"])
    got = leaves(fam.draw_weights(m, prog, 2 ** 31 + 7, "cpu"))
    want = leaves(M.draw_weights(
        m, M.program_config(m, cfg["name"]).padded_vocab, 2 ** 31 + 7,
        "cpu"))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


def parent_work(steps, m) -> dict:
    """The work the harness counted before it had families: the dense
    counts of ``core/counts.py``, step by step, in the same order."""
    dm = C.Dims.from_model(m)
    w = {"decode_flops": 0.0, "prefill_flops": 0.0,
         "decode_bound_s": 0.0, "prefill_bound_s": 0.0,
         "decode_steps": 0, "prefills": 0}
    for ctxs, prefill_lens, in_window, in_slice in steps:
        if in_window:
            if ctxs:
                w["decode_steps"] += 1
                w["decode_flops"] += C.decode_flops(dm, ctxs)
            w["prefills"] += len(prefill_lens)
            w["prefill_flops"] += sum(C.prefill_flops(dm, n)
                                      for n in prefill_lens)
        if in_slice:
            if ctxs:
                w["decode_bound_s"] += C.paged_decode_bound_s(dm, ctxs)
            w["prefill_bound_s"] += sum(
                C.flash_prefill_bound_s(dm, n) for n in prefill_lens)
    return w


@pytest.mark.parametrize("cell", DENSE_CELLS)
def test_dense_family_counts_the_same_work(cell, tmp_path, monkeypatch,
                                           one_thread):
    """A traced toy run (the slice is its whole window on the CPU): the
    work counted through the family equals, to the last bit, the dense
    counts of the same steps."""
    bm = tiny.make(tmp_path)
    steps = []
    count = cell_mod.Driver.count

    def recording(self, ctxs, prefill_lens):
        steps.append((list(ctxs), list(prefill_lens), self.in_window,
                      self.in_slice))
        count(self, ctxs, prefill_lens)

    monkeypatch.setattr(cell_mod.Driver, "count", recording)
    result, info = run_cell(bm, cell, 3_000_000_023, 1.5, True,
                            device="cpu", root=tmp_path,
                            bench_dir=tmp_path / "bench")
    assert result["correct"], result["checks"]
    m = spec.load_config(bm, spec.workload(bm, cell)["config"],
                         tmp_path)["model"]
    work = info["work"]
    assert work == parent_work(steps, m)
    for key in ("decode_flops", "prefill_flops", "decode_bound_s",
                "prefill_bound_s"):
        assert work[key] > 0, key


# ---------------- every family: the work it names, counted -----------------

@pytest.mark.parametrize("cell", CELLS)
def test_traced_toy_run_counts_its_family_work(cell, tmp_path, one_thread):
    """A traced toy run of each cell is correct and counts, above 0, the
    FLOPs of its prefills and decode steps and every kernel bound its
    family names."""
    bm = tiny.make(tmp_path)
    result, info = run_cell(bm, cell, 3_000_000_031, 1.5, True,
                            device="cpu", root=tmp_path,
                            bench_dir=tmp_path / "bench")
    assert result["correct"], result["checks"]
    cfg = spec.load_config(bm, spec.workload(bm, cell)["config"], tmp_path)
    fam = spec.family(cfg, tmp_path / "bench")
    m = cfg["model"]
    bounds = set(fam.prefill_bounds(m, 8)) | set(fam.decode_bounds(m, [8]))
    assert bounds
    for key in ["decode_flops", "prefill_flops", *sorted(bounds)]:
        assert info["work"].get(key, 0) > 0, key


# ---------------- a missing family stops a run -----------------------------

@pytest.mark.parametrize("block,said", [
    (None, '"block"'),
    ("latent-moe", "bench/blocks/latent-moe.py")])
def test_run_stops_without_its_family(block, said, tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    wl = BM["workloads"][0]
    path = tmp_path / spec.config_entry(BM, wl["config"])["file"]
    cfg = json.loads(path.read_text())
    if block is None:
        del cfg["model"]["block"]
    else:
        cfg["model"]["block"] = block
    path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", wl["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert said in proc.stderr, proc.stderr
    assert "Traceback" not in proc.stderr, proc.stderr


# ---------------- a second family from new files only ----------------------

RELU2_BLOCK = '''"""The dense decoder with a squared-ReLU FFN (Minitron-8B's): relu(x
W_up)^2 W_down, no gate; the program's ``ffn_type="relu2"``."""

from bench.core import counts as C
from bench.core import model as M

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128,
            vocab_size=512)
REFERENCE = "lm_relu2"


class Dims(C.Dims):
    @property
    def layer_weights(self):
        return super().layer_weights - self.d_model * self.d_ff


def program_config(m, name):
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name=name, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_head=m["head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]),
        rotary_frac=float(m["partial_rotary_factor"]),
        norm_eps=float(m["rms_norm_eps"]), ffn_type="relu2")


def draw_weights(m, program_cfg, seed, device):
    w = M.draw_weights(m, program_cfg.padded_vocab, seed, device)
    del w["layers"]["w_gate"]
    return w


def program_component(m, weights, name, control):
    from repro_torch.models import transformer as tr
    params = tr.TransformerParams(weights)
    if control:
        params = tr.quantize_for_serving(params)
    return program_config(m, name), params


def prefill_flops(m, n):
    return C.prefill_flops(Dims.from_model(m), n)


def decode_flops(m, ctxs):
    return C.decode_flops(Dims.from_model(m), ctxs)


def prefill_bounds(m, n):
    return {"prefill_bound_s": C.flash_prefill_bound_s(Dims.from_model(m),
                                                       n)}


def decode_bounds(m, ctxs):
    dm = Dims.from_model(m)
    ffn = 2 * dm.d_model * dm.d_ff * dm.layers
    return {"decode_bound_s": C.paged_decode_bound_s(dm, ctxs),
            "relu2_ffn_bound_s": max(ffn * dm.elem_bytes / C.HBM_BYTES_S,
                                     2.0 * ffn * len(ctxs) / C.BF16_FLOPS)}
'''

RELU2_REFERENCE = '''"""Float32 reference of the squared-ReLU decoder: ``lm``'s attention,
RoPE and norms, then x + relu(norm(x) W_up)^2 W_down."""

import torch

from bench.reference import lm


def layer(x, lw, m):
    b, s, _ = x.shape
    h, h_kv, d = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["head_dim"])
    eps, theta, frac = (m["rms_norm_eps"], m["rope_theta"],
                        m["partial_rotary_factor"])
    xn = lm.rms_norm(x, lw["ln1"], eps)
    q = lm.rope((xn @ lw["wq"]).reshape(b, s, h, d), theta, frac)
    k = lm.rope((xn @ lw["wk"]).reshape(b, s, h_kv, d), theta, frac)
    v = (xn @ lw["wv"]).reshape(b, s, h_kv, d)
    x = x + lm.attention(q, k, v, True).reshape(b, s, h * d) @ lw["wo"]
    xn = lm.rms_norm(x, lw["ln2"], eps)
    return x + torch.square(torch.relu(xn @ lw["w_up"])) @ lw["w_down"]


def decoder_logits(weights, m, seqs, wants):
    eps, vocab = m["rms_norm_eps"], m["vocab_size"]
    hs = [weights["embed"][s].float()[None] for s in seqs]
    for i in range(m["num_hidden_layers"]):
        lw = {k: v[i].float() for k, v in weights["layers"].items()}
        hs = [layer(h, lw, m) for h in hs]
    ln_f = weights["ln_f"].float()
    head = weights["head"][:, :vocab].float()
    return [lm.rms_norm(h[0, want], ln_f, eps) @ head
            for h, want in zip(hs, wants)]
'''

RELU2_CELL = "relu2-iterative-closed"
# on the toy copy's limits (``tiny.TINY_LIMITS``), at two threads: sound
# runs over seeds 11-13 and 3,000,000,029 read logit_gap_mean
# 0.000097-0.00028, the FFN served as a plain ReLU 0.34-0.62


def files(root) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and p.name != "BENCHMARK.json"
            and "__pycache__" not in p.parts}


def add_relu2_family(root, bm: dict) -> dict:
    """The family, its reference, a configuration and a traffic mix as new
    files, and the configuration's and the cell's entries."""
    bench = root / "bench"
    (bench / "blocks" / "relu2.py").write_text(RELU2_BLOCK)
    (bench / "reference" / "lm_relu2.py").write_text(RELU2_REFERENCE)
    base = spec.config_entry(bm, bm["workloads"][0]["config"])
    cfg = json.loads((root / base["file"]).read_text())
    cfg["name"] = "minitron-relu2-toy"
    cfg["source"] = "https://huggingface.co/nvidia/Minitron-8B-Base"
    cfg["model"].update(block="relu2", hidden_act="relu2", ffn="relu2")
    cfg = tiny.tiny_config(cfg, bench)
    (bench / "configs" / "minitron-relu2-toy.json").write_text(
        json.dumps(cfg))
    mix = spec.load_traffic("chatglm3-iterative-closed", bench)
    spec.traffic_path(RELU2_CELL, bench).write_text(json.dumps(mix))
    bm["configs"].append({"name": cfg["name"], "source": cfg["source"],
                          "file": "bench/configs/minitron-relu2-toy.json",
                          "reduced": [], "why": "a squared-ReLU FFN"})
    bm["workloads"].append({"name": RELU2_CELL, "config": cfg["name"],
                            "traffic": RELU2_CELL, "chips": 1,
                            "why": "the squared-ReLU decoder, closed loop"})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    return spec.load_benchmark(root)


@pytest.fixture(scope="module")
def relu2_toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("relu2")
    bm = tiny.make(root)
    before = files(root)
    return add_relu2_family(root, bm), root, before


def relu_not_squared(monkeypatch, engine):
    """The program's squared-ReLU FFN served as a plain ReLU."""
    from repro_torch.models import transformer as tr
    ffn = tr.dense_ffn

    def plain(x, lp, compute_dtype=torch.bfloat16, ffn_type="swiglu"):
        if ffn_type != "relu2":
            return ffn(x, lp, compute_dtype, ffn_type)
        xc = x.to(compute_dtype)
        h = torch.relu(xc @ lp["w_up"].to(compute_dtype))
        return (h @ lp["w_down"].to(compute_dtype)).to(x.dtype)

    monkeypatch.setattr(tr, "dense_ffn", plain)


def test_second_family_reference_matches_the_program(relu2_toy):
    """The new reference against the program's float32 forward."""
    from repro_torch.models import transformer as tr
    bm, root, _ = relu2_toy
    cfg = spec.load_config(bm, "minitron-relu2-toy", root)
    fam = spec.family(cfg, root / "bench")
    ref_path = spec.reference_path(fam.REFERENCE, root / "bench")
    assert imported_top_levels(ref_path) <= {"torch", "bench"}
    m = cfg["model"]
    prog = fam.program_config(m, cfg["name"])
    w = M.draw_weights(m, prog.padded_vocab, 3, "cpu", dtype=torch.float32)
    del w["layers"]["w_gate"]
    toks = torch.randint(0, m["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = tr.forward(tr.TransformerParams(w), toks, prog,
                           compute_dtype=torch.float32)
    got = fam.reference.decoder_logits(w, m, [toks[0]],
                                       [torch.arange(40)])[0]
    want = logits[0, :, :m["vocab_size"]]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_second_family_is_served_by_new_files_only(relu2_toy, one_thread):
    bm, root, before = relu2_toy
    result, info = run_cell(bm, RELU2_CELL, 3_000_000_029, 2.0, True,
                            device="cpu", root=root, bench_dir=root / "bench")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    work = info["work"]
    for key in ("decode_flops", "prefill_flops", "decode_bound_s",
                "prefill_bound_s", "relu2_ffn_bound_s"):
        assert work[key] > 0, key
    assert {p: p.read_bytes() for p in before} == before


def test_second_family_planted_fault_is_not_correct(relu2_toy, monkeypatch,
                                                    one_thread):
    bm, root, _ = relu2_toy
    result, _ = run_cell(
        bm, RELU2_CELL, 3_000_000_029, 2.0, False, device="cpu", root=root,
        bench_dir=root / "bench",
        plant=lambda engine: relu_not_squared(monkeypatch, engine))
    assert not result["correct"], result["checks"]
