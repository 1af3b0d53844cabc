"""The DeepSeek-V3 decoder (Moonlight-16B-A3B's family) against its plain
float32 reference, at the benchmark family's toy sizes on the CPU.

The JAX package has no such model, so the oracle is the benchmark's own
reference, ``bench/reference/lm_deepseek_v3.py`` (the published
modeling code's decompressed form, one sequence at a time, a loop over
experts), on the weights the family draws (``bench/blocks/
deepseek_v3.py``; the router's correction bias drawn nonzero).  Logits
are compared, not tokens, in float32 on both sides: they agree to float32
rounding, so every tolerance is 1e-4 of the largest logit (the reduction
orders differ: blocked against whole attention, grouped against looped
experts, absorbed against decompressed latent attention).  Covered: the
full forward; a bucketed prefill into the latent page pool, then paged
decode steps; a two-row ``paged_chunk_extend_batch`` over a shared
prefix with copy-on-write; the absorbed form against the decompressed
one; the dropless dispatch against a token-by-token loop (a single expert
in every token's choice, a bias that changes the choice); the engine
through ``RAGServer`` (the tick's routing attrs); latent slot export and import; the refusals.  On a GPU (marker
``cuda``): the CUDA-graph-replayed engine against the eager one, and the
dispatch against its plain loop.
"""

import json

import numpy as np
import pytest
import torch

from bench import tiny
from bench.core import spec
from repro_torch.data.synthetic import topical_corpus
from repro_torch.models import mla as latent
from repro_torch.models import transformer as tr
from repro_torch.serving import engine as te
from repro_torch.serving.kv_cache import PagedKVCachePool, payload_checksum
from repro_torch.serving.request import State
from repro_torch.serving.server import RAGServer
from repro_torch.serving.telemetry import SpanTracer

torch.set_num_threads(1)

CONFIG = spec.BENCH_DIR / "configs" / "moonlight-16b-a3b-rag.json"
TOL = 1e-4      # of the largest logit: float32 rounding in another order


def toy(seed=3, dtype=torch.float32):
    """The family's toy model: (model keys, family, weights, program
    config, parameters)."""
    cfg = tiny.tiny_config(json.loads(CONFIG.read_text()))
    fam = spec.family(cfg)
    m = cfg["model"]
    prog = fam.program_config(m, "moonlight-toy")
    w = fam.draw_weights(m, prog, seed, "cpu")
    w = {k: ({kk: vv.to(dtype) if vv.is_floating_point() else vv
              for kk, vv in v.items()} if isinstance(v, dict)
             else v.to(dtype)) for k, v in w.items()}
    return m, fam, w, prog, tr.TransformerParams(w)


def close(got, want, tol=TOL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, err / scale


def reference(fam, w, m, seqs, wants):
    return fam.reference.decoder_logits(w, m, list(seqs), list(wants))


def test_toy_has_every_mechanism():
    m, fam, w, prog, _ = toy()
    assert prog.routed.first_dense == 1 and prog.n_layers >= 2
    assert prog.routed.n_experts >= 8 and prog.routed.top_k > 1
    assert prog.routed.n_shared == 2
    assert prog.mla.kv_lora_rank < prog.n_heads * prog.mla.qk_head_dim
    assert float(w["moe_layers"]["router_bias"].abs().min()) > 0


def test_published_config_counts_its_parameters():
    cfg = json.loads(CONFIG.read_text())
    fam = spec.family(cfg)
    prog = fam.program_config(cfg["model"], cfg["name"])
    # 27 x 13.77 M attention, one 69.2 M dense FFN, 26 x 571.1 M routed
    # layers, 2 x 163,840 x 2,048 embedding and head, the final norm
    assert prog.param_count() == 15_960_110_208
    _, _, _, small, params = toy()
    assert sum(t.numel() for t in params.buffers()) == small.param_count()


def test_published_keys_at_the_top_equal_the_served_model_group():
    # the file's top level holds the published config.json's keys; the
    # harness serves its "model" group, which must give each the same value
    cfg = json.loads(CONFIG.read_text())
    sections = {"name", "source", "model", "departures", "assumed",
                "encoder", "corpus", "retrieval", "serving"}
    published = {k: v for k, v in cfg.items() if k not in sections}
    assert published["ep_size"] == 1 and published["q_lora_rank"] is None
    assert len(published) == 33
    assert {k: cfg["model"].get(k, "missing") for k in published} == published


def test_forward_matches_reference():
    m, fam, w, prog, params = toy()
    toks = torch.randint(0, m["vocab_size"], (2, 40),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = tr.forward(params, toks, prog, compute_dtype=torch.float32)
    want = reference(fam, w, m, toks, [torch.arange(40)] * 2)
    for b in range(2):
        close(logits[b, :, :m["vocab_size"]], want[b])


def test_prefill_then_paged_decode_matches_reference():
    """A 13-token prompt padded to its bucket of 16, installed in pages of
    4 of a pool whose free pages come out of order, then 9 decode steps
    through the block table, each logit row against the reference's full
    forward at its position."""
    m, fam, w, prog, params = toy(4)
    seq = torch.randint(0, m["vocab_size"], (22,),
                        generator=torch.Generator().manual_seed(1))
    padded = torch.zeros(1, te.bucket_len(13), dtype=torch.long)
    padded[0, :13] = seq[:13]
    logits0, _, cache = tr.forward(params, padded, prog,
                                   compute_dtype=torch.float32,
                                   collect_cache=True)
    assert set(cache) == {"kv"}
    assert cache["kv"].shape[-2:] == (1, prog.mla.latent_dim)
    pool = PagedKVCachePool(prog, 3, 32, page_size=4, spare_pages=2,
                            dtype=torch.float32, device="cpu")
    fillers = [pool.alloc(rid) for rid in (1, 2)]
    for slot in fillers:
        pool.write_prefix(slot, cache, 6)
    for slot in fillers:
        pool.release(slot)
    slot = pool.alloc(0)
    pool.write_prefix(slot, cache, 13)
    got = [logits0[0, 12]]
    stats = torch.zeros(2)
    for t in range(13, 22):
        pool.prepare_append(slot, 1)
        lg, _ = tr.paged_decode_step(
            params, pool.cache, seq[t:t + 1].to(torch.int32),
            pool.positions()[slot:slot + 1],
            torch.as_tensor(pool.block_tables()[slot:slot + 1]), prog,
            compute_dtype=torch.float32, stats=stats)
        pool.advance([slot])
        got.append(lg[0])
        assert bool((stats >= 1).all())  # the step's routing recorded
    table = pool.page_tables[slot]
    assert table != sorted(table), table
    want = reference(fam, w, m, [seq], [torch.arange(12, 22)])[0]
    close(torch.stack(got)[:, :m["vocab_size"]], want)


def test_chunk_extend_batch_over_a_shared_prefix_with_copy_on_write():
    """Two rows whose prompts share their first two pages (content-
    addressed, referenced twice) and whose tails differ; row 0's tail page
    is then made shared, so its extend copies it first.  One
    ``paged_chunk_extend_batch`` over both rows, 5 and 3 new tokens: each
    row's last logits against the reference's forward of its whole
    sequence, and row 1's pages read back unchanged by row 0's write."""
    m, fam, w, prog, params = toy(5)
    g = torch.Generator().manual_seed(2)
    head = torch.randint(0, m["vocab_size"], (8,), generator=g)
    seqs = [torch.cat([head, torch.randint(0, m["vocab_size"], (n,),
                                           generator=g)]) for n in (7, 5)]
    pool = PagedKVCachePool(prog, 2, 32, page_size=4, spare_pages=4,
                            dtype=torch.float32, device="cpu")
    prompts = [s[:10] for s in seqs]
    for rid, prompt in enumerate(prompts):
        _, cache = tr.prefill(params, prompt[None], prog,
                              compute_dtype=torch.float32)
        slot = pool.alloc(rid)
        pool.write_prefix(slot, cache, 10, tokens=prompt.numpy())
    assert pool.metrics["pages_shared"] == 2
    by_rid = {rid: s for s, rid in pool.owner.items()}
    # row 0's partial tail page turns content-addressed: its write copies it
    pool._register(pool.page_tables[by_rid[0]][-1], b"pinned")
    new = [s[10:] for s in seqs]
    for rid, toks in enumerate(new):
        pool.prepare_append(by_rid[rid], len(toks))
    assert pool.metrics["pages_cow"] == 1
    before = pool.cache["kv"].clone()
    rows = [by_rid[0], by_rid[1]]
    tokens = torch.zeros(2, 8, dtype=torch.long)
    for b, toks in enumerate(new):
        tokens[b, :len(toks)] = toks
    tables = torch.as_tensor(pool.block_tables()[rows])
    _, logits = tr.paged_chunk_extend_batch(
        params, pool.cache, tables, tokens, [10, 10], [5, 3], prog,
        compute_dtype=torch.float32)
    want = reference(fam, w, m, seqs, [torch.tensor([14]),
                                       torch.tensor([12])])
    for b in range(2):
        close(logits[b, :m["vocab_size"]], want[b][0])
    # the shared pages are where they were, unchanged
    shared = pool.page_tables[by_rid[1]][:2]
    assert shared == pool.page_tables[by_rid[0]][:2]
    assert torch.equal(pool.cache["kv"][:, shared], before[:, shared])


def test_absorbed_attention_equals_decompressed():
    """q_nope W_UK^T against the latent rows and W_UV after, against keys
    and values decompressed from the same rows, under the same mask."""
    _, _, _, prog, params = toy(6)
    g = torch.Generator().manual_seed(3)
    B, T, S = 2, 3, 11
    q = torch.randn(B, T, prog.n_heads, prog.mla.qk_head_dim, generator=g)
    kv = torch.randn(B, S, 1, prog.mla.latent_dim, generator=g)
    wkv_b = params["layers"]["wkv_b"][0]
    pos = torch.tensor([[5, 6, 7], [8, 9, 10]])
    mask = torch.arange(S)[None, None] <= pos[..., None]           # (B,T,S)
    got = latent.unabsorb(latent.latent_attention(
        latent.absorb(q, wkv_b, prog), kv[:, :, 0], mask, prog.mla.scale,
        prog.mla.kv_lora_rank), wkv_b, prog)
    k, v = latent.decompress(kv, wkv_b, prog)
    sc = torch.einsum("bthd,bshd->bhts", q, k) * prog.mla.scale
    sc = sc.masked_fill(~mask[:, None], -float("inf"))
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(sc, -1), v)
    close(got, want, 1e-5)


def token_loop(x, lp, prog):
    """The routed FFN a token at a time: its chosen experts in turn,
    weighted, plus the shared experts."""
    r = prog.routed
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        s = torch.sigmoid(x[t] @ lp["router"])
        idx = torch.topk(s + lp["router_bias"], r.top_k).indices
        g = s[idx] / s[idx].sum() * r.routed_scale
        for e, wt in zip(idx.tolist(), g):
            h = torch.nn.functional.silu(x[t] @ lp["w_gate"][e]) \
                * (x[t] @ lp["w_up"][e])
            out[t] += wt * (h @ lp["w_down"][e])
        h = torch.nn.functional.silu(x[t] @ lp["s_gate"]) * (x[t] @ lp["s_up"])
        out[t] += h @ lp["s_down"]
    return out


def _dispatch_case(case):
    _, _, _, prog, params = toy(7)
    lp = tr.layer_weights(params.tree(), prog, 1)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 7, prog.d_model, generator=g)
    if case == "one_expert_everywhere":
        lp = dict(lp, router_bias=lp["router_bias"].clone())
        lp["router_bias"][5] = 10.0        # expert 5 in every token's top k
    return prog, lp, x


@pytest.mark.parametrize("case", ["drawn", "one_expert_everywhere"])
def test_dropless_dispatch_matches_a_token_loop(case):
    prog, lp, x = _dispatch_case(case)
    stats = torch.zeros(2)
    live = torch.tensor([True, False, True])
    got = tr.routed_moe_ffn(x, lp, prog, torch.float32,
                            tr.RouteStats(live, stats))
    want = token_loop(x.reshape(-1, prog.d_model), lp, prog)
    close(got.reshape(-1, prog.d_model), want, 1e-5)
    eidx, _ = tr.route_sigmoid(x.reshape(-1, prog.d_model), lp, prog)
    chosen = eidx.reshape(3, 7, -1)[live]
    took = torch.bincount(chosen.reshape(-1), minlength=prog.routed.n_experts)
    assert stats.tolist() == [float((took > 0).sum()), float(took.max())]
    if case == "one_expert_everywhere":
        assert bool((eidx == 5).any(-1).all())
        assert stats[1] == 14           # every live token, one expert


def test_bias_changes_the_selection_and_the_loop_agrees():
    prog, lp, x = _dispatch_case("drawn")
    xf = x.reshape(-1, prog.d_model)
    with_bias, _ = tr.route_sigmoid(xf, lp, prog)
    without, _ = tr.route_sigmoid(
        xf, dict(lp, router_bias=torch.zeros_like(lp["router_bias"])), prog)
    differ = (with_bias.sort(-1).values != without.sort(-1).values).any(-1)
    assert bool(differ.any())
    close(tr.routed_moe_ffn(x, lp, prog, torch.float32).reshape(xf.shape),
          token_loop(xf, lp, prog), 1e-5)


def test_bf16_routing_follows_the_float32_routing(monkeypatch):
    """On the family's draw (the routers' channel, ``bench/blocks/
    deepseek_v3.py``) the bf16 program's routed layers choose what the
    float32 program (the reference's choices, above) chooses, for every
    token: the router reads the float32 normed rows of a channel that no
    layer writes and only the routers read."""
    _, _, w, prog, params = toy(10)
    bf16 = tr.TransformerParams({k: ({kk: vv.to(torch.bfloat16)
                                      if kk != "router_bias" else vv
                                      for kk, vv in v.items()}
                                     if isinstance(v, dict) else v)
                                 for k, v in w.items()})
    toks = torch.randint(0, prog.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(6))
    chosen = []
    route = tr.route_sigmoid

    def spy(x, lp, cfg):
        eidx, gates = route(x, lp, cfg)
        chosen.append(eidx.sort(-1).values)
        return eidx, gates

    monkeypatch.setattr(tr, "route_sigmoid", spy)
    tr.forward(params, toks, prog, compute_dtype=torch.float32)
    tr.forward(bf16, toks, prog)
    n = len(chosen) // 2
    assert n == prog.n_layers - prog.routed.first_dense
    for f32_choice, bf16_choice in zip(chosen[:n], chosen[n:]):
        assert torch.equal(f32_choice, bf16_choice)
    rd = prog.d_model // 32
    assert not bool(w["layers"]["wo"][..., :rd].any())
    assert not bool(w["moe_layers"]["router"][:, rd:].any())


def test_int8_keeps_the_bias_and_the_latent_norm():
    _, _, w, prog, params = toy()
    q = tr.quantize_for_serving(params).tree()
    assert torch.equal(q["moe_layers"]["router_bias"],
                       w["moe_layers"]["router_bias"])
    assert torch.equal(q["layers"]["ln_kv"], w["layers"]["ln_kv"])
    for group, name in (("layers", "wkv_b"), ("moe_layers", "w_gate"),
                        ("moe_layers", "router"), ("dense_layers", "w_up")):
        assert q[group][name]["q"].dtype == torch.int8, (group, name)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(device="cpu", **kw):
    m, _, _, prog, params = toy(8, torch.bfloat16)
    enc = tr.TransformerConfig(name="enc", n_layers=1, d_model=32,
                               n_heads=2, n_kv_heads=2, d_head=16, d_ff=64,
                               vocab_size=m["vocab_size"], causal=False)
    enc_p = tr.init_params(enc, torch.Generator(device=device).manual_seed(1),
                           device=device)
    corpus, _, make_q = topical_corpus(32, 12, m["vocab_size"], n_topics=4)
    cfg = te.EngineConfig(**{"decode_slots": 3, "s_max": 64,
                             "max_new_tokens": 8, "page_size": 4, **kw})
    eng = te.RAGEngine(te.Component(prog, params), te.Component(enc, enc_p),
                       corpus, cfg, device=device)
    return eng, [make_q(i % 4) for i in range(5)]


def _serve(engine, questions, tracer=None):
    server = RAGServer(engine, tracer=tracer)
    reqs = [server.submit(q.copy()).request for q in questions]
    server.run_until_idle()
    assert all(r.state is State.DONE for r in reqs)
    return [list(r.output) for r in reqs]


def test_engine_serves_with_no_token_dropped():
    engine, questions = _engine(attn_impl="cuda")
    assert engine.paged_attn is latent.paged_latent_attention
    assert engine.gen_seq_attn is None and engine.chunk_attn is None
    tracer = SpanTracer()
    out = _serve(engine, questions, tracer=tracer)
    assert all(len(o) == 8 for o in out)
    assert set(engine.pool.cache) == {"kv"}
    snap = engine.metrics_snapshot()
    ticks = [s.attrs for s in tracer.spans() if s.kind == "DECODE_TICK"]
    assert ticks and len(ticks) == snap["decode_host_syncs"]
    n_exp = engine.gen.cfg.routed.n_experts
    for a in ticks:
        assert 1 <= a["experts_hit"] <= min(n_exp, a["n"] * 2)
        assert 1 <= a["expert_max"] <= a["n"]
    # the same tokens with the engine's plain attention
    ref_engine, _ = _engine(attn_impl="ref")
    assert _serve(ref_engine, questions) == out


def test_engine_refuses_what_holds_no_latent_rows():
    with pytest.raises(NotImplementedError, match="paged pool"):
        _engine(paged=False)
    with pytest.raises(ValueError, match="splitk"):
        _engine(attn_impl="splitk")
    _, _, _, prog, params = toy()
    with pytest.raises(NotImplementedError):
        tr.forward(params, torch.zeros(1, 4, dtype=torch.long), prog,
                   attn_impl=lambda *a: None)
    with pytest.raises(NotImplementedError, match="paged pool"):
        tr.make_cache(prog, 1, 8, device="cpu")


def test_latent_slot_export_import_is_bit_exact():
    """A slot's latent pages exported from one pool and imported into
    another: equal bytes, equal checksum, the payload one latent row a
    token and layer; a second import references the keyed pages."""
    m, fam, w, prog, params = toy(9, torch.bfloat16)
    prompt = torch.randint(0, m["vocab_size"], (11,),
                           generator=torch.Generator().manual_seed(5))
    _, cache = tr.prefill(params, prompt[None], prog)
    src = PagedKVCachePool(prog, 2, 32, page_size=4, device="cpu")
    slot = src.alloc(0)
    src.write_prefix(slot, cache, 11, tokens=prompt.numpy())
    payload, length = src.export_slot(slot)
    assert length == 11
    assert src.handoff_bytes(payload) == \
        11 * prog.n_layers * prog.mla.latent_dim * 2
    dst = PagedKVCachePool(prog, 2, 32, page_size=4, device="cpu")
    d_slot = dst.alloc(7)
    stats = dst.import_slot(d_slot, payload)
    assert stats.pages == 3 and stats.pages_shared == 0
    for j in range(3):
        a = src.cache["kv"][:, src.page_tables[slot][j]]
        b = dst.cache["kv"][:, dst.page_tables[d_slot][j]]
        rows = min(4, 11 - 4 * j)
        assert torch.equal(a[:, :rows], b[:, :rows])
    again, _ = dst.export_slot(d_slot)
    assert payload_checksum(again) == payload_checksum(payload)
    second = dst.import_slot(dst.alloc(8), payload)
    assert second.pages_shared == 2 and second.pages == 1


# ---------------------------------------------------------------------------
# GPU only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replayed_engine_serves_the_eager_tokens(cuda):
    eager, questions = _engine(cuda, attn_impl="cuda")
    eager.graph_decode = False
    tracer = SpanTracer()
    want = _serve(eager, questions, tracer=tracer)
    engine, _ = _engine(cuda, attn_impl="cuda")
    assert engine.graph_decode
    graph_tracer = SpanTracer()
    assert _serve(engine, questions, tracer=graph_tracer) == want
    snap = engine.metrics_snapshot()
    assert snap["decode_graph_captures"] == 1
    assert snap["decode_graph_replays"] == snap["decode_host_syncs"] - 1
    ticks = [(s.attrs["experts_hit"], s.attrs["expert_max"])
             for s in tracer.spans() if s.kind == "DECODE_TICK"]
    replayed = [(s.attrs["experts_hit"], s.attrs["expert_max"])
                for s in graph_tracer.spans() if s.kind == "DECODE_TICK"]
    assert replayed == ticks


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["drawn", "one_expert_everywhere"])
def test_dispatch_on_the_card_matches_its_loop(cuda, case):
    """bf16 on the card: the grouped dispatch against the plain loop of
    the same bf16 expert products (each pair's rows multiplied alone),
    to bf16 rounding of the sum (1e-2 of the largest output)."""
    prog, lp, x = _dispatch_case(case)
    lp = {k: v.to(cuda, torch.bfloat16 if k != "router_bias" else
                  torch.float32) for k, v in lp.items()}
    x = x.to(cuda, torch.bfloat16)
    stats = torch.zeros(2, device=cuda)
    got = tr.routed_moe_ffn(x, lp, prog, torch.bfloat16,
                            tr.RouteStats(torch.ones(3, dtype=torch.bool,
                                                     device=cuda), stats))
    xf = x.reshape(-1, prog.d_model)
    eidx, gates = tr.route_sigmoid(xf, lp, prog)
    want = torch.zeros(xf.shape, dtype=torch.float32, device=cuda)
    for t in range(xf.shape[0]):
        for j in range(prog.routed.top_k):
            e = int(eidx[t, j])
            h = torch.nn.functional.silu(xf[t] @ lp["w_gate"][e]) \
                * (xf[t] @ lp["w_up"][e])
            want[t] += gates[t, j] * (h @ lp["w_down"][e]).float()
    shared = tr.dense_ffn(xf, {"w_gate": lp["s_gate"], "w_up": lp["s_up"],
                               "w_down": lp["s_down"]}, torch.bfloat16)
    want = want.to(torch.bfloat16) + shared
    close(got.reshape(xf.shape).float(), want.float(), 1e-2)
    np.testing.assert_array_equal(stats.cpu().numpy() >= 1, True)
