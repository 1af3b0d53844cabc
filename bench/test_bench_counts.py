"""The FLOP and byte counts against numbers worked out by hand, for one
prefill and one decode step of each configuration."""

import json

import pytest

from bench.core import counts as C
from bench.core import spec


def dims(config: str) -> C.Dims:
    path = spec.BENCH_DIR / "configs" / f"{config}.json"
    return C.Dims.from_model(json.loads(path.read_text())["model"])


def test_granite_prefill_and_decode_by_hand():
    dm = dims("granite-3.0-2b-rag")
    # Q 2048x2048 + K, V 2048x512 + O 2048x2048 + SwiGLU 3 x 2048x8192
    assert dm.layer_weights == 4_194_304 + 2 * 1_048_576 + 4_194_304 \
        + 3 * 16_777_216 == 60_817_408
    assert dm.head_weights == 2048 * 49155 == 100_669_440
    # 544 tokens: 2 x 40 x 60,817,408 x 544 + 2 x head (last token only)
    # + 4 x 32 x 64 x 40 x (544 x 545 / 2)
    assert C.prefill_flops(dm, 544) == 2_646_773_596_160 + 201_338_880 \
        + 327_680 * 148_240 == 2_695_550_218_240
    # two rows at contexts 600 and 700: 2 x (40 x layer + head) a row
    # + 4 x 32 x 64 x 40 x 1,300
    assert C.decode_flops(dm, [600, 700]) == 2 * 2_533_365_760 * 2 \
        + 327_680 * 1300 == 10_559_447_040


def test_granite_kernel_bounds_by_hand():
    dm = dims("granite-3.0-2b-rag")
    # a layer of paged decode reads 1,300 tokens x 8 heads x 64 x 2 (K, V)
    # x 2 B and q, out (2 rows x 32 x 64 x 2 B each): bytes-bound
    per_layer = (1300 * 2048 + 2 * 2 * 32 * 64 * 2) / 3.35e12
    assert C.paged_decode_bound_s(dm, [600, 700]) == pytest.approx(
        40 * per_layer, rel=1e-12)
    assert 40 * per_layer == pytest.approx(3.198548059701493e-05)
    # flash at 544 tokens: (2 x 544 x 32 + 2 x 544 x 8) x 64 x 2 B =
    # 5,570,560 B (1.66 us) against 1.21 GFLOP (1.23 us): bytes-bound
    assert C.flash_prefill_bound_s(dm, 544) == pytest.approx(
        40 * 5_570_560 / 3.35e12, rel=1e-12)


def test_chatglm3_prefill_and_decode_by_hand():
    dm = dims("chatglm3-6b-rag")
    assert dm.layer_weights == 16_777_216 + 2 * 1_048_576 + 16_777_216 \
        + 3 * 56_098_816 == 203_948_032
    assert dm.head_weights == 4096 * 65024 == 266_338_304
    assert dm.kv_bytes_per_token_layer == 1024      # 28,672 B a token
    # 3,624 tokens: 2 x 28 x 203,948,032 x 3,624 + 2 x head
    # + 4 x 32 x 128 x 28 x (3,624 x 3,625 / 2)
    assert C.prefill_flops(dm, 3624) == 2 * 28 * 203_948_032 * 3624 \
        + 2 * 266_338_304 + 458_752 * 6_568_500 == 44_403_874_594_816
    assert C.decode_flops(dm, [2000, 2100, 2200]) == \
        2 * (28 * 203_948_032 + 266_338_304) * 3 + 458_752 * 6300 \
        == 38_751_436_800


def test_chatglm3_kernel_bounds_by_hand():
    dm = dims("chatglm3-6b-rag")
    # flash at 3,624 tokens is compute-bound: 4 x 32 x 128 x 6,568,500
    # = 107.6 GFLOP a layer (108.8 us) against 63.1 MB (18.8 us)
    assert C.flash_prefill_bound_s(dm, 3624) == pytest.approx(
        28 * 16384 * 6_568_500 / 989e12, rel=1e-12)
    assert C.flash_prefill_bound_s(dm, 3624) == pytest.approx(
        0.0030468276157735084)
    ctx = 6300
    assert C.paged_decode_bound_s(dm, [2000, 2100, 2200]) == pytest.approx(
        28 * (ctx * 1024 + 2 * 3 * 32 * 128 * 2) / 3.35e12, rel=1e-12)


def test_counts_read_the_published_widths():
    """``Dims`` reads the dense family's keys; another family counts its
    work from keys of its own (``bench/blocks/<block>.py``)."""
    for path in (spec.BENCH_DIR / "configs").glob("*.json"):
        m = json.loads(path.read_text())["model"]
        if m.get("block") != "dense":
            continue
        dm = C.Dims.from_model(m)
        assert dm.heads * dm.head_dim == m["hidden_size"]
