"""The yardstick's bytes and operations against counts worked by hand,
one shape per configuration, counted through the architecture's module
that the configuration names, and every metric file's use of them."""

import pytest

from port_bench import harness

MISTRAL = harness.cell("mistral-7b.chat-decode")
QWEN = harness.cell("qwen2.5-1.5b.rag-prefill")


def _shapes(cell):
    return cell.arch.shapes(cell.config)


def test_mistral_decode_step_by_hand():
    sh = _shapes(MISTRAL)
    w = sh.decode_step([100] * 8)
    # q4_0 layers: (6144 + 4096 + 28672) x 4096 + 4096 x 14336 weights,
    # 18 bytes a 32; the q6_K head 32000 x 4096, 210 bytes a 256
    layer = (6144 * 4096 + 4096 * 4096 + 28672 * 4096 + 4096 * 14336)
    assert layer == 218_103_808
    weights = 32 * layer // 32 * 18 + 32000 * 4096 // 256 * 210
    norms = 32 * 2 * 4096 * 4 + 4096 * 4
    kv_token = 32 * 2 * 8 * 128 * 2  # layers, k and v, heads, hd, bf16
    cache = 800 * kv_token + 8 * kv_token
    io = 8 * 4096 * 2 + 8 * 32000 * 4  # embedding rows in, logits out
    assert w.nbytes == weights + norms + cache + io == 4_141_449_216
    assert w.ops["int8"] == 2 * 8 * (32 * layer + 32000 * 4096)
    assert w.ops["bf16"] == 8 * 32 * 32 * 4 * 128 * 100
    assert w.bound_s() == pytest.approx(4_141_449_216 / 3.35e12)


def test_qwen_prefill_chunk_by_hand():
    sh = _shapes(QWEN)
    w = sh.prefill_chunk(0, 128, last=True)
    layer = 2048 * 1536 + 1536 * 1536 + 17920 * 1536 + 1536 * 8960
    assert layer == 46_792_704
    weights = 28 * layer // 32 * 18 + 151936 * 1536 // 256 * 210
    small = 28 * (2 * 1536 + 2048) * 4 + 1536 * 4 + 151936 * 4
    kv_token = 28 * 2 * 2 * 128 * 2
    cache = 128 * kv_token * 2 + 128 * 1536 * 2  # read, written; embedding
    assert w.nbytes == weights + small + cache == 937_345_024
    assert w.ops["int8"] == 2 * 128 * 28 * layer + 2 * 151936 * 1536
    assert w.ops["bf16"] == 28 * 12 * 4 * 128 * (128 * 129 // 2)
    # even at 128 rows the bytes bind: 0.280 ms against 0.171 ms of
    # operations at 1979 int8 TOP/s and 989 bf16 TFLOP/s
    assert w.bound_s() == pytest.approx(937_345_024 / 3.35e12)
    assert w.ops["int8"] / 1979e12 + w.ops["bf16"] / 989e12 < w.bound_s()


def test_window_caps_the_attended_tokens():
    sh = _shapes(MISTRAL)
    assert sh.attended(0) == 1 and sh.attended(4095) == 4096
    assert sh.attended(10_000) == 4096
    w = sh.prefill_chunk(8000, 128, last=False)
    # positions 3905 .. 8127 read once, the head not run
    kv_token = 32 * 2 * 8 * 128 * 2
    assert w.nbytes - sh.gemms(128, 0, io=False).nbytes == (
        sh.small_bytes() + (8128 - 3905) * kv_token + 128 * kv_token
        + 128 * 4096 * 2)


def test_kernel_bounds_count_inputs_and_outputs():
    sh = _shapes(QWEN)
    m = 8
    g = sh.decode_gemms(m)
    plain = sh.gemms(m, m, io=False)
    io = sum(m * k * 36 / 32 + m * n * 4 for n, k in sh.linears) * 28 \
        + m * 1536 * 36 / 32 + m * 151936 * 4
    assert g.nbytes - plain.nbytes == pytest.approx(io)
    c = sh.chunk_gemms(100, last=False)
    assert c.ops["int8"] == 2 * 100 * 28 * (2048 * 1536 + 1536 * 1536
                                            + 17920 * 1536 + 1536 * 8960)


def test_every_metric_has_a_reader():
    bench = harness.spec()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
