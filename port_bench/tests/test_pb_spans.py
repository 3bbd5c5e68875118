"""The idle split over the program's spans (``port_bench/spans.py``) on
synthetic intervals, and the readers of the program's spans and request
times on a traced run of the tiny cell on the CPU."""

import pytest

from port_bench import spans

from . import tiny


def test_nested_spans_go_to_the_innermost():
    # idle everywhere but [40, 60)
    acts = [(40, 60)]
    sp = [(0, 100, "step"), (10, 50, "admit"), (20, 30, "chunk")]
    got = spans.idle_by_span(acts, sp, 0, 100)
    assert got == {"step": 10 + 40, "admit": 10 + 10, "chunk": 10}


def test_a_gap_over_two_spans_splits():
    acts = [(0, 10), (90, 100)]
    sp = [(5, 40, "sample"), (40, 95, "decode"), (50, 60, "replay")]
    got = spans.idle_by_span(acts, sp, 0, 100)
    assert got == {"sample": 30, "decode": 30 + 10, "replay": 10}


def test_the_parts_sum_to_the_idle_time():
    acts = [(3, 7), (5, 12), (30, 31), (70, 200)]
    sp = [(0, 20, "a"), (2, 9, "b"), (25, 60, "a"), (26, 28, "c"),
          (61, 65, "d")]
    got = spans.idle_by_span(acts, sp, 1, 150)
    idle = (150 - 1) - ((12 - 3) + (31 - 30) + (150 - 70))
    assert sum(got.values()) == idle
    assert got[spans.OUTSIDE] == (25 - 20) + (61 - 60) + (70 - 65)
    assert got["c"] == 2


def test_no_spans_is_all_outside():
    assert spans.idle_by_span([(10, 20)], [], 0, 30) == {spans.OUTSIDE: 20}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    # long enough for 20 first tokens outside the 2 s stretch
    return tiny.run_tiny(tmp_path_factory.mktemp("tiny"), seconds=8.0,
                         trace=1)


def test_the_tiny_cell_reads_the_request_times(traced):
    m = traced["metrics"]
    assert traced["correct"]
    assert m["queue_wait_p90_ms"]["value"] >= 0
    assert m["prefill_latency_p90_ms"]["value"] > 0


def test_the_tiny_cell_splits_its_idle_time(traced):
    m = traced["metrics"]
    # no device here: the whole stretch is idle, split among the spans
    parts = [m[k]["value"] for k in ("idle_share.sample", "idle_share.admit",
                                     "idle_share.chunk")]
    assert all(0 <= p <= 100 for p in parts) and parts[0] > 0
    assert sum(parts) <= m["idle_share.decode"]["value"] + 1e-9
