"""A configuration, a traffic mix and a per-layer metric are files of
their own, found by name: adding one edits no file that is there."""

import json

from port_bench import harness, traffic

from . import tiny


def test_new_config_and_mix_found_by_name(tmp_path):
    config = dict(tiny.CONFIG, source="another shape")
    mix = dict(tiny.MIX, clients=3)
    bench = tiny.write(tmp_path, config, mix)
    cell = harness.cell(tiny.CELL, tmp_path, bench)
    assert cell.config["source"] == "another shape"
    assert cell.mix["clients"] == 3
    assert cell.limits["logit_gap_max"]["limit"] == tiny.LIMIT
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"output_tok_s", "itl_p95_ms", "ttft_p90_ms",
                     "prompt_tok_s", "setup_s"}
    assert traffic.load("sessions", tmp_path)["clients"] == 3


def test_new_metric_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.steps) / run.seconds\n")
    read = harness.reader("steps_per_s", tmp_path)

    class Run:
        steps = [0] * 30
        seconds = 3.0

    assert read(Run()) == 10.0


def test_a_metric_without_workloads_follows_what_it_moves(tmp_path):
    bench = tiny.write(tmp_path)
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "host_clock", "layer": "server",
                               "moves": "prompt_tok_s"})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    per = {m["name"] for m in harness.cell(tiny.CELL, tmp_path,
                                           bench).per_layer}
    assert "steps_per_s" in per
    rag = harness.cell("qwen2.5-1.5b.rag-prefill", harness.ROOT, bench)
    assert "steps_per_s" in {m["name"] for m in rag.per_layer}
    decode = harness.cell("mistral-7b.chat-decode", harness.ROOT, bench)
    assert "steps_per_s" not in {m["name"] for m in decode.per_layer}
