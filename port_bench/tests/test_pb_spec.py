"""BENCHMARK.json within the contract's limits, and its files there."""

import json
import re
from pathlib import Path

from port_bench import harness

CHECKOUT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_names_and_files():
    spec = harness.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (CHECKOUT / c["file"]).exists()
        assert c["file"].startswith("port_bench/")
        assert json.loads((CHECKOUT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
        assert (CHECKOUT / "port_bench" / "traffic"
                / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            c = harness.cell(w)
            assert m["moves"] in {x["name"] for x in c.end_to_end}
    for w in cells:
        c = harness.cell(w)
        assert len(c.end_to_end) >= 2 and c.per_layer
        assert c.limits["logit_gap_max"]["limit"] > 0
