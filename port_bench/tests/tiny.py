"""A tiny cell for the CPU tests: a two-layer qwen2-shaped model (QKV
biases, tied q6_K head, head size 128) under a sessions mix, written into
a temporary folder beside a copy of the architectures' modules and
nothing else, and a run of it on the CPU through the same code as a run
on the card."""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import time
from pathlib import Path

import torch

from port_bench import harness, run

CONFIG = {
    "source": "a test shape",
    "arch": "llama",
    "published": {"hidden_size": 256, "intermediate_size": 512,
                  "num_hidden_layers": 2, "num_attention_heads": 2,
                  "num_key_value_heads": 1, "vocab_size": 512,
                  "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
                  "rope_theta": 1000000.0, "tie_word_embeddings": True},
    "reduced": [],
    "served": {"tensor_types": {"layers": "q4_0", "token_embd": "q6_K",
                                "output": "q6_K"},
               "qkv_bias": True, "window": 0, "ring": False, "n_slots": 4,
               "prefill_bucket": 16, "cache_qtype": "bf16"},
    "weights": {"scale": 1.0, "head_scale": 2.0, "bias_std": 0.1},
}
MIX = {"clients": 4, "pool": 6, "turns": [2, 3], "system_prompts": 2,
       "system_tokens": 40,
       "prompt_tokens": {"dist": "log_normal", "median": 18, "sigma": 0.5,
                         "min": 8, "max": 40},
       "output_tokens": {"dist": "uniform", "min": 6, "max": 14},
       "lead_in_finished": 2,
       "check": {"served_tokens": 100, "max_requests": 8}}
#: the tiny cell's limit, between its sound runs' widest gap and its
#: control's (``test_pb_control.py`` reads both)
LIMIT = 0.5
CELL = "tiny.sessions"


def write(root: Path, config=None, mix=None) -> dict:
    """The tiny cell's files under ``root``; returns a BENCHMARK.json
    object that holds it besides the repository's cells."""
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(harness.ROOT / "archs", root / "archs",
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(config or CONFIG))
    (root / "traffic" / "sessions.json").write_text(json.dumps(mix or MIX))
    (root / "limits" / f"{CELL}.json").write_text(
        json.dumps({"logit_gap_max": {"limit": LIMIT}}))
    bench = copy.deepcopy(harness.spec())
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "sessions", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return bench


def cell(root: Path) -> harness.Cell:
    return harness.cell(CELL, root, write(root))


def run_tiny(root: Path, seed: int = 2 ** 31 + 11, seconds: float = 2.0,
             trace: int = 0, cell_=None) -> dict:
    """One run on the CPU of the tiny cell, or of ``cell_`` (a
    ``harness.Cell``): the result object."""
    cell_ = cell_ or cell(root)
    args = argparse.Namespace(workload=cell_.name, seed=seed,
                              seconds=seconds, trace=trace)
    return run.result(args, torch.device("cpu"), time.perf_counter(),
                      cell_)
