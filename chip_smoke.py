#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (quant_gemm_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the serving path from
   ``quant_gemm_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: each of K1-K10 at the shapes its paths give it
   (K3 and K5 also with the int8 cache and a window of 256, and on the
   Mistral path's ring; K1 and K4
   also with q4_K weights in their effective form at the Q4_K_M shapes;
   K7 with q6_K at its three shapes and with q3_K and q2_K at the
   lm_head's, each equal bit for bit to ``k1_order`` of its block terms
   and beside K1's q8_0 form at the same N and K; K6 on q4_0 at the q4_0
   decode shapes and on q4_K at the Q4_K_M ones, each equal bit for bit
   to quantize_q8_1 + K1, also on zero and f16-saturating blocks; K8 at
   TinyLlama-1.1B and Mistral-7B-v0.1 width, M = 8 and 1, beside K6 on
   its three weights, and its wo and w_down stages bit for bit at both
   widths on inputs that make the glue exact), against
   its plain PyTorch version at the stated tolerance, timed with CUDA
   events (L2
   flushed before every timed launch: ``harness.benchmark.DeviceTimer``)
   beside its bound (``harness.profiling.bound``) (K-quant weights
   at their GGUF block bytes, the bound over the port's larger layout
   beside it) and, where one PyTorch call computes the same function,
   that call's time (K2, K6 and K8 also beside the unfused kernel chain
   they replace, K6 also beside K1 alone on the same codes; every K2 row
   also equal bit for bit to quantize_q8_1 + K1 on rows whose RMSNorm is
   exact);
3. main path: the q4_0 W4A8 continuous-batching ``Server(qp, cfg,
   n_slots=8)`` at its defaults (prefill chunk 128, prompt caching) at
   TinyLlama-1.1B width (22 layers, random weights from a seed, quantized
   on the card) serves 16 greedy requests, eight of them opening with a
   shared 256-token system prompt, with the bf16 cache and again with the
   int8 cache; each kernel's launches, counted from 0 for each run, must
   match the path's, and the reused prompt tokens the traffic's; then two
   128-token prefill chunks and one decode step per cache run through the
   kernels and through the plain versions from the same hidden state at
   every layer, and each layer's output and the logits must agree;
   then the decode fusions, each switch set around its run and restored:
   (a) ``registry.FUSED_DECODE`` serves the same 16 requests with K6 in
   place of K1 (K6 67 launches per decode step, K1 none) and must give
   the default run's 16 transcripts token for token; (b) with
   ``gemm_megalayer.ENABLE_TAIL`` too, K8 once per layer and K6 for the
   lm_head (the transcripts' agreement with the default run is printed),
   then the layer-by-layer decode check and a ``torch.profiler``
   breakdown of its decode step beside the default step's;
4. Q4_K_M path: a GGUF file in llama.cpp's Q4_K_M mix at TinyLlama-1.1B
   width (random valid blocks from a seed, written to a temporary
   directory and removed) is loaded with ``gguf_loader.load_llama`` onto
   the card and serves the same 16 requests with ``Server(qp, cfg,
   n_slots=8)``: K1 and K4 on its q4_K weights, K7 and the plain float32
   prefill matmul on its q6_K ones, counted against the path's launches;
   then the layer-by-layer check for a 128-token chunk and a decode step,
   and a ``torch.profiler`` breakdown of one decode step and one chunk
   (device time by kernel group, idle share; it fails when the profiler
   sees no hand kernel); then (c) ``FUSED_DECODE`` on this file: K6 on
   its q4_K decode GEMMs (88 per step), K7 unchanged, and the
   layer-by-layer decode check;
5. formats path (slice 7): a GGUF file of each of llama.cpp's Q8_0,
   Q5_0, Q4_1, Q5_1 and Q5_K_M mixes (``FILE_MIXES``) at TinyLlama-1.1B
   width, all 22 layers (random valid blocks from a seed, one file on
   disk at a time), loaded with ``load_llama`` and served with
   ``Server(qp, cfg, n_slots=8)`` at its defaults, the first 8 requests
   of the traffic: load seconds and device bytes against file bytes, each
   kernel's launches against ``route_launches`` (K2 22 per decode step on
   Q4_1, Q5_0, Q5_1, none on Q8_0 and on Q5_K_M, whose more-bits layers
   hold a SplitLinear wqkv; K7 on the q6_K tensors), the layer-by-layer
   check of a chunk and a decode step; then Q4_1 and Q8_0 again with
   ``FUSED_DECODE`` (K6's q4_1 and q8_0 forms), whose transcripts must
   equal the default run's token for token;
6. foreign bytes: ``tests/golden/tiny_llama_q4km.gguf`` (written by an
   independent generator) loads onto the card, and its pinned greedy
   transcript, teacher-forced through the kernels, must be the argmax at
   every step or a printed near-tie;
7. Mistral path, at Mistral-7B-v0.1 width (32 layers, hidden 4096, 8 KV
   heads of 128, window 4096; random q4_0 weights from a seed, built on
   the card) on the ring KV cache (``ring_chunk`` 256, R = 4608 slots):
   (m1) ``Server(qp, cfg, n_slots=8)`` serves four greedy requests
   (prompts of 4600, 4800, 5100 and 300 tokens, 64 new each: the first
   crosses the ring's edge decoding, the next two wrap it in prefill),
   each kernel's launches counted from 0 against the path's, the cache
   ``[32, 8, 8, 4608, 128]``, no prompt reuse; (m2) kernels against plain
   versions layer by layer on the ring (a 128-token chunk across the edge
   at pos0 R - 64, an 8-slot decode step on both sides of R; bf16 and
   q8), and the ring against a linear window-4096 cache holding the same
   random rows (each layer's update NMSE <= 1e-4); (m3) the linear
   windowed cache at max_seq 4608 with ``context_shift=True``: a
   4600-token prompt generates 64 tokens, shifted at 4607 to the window's
   4096, then one decode step from a shifted cache against an unshifted
   one, layer by layer (``SHIFT_TOL``); ``torch.profiler`` breakdowns of
   a ring decode step past R and of a chunk; the kernel phase holds K3
   and K5 on the ring and K1, K2, K4 at these shapes;
8. spec phase (slice 6): the port's spec runner (``quant_gemm_tpu_torch.
   specs.spec_runner.run_spec``) on the card over every committed
   definition (each must pass its threshold), every gemm definition again
   under each ladder rung its activation takes (``pallas_exact`` for a
   Q8_1 activation, ``pallas_f32``, ``pallas_bf16``, ``pallas``,
   ``pallas_fused_quant`` for a float one, ``xla_dequant``, ``xla_int``,
   ``xla_compensated``), and at full width:
   rmsnorm at 8/128/4096 x 4096, softmax at 8 x 32000 and 4096 x 4608,
   the ten gemm definitions at Mistral's ``wqkv`` and ``w_down`` (M = 128
   through K4 on float32 activations, and M = 8 through K1 for a Q8_1
   one); K9, K10, K1, K4 (and K3, K5) launches counted from 0 against the
   phase's; the kernel phase holds K9 and K10 at those shapes, at the
   definitions' own 5 x 512 and at a ragged 7 x 1000, each twice (the
   same bits), and K1 (M = 8) and K4 (M = 128, bf16 and float32
   activations, beside ``torch.matmul`` on the weight dequantized in
   advance) in the q4_0, q4_1, q5_0, q5_1 and q8_0 forms at Mistral's
   ``wqkv`` and ``w_down``;
   slice 7's rows: K2 in the q4_1, q4_k, q5_0, q5_1 and q5_k forms at
   TinyLlama's and Mistral's ``wqkv``, K6 in q4_1 and q8_0 at TinyLlama's
   four decode GEMMs (bit for bit against quantize_q8_1 + K1), K1 and K4
   on q5_k at TinyLlama's ``wqkv`` and ``w_down``, and K4 ``fused_quant``
   (bf16 and float32 operands) at Mistral's ``wqkv`` and ``w_down``
   against its plain version at NMSE <= ``FQ_NMSE`` (only the summation
   order differs), beside ``torch.matmul`` on the weight dequantized and
   the activation fake-quantized in advance, and its prologue bit for bit
   through a q8_0 identity weight at both K;
9. GGUF user path (slice 14) at Qwen2.5-1.5B-Instruct width (28 layers,
   hidden 1536, 12 / 2 heads of 128, rep 6, d_ff 8960, vocab 151936, QKV
   biases, tied embeddings): a byte-level BPE vocabulary of 151936
   entries drawn from a seed (``pre`` qwen2, Qwen's specials at
   151643-151645, a ChatML template) goes into a GGUF file of llama.cpp's
   Q4_0 mix (q4_0 linears, no ``output.weight``: ``token_embd`` q6_K is
   the tied head, f32 norms and biases), one of its IQ4_XS mix and one
   of its IQ4_NL mix (``FILE_MIXES``: iq4_xs or iq4_nl, attn_v and the
   first eighth's ffn_down q5_K; iq4_nl is served as q8_0); each is
   loaded with ``load_llama`` (structure and config
   checked) and served by the port's HTTP front end
   (``scripts/server.py``, 127.0.0.1, an Engine over ``Server(qp, cfg,
   n_slots=8)`` at its defaults): 16 (IQ4: 8) concurrent chat turns
   (a shared 200-token system prompt, user turns of 64-512 tokens, 32 new
   tokens, greedy, one streamed) through ``/v1/chat/completions`` (or,
   where jinja2 does not import, as ChatML text through ``/completion``,
   said so); each HTTP transcript must equal a Server fed the same ids at
   the same steps (``admissions`` records them), eager and captured (their
   launches checked against ``route_launches``, the captured pair's graphs,
   medians, prefill tok/s and profiler windows printed); on the Q4_0
   file also a JSON-grammar request (4 tokens, its seconds a token), an
   ``n_probs: 5`` request and ``/v1/embeddings`` of 4 inputs, each equal
   to the Server or ``llama.embed`` driven directly; the layer-by-layer
   check of a chunk and a decode step on every file; the IQ4_XS file
   again with ``FUSED_DECODE`` (K6's iq4_xs form), its transcripts equal
   to the default run's; the kernel phase holds K1, K4 and K6 in the
   iq4_xs form, K1, K2, K4 in q4_0 and K7 (the tied head, N 151936) at
   these shapes and K3 / K5 at KV 2, rep 6, hd 128;
10. slice 15, the rest of the serving surface (its own seconds printed
   as it goes, a budget of 120 s): K4 on bf16 activations at M 1 and 8
   at TinyLlama's five GEMMs in the kernel phase (beside ``torch.matmul``
   in bf16 on the weight dequantized in advance); at TinyLlama width
   ``Server(prefill_a16=True)``, ``Server(act_mode="bf16")`` and
   ``w_down_a16`` (again with ENABLE_TAIL, where K8 serves w_down), each
   eager and captured on 8 requests with its launches checked and the
   kernels against plain versions layer by layer in its mode; the
   perplexity of a seeded 4096-token stream (ctx 512, stride 256)
   through ``scripts/perplexity.py``'s ``report``, q8_1 and bf16,
   kernels against plain versions to a relative 1e-3; an all-q4_0
   TinyLlama-width GGUF with a 32000-entry vocabulary and an
   ``export_lora`` adapter (rank 16, alpha 32, f16, attn_q/k/v/output and
   ffn_gate/up/down of every layer) through ``build_engine(lora_path=)``,
   eager and captured, and ``generate --lora``, K2 and K8 off, the first
   step against the deltas merged into the dequantized weights through
   ``forward_float``; speculative decoding with a Mistral-7B-v0.1-width
   target (k 4, B 4, 64 new, greedy) and a TinyLlama-width draft, then
   the target as its own draft (each transcript the target's greedy
   decode under the near-tie rule; the self draft at least 0.9 of
   ``speculative.best_rate``), and ``sample_decode`` beside a Server on
   one seed; a Llama-3.2-1B-width bf16 safetensors checkpoint (4 of 16
   layers, 2 shards) through ``load_hf_llama`` (weights bit-equal to
   ``quantize_params``, the llama3 RoPE table) served at max_seq 4096;
   ``api.gemm_q4_0_q8_1`` at 4 x 4096 x 4096 on the card (bit-equal to
   ``k1_order`` of the golden's block terms, within 1e-5 x max|C| of
   the float64 golden), ``compat.gemm_from_ggml`` on a GGUF view and the
   ``ggml_op_*`` drop-ins against the port's ops;
11. slice 16, QAT and tensor parallelism: (q1) AdamW QAT (optax's
   defaults, q4_0 fake quantization, straight-through gradient) at
   TinyLlama-1.1B width from ``init_params`` floats, 4 x 256 seeded
   tokens, 5 steps with remat and 3 without (the loss must fall; ms a
   step, tokens/s and ``max_memory_allocated`` printed), then
   ``accum_steps=2`` on the same batch (the first loss to 1e-5
   relative); (q2) the loss and every gradient of one step at full
   width, 2 layers, on the card against the port on the CPU (loss 1e-5
   relative, each gradient within 1e-4 of its largest element); (q3)
   ``quantize_params`` of the trained floats dequantizes to
   ``fake_quant_ste`` of them bit for bit on all 89 linears, and a
   captured and an eager Server serve 4 greedy requests from them
   (launches checked, kernels vs plain versions layer by layer); (t1)
   two spawned ranks share the card over gloo (NCCL refuses two ranks
   on one device): ``shard_params_tp`` of TinyLlama-width q4_0 weights
   (all 22 layers), a prefill of 2 x 128 tokens and 8 decode steps with
   each cache through ``forward_tp``, each rank's launches checked (K1
   to K5 run, K8 does not), the ranks' logits the same bits; against
   the single-device forward, each TP layer fed the single-device state
   (update NMSE <= 1e-4) and the free runs' logits NMSE within 4 x that
   of the single device's own run under 1e-7 relative noise on every
   GEMM output (the Q8_1 and bf16 roundings turn the row-parallel sums'
   order into this much, and no less: atol/rtol 1e-3 does not hold
   here); a float witness, 2 layers of float32 weights and activations
   through ``forward_tp`` on the ranks' Megatron chunks, within
   atol/rtol 1e-3 of the single device on every call; gloo all-reduce
   times, the sharded GEMMs against the unsharded kernels; (t2) the
   heartbeat (``health.check``) on both ranks, one sharded AdamW step on
   a dp 1 x tp 2 mesh at full width, 2 layers, against the
   single-process step (loss 1e-5 relative, the step's gradients within
   1e-5 of each leaf's largest, params 1e-5 where |grad| >= 1e-6), and
   ``scripts/multihost.py --nproc 2``;
12. slice 17, the measuring and spec tools: (h1) the deviceless compile
   gate (``harness/aot.py::aot_compile``: every source again for sm_90a
   with no GPU visible), its ``resource_report`` table printed and equal
   to the start-up build's registers, stack and spills; (h2)
   ``harness/benchmark.py::interleaved_medians`` over K1 (TinyLlama's five
   decode GEMMs, M 8), K2, K3 (bf16, ctx 512), K4 (the five GEMMs, M 128,
   bf16 A) and K5 (T 128) with SDPA and ``torch.matmul`` in the same
   rounds, each beside ``profiling.roofline`` and the kernel phase's time
   (K1 and K4 within 1.3x of it); (h3) a q4_0 Server with its graphs
   serves 8 requests (launches checked) and ``profiling.trace`` of one
   replay of its most-replayed decode graph must hold each of the
   replay's K1, K2 and K3 launches; (h4)
   the ring GEMMs (``col_ring`` at ``wqkv``, ``row_ring`` at ``w_down``,
   M 8) on two gloo ranks sharing the card: ``overlap_report`` of a call
   1 overlapped and 0 blocking, of the blocking schedule (the same call
   with ``overlap=False``) 0 and 1, the outputs bit-equal, ms a call of
   both; (h5) every K-quant tensor of the Q4_K_M file decoded from CPU
   bytes by the host codec (``native.py``) and by the torch decode, and
   from CUDA bytes by the torch decode, bit-equal, each timed; (h6) every
   solution's entry point callable;
13. prints one JSON line of the kernels (the ten TPU kernels and the two
   activation quantize launches), the card, and last the result line;
   each phase's seconds on its own line.

The activation quantize (``kernels/act_quant.py``, not a TPU kernel):
every decode GEMM that K2, K6 or K8 do not serve quantizes its input with
one ``quantize_q8_1`` launch and every K4 call takes its bf16 operand from
one ``quantize_fold_q8_1`` launch; the kernel phase holds both bit for bit
to their torch twins at the TinyLlama and Mistral shapes, and every
serving run's launch rules count them.  Captured against eager: every
Server run (the q4_0 bf16, q8, (a) and (b) runs, Q4_K_M and (c), each
formats file and its FUSED_DECODE run, (m1) and (m3)) runs first eagerly
(``serve.CUDA_GRAPHS = False``) and then, in a new Server on the same
traffic, replaying its decode steps and prefill chunks from CUDA graphs;
the transcripts must be equal token for token and the launches the card
ran equal too (a replay moves no Python counter: each graph's launches
per replay, as its capture counted them, times its replays); each pair
prints its graphs (launches per replay, replays, seconds of each key's
first call and capture), both median decode steps and prefill tok/s, and
the profiler's view of one decode replay (the q4_0 bf16, Q4_K_M and m1
pairs also of one 128-token chunk replay).  The eager profiler windows
list the "other" group by kernel name (its 12 largest), and the q4_0
decode step and chunk run once more with the quantize routed through
the torch twin's chain, as before its launch.

K4 (every form: a float32 operand as three bf16 pieces), K5, K3, K1
and the kernels on K1's body (K2, K6, K7, K8) run on the tensor cores;
every K3, K4, K5, K7, K8, K9 and K10 row of
the kernel phase calls the kernel a second time and fails unless the two
outputs are equal bit for bit (K3 rows print their
piece count ``ns``; the Mistral ring rows run once more with the
Server's ``s_hi`` at those positions and one tile a piece, within 2e-3
of the first call); every K1 row (all seven forms) must equal
``gemm_exact.k1_order`` of the plain version's per-block terms bit
for bit (the summation order K2, K6, K7 and K8 share); K4 also runs at M = 100
and 300 at Mistral's ``wgu`` (ragged rows, more than one row tile).  The
profiler windows print each kernel group's share of the busy time.

Exits non-zero, with no result line, when CUDA is unavailable or any phase
fails.  TF32 is off for every float32 product (``allow_tf32 = False``), so
the plain versions are full float32.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_START = time.perf_counter()  # the process's age, for the traces
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# TinyLlama-1.1B (huggingface.co/TinyLlama/TinyLlama-1.1B-Chat-v1.0
# config.json): hidden 2048, intermediate 5632, 22 layers, 32 heads,
# 4 KV heads, vocab 32000, rope_theta 10000, rms_norm_eps 1e-5
DIM, D_FF, LAYERS, HEADS, KV_HEADS, VOCAB = 2048, 5632, 22, 32, 4, 32000
HD = DIM // HEADS
REP = HEADS // KV_HEADS

# Mistral-7B-v0.1 (huggingface.co/mistralai/Mistral-7B-v0.1 config.json):
# hidden 4096, intermediate 14336, 32 layers, 32 heads, 8 KV heads, vocab
# 32000, rope_theta 10000, rms_norm_eps 1e-5, sliding_window 4096,
# max_position_embeddings 32768; served on the ring cache with ring_chunk
# 256, so R = 4608 slots (LlamaConfig.ring_capacity)
M_DIM, M_D_FF, M_LAYERS, M_HEADS, M_KV = 4096, 14336, 32, 32, 8
M_WINDOW, M_MAX_SEQ, M_RING_CHUNK, M_RING = 4096, 32768, 256, 4608
M_HD = M_DIM // M_HEADS
M_REP = M_HEADS // M_KV
M_LIN_SEQ = 4736  # the linear caches compared with the ring and the shift
M_SHIFT_PROMPT = 4600  # (m3): reaches max_seq - 1 = 4607 after 7 steps
# m3: the shifted cache's step and the unshifted one's, layer by layer,
# max|delta| / max|reference| of each layer's update and of the logits.
# Measured on the H100 (PERF.md): 1.52e-2 (worst layer) and 3.5e-3
# (logits), the shifted keys rounded to bf16 again after their rotation;
# the limit is twice the worst reading, JAX's own rel max
# (tests/test_model.py:277)
SHIFT_TOL = 3e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def q4_bytes(n: int, k: int) -> int:
    return n * k // 2 + n * (k // 32) * 2


# bytes of one GGUF block of 256 weights (ggml-common.h block_q*_K): what
# a K-quant weight holds, and what bound_ms counts for it
KQ_BLOCK_BYTES = {"q4_K": 144, "q5_K": 176, "q6_K": 210, "q3_K": 110,
                  "q2_K": 84}
# bytes of one block of 32 weights (ggml-common.h block_q*): what a
# per-32 weight holds, and what bound_ms counts for it
Q32_BLOCK_BYTES = {"q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24,
                   "q8_0": 34}


def kq_bytes(qtype: str, n: int, k: int) -> int:
    return n * k // 256 * KQ_BLOCK_BYTES[qtype]


def q4k_layout_bytes(n: int, k: int) -> int:
    """q4_k as the port stores it: codes plus f32 d' and m' per 32."""
    return n * k // 2 + n * (k // 32) * 8


def k16_layout_bytes(w) -> int:
    """A K16 weight as the port stores it: int8 codes plus an int8 sc per
    16 and an f16 d per 256 (and q2_K's mn and dmin as much again)."""
    scales = w.n * (w.k // 16) + w.n * (w.k // 256) * 2
    return w.n * w.k + scales * (2 if w.dmin is not None else 1)


# llama.cpp's Q4_K_M mix (llama_tensor_get_type) at TinyLlama-1.1B width:
# attn_v and ffn_down are q6_K in the use_more_bits layers (i < n/8, i >=
# 7n/8, or (i - n/8) % 3 == 2), output is q6_K, every other linear and the
# embedding q4_K
MORE_BITS = [i for i in range(LAYERS) if i < LAYERS // 8
             or i >= 7 * LAYERS // 8 or (i - LAYERS // 8) % 3 == 2]
# llama.cpp's file mixes (llama_tensor_get_type, no importance matrix)
# at TinyLlama-1.1B width: "default" is every linear's and the
# embedding's type, "output" the output's, "more_bits" attn_v's and
# ffn_down's in the MORE_BITS layers; "file_type" the GGUF
# general.file_type (LLAMA_FTYPE_MOSTLY_*); "k2": K2 takes every decode
# step's wqkv (one whole 4/5-bit weight in every layer)
FILE_MIXES = {
    "Q4_K_M": {"default": "q4_K", "output": "q6_K", "more_bits": "q6_K",
               "file_type": 15, "k2": False},
    "Q8_0": {"default": "q8_0", "output": "q8_0", "file_type": 7,
             "k2": False},
    "Q5_0": {"default": "q5_0", "output": "q6_K", "file_type": 8,
             "k2": True},
    "Q4_1": {"default": "q4_1", "output": "q6_K", "file_type": 3,
             "k2": True},
    "Q5_1": {"default": "q5_1", "output": "q6_K", "file_type": 9,
             "k2": True},
    "Q5_K_M": {"default": "q5_K", "output": "q6_K", "more_bits": "q6_K",
               "file_type": 17, "k2": False},
    # the Qwen2.5-1.5B-width files (QWEN_MIXES): tied embeddings, so
    # token_embd takes the output's type (q6_K); IQ4_NL / IQ4_XS give
    # attn_v q5_K where n_head / n_head_kv >= 4 (6 here) and ffn_down q5_K
    # in the first eighth of the layers (no importance matrix)
    "Q4_0": {"default": "q4_0", "output": "q6_K", "file_type": 2,
             "k2": True},
    "IQ4_NL": {"default": "iq4_nl", "output": "q6_K", "attn_v": "q5_K",
               "first_down": "q5_K", "file_type": 25, "k2": False},
    "IQ4_XS": {"default": "iq4_xs", "output": "q6_K", "attn_v": "q5_K",
               "first_down": "q5_K", "file_type": 30, "k2": False},
    # the slice-15 LoRA base: a TinyLlama-width file all in q4_0 (the
    # init_qparams model's format), so that K2 and K8 take it without LoRA
    "all Q4_0": {"default": "q4_0", "output": "q4_0", "file_type": 2,
                 "k2": True},
}
# the formats path's files, and those served again with FUSED_DECODE
FORMAT_FILES = ("Q8_0", "Q5_0", "Q4_1", "Q5_1", "Q5_K_M")
FUSED_FILES = ("Q4_1", "Q8_0")
Q4KM_Q4K_SHAPES = {"wqkv": (HEADS * HD + 2 * KV_HEADS * HD, DIM),
                   "wq, wo": (HEADS * HD, DIM), "wk": (KV_HEADS * HD, DIM),
                   "wgu": (2 * D_FF, DIM), "w_down": (DIM, D_FF)}
Q4KM_Q6K_SHAPES = {"attn_v": (KV_HEADS * HD, DIM), "ffn_down": (DIM, D_FF),
                   "output": (VOCAB, DIM)}


# K4 fused_quant against its plain version: both feed the same fake-
# quantized operand, so only the float32 summation order differs (about
# 1e-12 at the spec shapes); leaving the fake quantization out moves the
# output by about 3e-5 in NMSE, rounding d to f16 by about 3e-6
FQ_NMSE = 1e-8


def same_bits(label, got, fn) -> None:
    """K3-K5, K7-K10 are deterministic: a second call gives the same
    bits."""
    if not torch.equal(got, fn()):
        fail(f"{label}: two calls differ (the kernel is not deterministic)")


def k1_bits(label, w, a, got) -> None:
    """K1 keeps the summation order K2, K6, K7 and K8 share: its output
    equals ``k1_order`` of the plain version's per-block terms bit for
    bit."""
    from quant_gemm_tpu_torch.kernels.gemm_exact import block_terms, k1_order

    if not torch.equal(got, k1_order(block_terms(w, a))):
        fail(f"K1 gemm_exact {label}: differs from k1_order of the plain "
             "version's terms (the summation order moved)")


def k2_bits(label, w, dev) -> None:
    """K2 runs K1's body and order: where its RMSNorm is exact (rows of
    +-1, eps 0, so h = x * w) it equals quantize_q8_1 + K1 bit for bit."""
    from quant_gemm_tpu_torch.formats.quant import quantize_q8_1
    from quant_gemm_tpu_torch.kernels.gemm_exact import gemm_exact
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import norm_qkv

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.where(torch.rand(8, w.k, generator=g, device=dev) < 0.5,
                    -1.0, 1.0)
    nw = 1.0 + 0.3 * torch.randn(w.k, generator=g, device=dev)
    if not torch.equal(norm_qkv(w, x, nw, 0.0),
                       gemm_exact(w, quantize_q8_1(x * nw))):
        fail(f"K2 norm_qkv {label}: differs from quantize_q8_1 + K1 on rows "
             "whose RMSNorm is exact")


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return ((got - ref).pow(2).sum() / ref.pow(2).sum()).item()


def kernel_phase(dev, timer):
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats.quant import (quantize_q4_0,
                                                    quantize_q8_0,
                                                    quantize_q8_1)
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        gemm_dequant, gemm_dequant_plain)
    from quant_gemm_tpu_torch.kernels.gemm_exact import (
        gemm_exact, gemm_exact_fused, gemm_exact_fused_plain,
        gemm_exact_plain, k1_order)
    from quant_gemm_tpu_torch.kernels.gemm_exact_k16 import (
        gemm_exact_k16, gemm_exact_k16_plain, k16_block_terms)
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import (
        attn_tail, attn_tail_plain, norm_qkv, norm_qkv_plain)
    from quant_gemm_tpu_torch.kernels.registry import (fold_q8_1,
                                                       k16_dequant_gemm)
    from quant_gemm_tpu_torch.ops.activations import silu_mul
    from quant_gemm_tpu_torch.ops.attention import (
        flash_decode, flash_decode_plain, flash_prefill, flash_prefill_plain)
    from quant_gemm_tpu_torch.ops.rms_norm import rms_norm

    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def weight(n, k):
        return layout.prepare(quantize_q4_0(randn(n, k, scale=k ** -0.5)))

    shapes = {"wo": (DIM, DIM), "wgu": (2 * D_FF, DIM),
              "w_down": (DIM, D_FF), "lm_head": (VOCAB, DIM)}
    weights = {name: weight(n, k) for name, (n, k) in shapes.items()}
    # the Mistral path's GEMMs (M_DIM wide), rows beside the main ones
    m_shapes = {"wo": (M_DIM, M_DIM), "wgu": (2 * M_D_FF, M_DIM),
                "w_down": (M_DIM, M_D_FF), "lm_head": (VOCAB, M_DIM)}
    m_weights = {f"Mistral {name}": weight(n, k)
                 for name, (n, k) in m_shapes.items()}
    m_wqkv = weight(M_HEADS * M_HD + 2 * M_KV * M_HD, M_DIM)
    rows = []  # per-shape detail

    def record(kernel, shape, err, check, ms, plain_ms, bnd, lib_ms,
               main=True, layout_bnd=None):
        """One row; ``main``: the variant the default server runs (the
        kernels line sums those, and lists every row).  ``layout_bnd``:
        the bound over the bytes of the port's layout where it holds more
        than the format (a note; ``bnd`` counts the format's bytes)."""
        rows.append({"kernel": kernel, "shape": shape, "max_abs_err": err,
                     "check": check, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": lib_ms, "main": main,
                     "layout_bound_ms": layout_bnd and layout_bnd[0]})
        lib = "null" if lib_ms is None else f"{lib_ms:.5f}"
        lay = "" if layout_bnd is None else \
            f" layout_bound_ms={layout_bnd[0]:.5f}"
        print(f"  {kernel:13s} {shape:50s} kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={bnd[0]:.5f} ({bnd[1]})"
              f"{lay} library_ms={lib} max_abs_err={err:.3e} [{check}]",
              flush=True)

    def unfused(label, ms, key="unfused_ms"):
        """The time of the unfused kernel chain a fused row replaces, or
        (``key``) of another yardstick beside the row: "k1_ms" K1 alone on
        the same codes, "k6_ms" K6 on each of the same weights, summed,
        "k1_q8_0_ms" K1's q8_0 form at the same N, K and codes."""
        rows[-1][key] = ms
        what = {"unfused_ms": "unfused", "k1_ms": "K1 alone",
                "k6_ms": "K6 summed", "k1_q8_0_ms": "K1 q8_0"}[key]
        print(f"  {'':13s} {what} ({label}): {ms:.5f} ms", flush=True)

    # K1: exact decode GEMM at M = 8
    m = 8
    for name, w in [*weights.items(), *m_weights.items()]:
        a = quantize_q8_1(randn(m, w.k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact {name}: max|err| {err} > {tol}")
        k1_bits(name, w, a, got)
        nbytes = q4_bytes(w.n, w.k) + m * w.k + 2 * m * (w.k // 32) * 2 \
            + m * w.n * 4
        record("gemm_exact", f"{name} M={m} N={w.n} K={w.k}", err,
               f"max|err| <= {tol:.3e}, == k1_order bit for bit",
               timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "int8"), None,
               main=name in weights)

    # K2: norm + quantize + wqkv at M = 8
    wqkv = weight(HEADS * HD + 2 * KV_HEADS * HD, DIM)
    for name, w in (("wqkv", wqkv), ("Mistral wqkv", m_wqkv)):
        x = randn(m, w.k, scale=3.0)
        nw = 1.0 + 0.1 * randn(w.k)
        got, ref = norm_qkv(w, x, nw, 1e-5), norm_qkv_plain(w, x, nw, 1e-5)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 2e-3 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K2 norm_qkv {name}: max|err| {err} > {tol}")
        nbytes = q4_bytes(w.n, w.k) + m * w.k * 4 + w.k * 4 + m * w.n * 4
        k2_bits(name, w, dev)
        record("norm_qkv", f"{name} M={m} N={w.n} K={w.k}", err,
               f"max|err| <= {tol:.3e}, == quantize_q8_1 + K1 on exact rows",
               timer(lambda: norm_qkv(w, x, nw, 1e-5)),
               timer(lambda: norm_qkv_plain(w, x, nw, 1e-5), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "int8"), None,
               main=w is wqkv)
        unfused("rms_norm + quantize_q8_1 + K1", timer(
            lambda: gemm_exact(w, quantize_q8_1(rms_norm(x, nw, 1e-5)))))

    # K3: flash decode, B=8 slots at context 512 over the stacked cache:
    # bf16, int8 codes with per-token scales, and a window of 256
    b, s, ctx, layer = 8, 2048, 512, 5
    shape = (LAYERS, b, KV_HEADS, s, HD)
    kc = randn(*shape).to(torch.bfloat16)
    vc = randn(*shape).to(torch.bfloat16)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    s8 = dict(k_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev),
              v_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev))
    caches = {"bf16": (kc, vc, {}), "int8": (k8, v8, s8)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    span = torch.arange(s, device=dev)
    q = randn(b, KV_HEADS, REP, HD)
    kcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    vcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    for ctype, window in (("bf16", 0), ("int8", 0), ("bf16", 256)):
        k_, v_, sc = caches[ctype]
        kw = dict(k_current=kcur, v_current=vcur, layer=layer, window=window,
                  **sc)
        got = flash_decode(q, k_, v_, pos, **kw)
        ns = flash_decode.last_pieces
        ref = flash_decode_plain(q, k_, v_, pos, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K3 flash_decode {ctype} window={window}: max|err| {err} "
                 "> 2e-3")
        same_bits(f"K3 flash_decode {ctype} window={window}", got,
                  lambda: flash_decode(q, k_, v_, pos, **kw))
        # cache slots attended besides the current token
        seen = min(ctx, window - 1) if window else ctx
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * b * KV_HEADS * seen * (HD * elt + (4 if sc else 0)) \
            + 2 * b * KV_HEADS * HD * 2 + 2 * b * HEADS * HD * 4 + b * 4
        ops = 4 * b * HEADS * (seen + 1) * HD
        lib_ms = None
        if not sc:
            # yardstick: SDPA over the cache with the current token
            # written at pos (the same attention), bf16, boolean mask
            kl, vl = kc[layer].clone(), vc[layer].clone()
            kl[:, :, ctx], vl[:, :, ctx] = kcur[:, :, 0], vcur[:, :, 0]
            qh = q.reshape(b, HEADS, 1, HD).to(torch.bfloat16)
            keep = span <= ctx
            if window:
                keep = keep & (span > ctx - window)
            mask = keep.expand(b, 1, 1, s)
            lib = sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)
            lib_err = (lib.float().reshape(got.shape) - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K3 yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=mask,
                                        enable_gqa=True))
        variant = ctype + (f" window={window}" if window else "")
        record("flash_decode", f"{variant} B={b} KV={KV_HEADS} rep={REP} "
               f"hd={HD} S={s} ctx={ctx} ns={ns}", err,
               "max|err| <= 2e-3, two calls bit-equal",
               timer(lambda: flash_decode(q, k_, v_, pos, **kw)),
               timer(lambda: flash_decode_plain(q, k_, v_, pos, **kw), reps=5),
               bound(nbytes, ops, "bf16"), lib_ms,
               main=(ctype, window) == ("bf16", 0))

    # K5: flash prefill of one 128-token chunk of one slot (the server's
    # one-slot view of its stacked cache, read in place) at the start of
    # a prompt and after 384 cached tokens: bf16, int8, window 256
    t5, slot = 128, 3
    q5 = randn(1, KV_HEADS, t5 * REP, HD)
    for ctype, p0, window in (("bf16", 0, 0), ("bf16", 384, 0),
                              ("int8", 0, 0), ("int8", 384, 0),
                              ("bf16", 384, 256)):
        k_, v_, sc = caches[ctype]
        view = slice(slot, slot + 1)
        k_, v_ = k_[:, view], v_[:, view]
        kw = dict(rep=REP, layer=layer, window=window,
                  **{n: x[:, view] for n, x in sc.items()})
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        got = flash_prefill(q5, k_, v_, pos0, **kw)
        ref = flash_prefill_plain(q5, k_, v_, pos0, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K5 flash_prefill {ctype} pos0={p0} window={window}: "
                 f"max|err| {err} > 2e-3")
        same_bits(f"K5 flash_prefill {ctype} pos0={p0} window={window}",
                  got, lambda: flash_prefill(q5, k_, v_, pos0, **kw))
        qpos = p0 + np.arange(t5)
        seen = np.minimum(qpos + 1, window) if window else qpos + 1
        lo = max(p0 - window + 1, 0) if window else 0
        seen_rows = p0 + t5 - lo  # cache rows any query row attends
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * q5.numel() * 4 + 4 \
            + 2 * KV_HEADS * seen_rows * (HD * elt + (4 if sc else 0))
        ops = 4 * HEADS * HD * int(seen.sum())
        lib_ms = None
        if not sc:
            # yardstick: SDPA over the bf16 cache, boolean causal (and
            # window) mask, grouped heads
            qh = (q5.reshape(1, KV_HEADS, t5, REP, HD).transpose(2, 3)
                  .reshape(1, HEADS, t5, HD).to(torch.bfloat16))
            kl, vl = k_[layer], v_[layer]
            qp = torch.as_tensor(qpos, device=dev)[:, None]
            keep = span[None, :] <= qp
            if window:
                keep = keep & (span[None, :] > qp - window)
            lib = sdpa(qh, kl, vl, attn_mask=keep, enable_gqa=True)
            lib = (lib.float().reshape(1, KV_HEADS, REP, t5, HD)
                   .transpose(2, 3).reshape(got.shape))
            lib_err = (lib - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K5 yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=keep,
                                        enable_gqa=True))
        variant = ctype + (f" window={window}" if window else "")
        record("flash_prefill", f"{variant} B=1 KV={KV_HEADS} rep={REP} "
               f"hd={HD} S={s} T={t5} pos0={p0}", err, "max|err| <= 2e-3",
               timer(lambda: flash_prefill(q5, k_, v_, pos0, **kw)),
               timer(lambda: flash_prefill_plain(q5, k_, v_, pos0, **kw),
                     reps=5),
               bound(nbytes, ops, "bf16"), lib_ms,
               main=(ctype, window) == ("bf16", 0))

    # K4: dequant GEMM at the prefill chunk M = 128
    m = 128
    m_weights["Mistral wqkv"] = m_wqkv
    # (also ragged rows and more than one row tile at Mistral's wgu, M =
    # 100 and 300)
    for name, w, m in [("wqkv", wqkv, 128),
                       *((n, w, 128) for n, w in weights.items()),
                       *((n, w, 128) for n, w in m_weights.items()),
                       ("Mistral wgu", m_weights["Mistral wgu"], 100),
                       ("Mistral wgu", m_weights["Mistral wgu"], 300)]:
        a = fold_q8_1(quantize_q8_1(randn(m, w.k)))
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        if not e <= 1e-4:
            fail(f"K4 gemm_dequant {name} M={m}: NMSE {e} > 1e-4")
        same_bits(f"K4 gemm_dequant {name} M={m}", got,
                  lambda: gemm_dequant(w, a))
        wb = layout.dequantize(w, torch.bfloat16)  # yardstick's own weight
        nbytes = q4_bytes(w.n, w.k) + m * w.k * 2 + m * w.n * 4
        record("gemm_dequant", f"{name} M={m} N={w.n} K={w.k}", err,
               f"NMSE {e:.3e} <= 1e-4", timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)),
               main=(name in weights or name == "wqkv") and m == 128)
    del m_weights, m_wqkv, wb

    # the Q4_K_M path's GEMMs: K1 (M = 8) and K4 (M = 128) on q4_K weights
    # in their effective form (f32 d' and m' planes), K7 (M = 8) on q6_K
    # at its three shapes and on q3_K / q2_K at the lm_head's
    def kquant(qtype, n, k):
        return kquants.random_blocks(qtype, n, k, k ** -0.5, g)

    q4k = {name: layout.prepare(kquants.to_effective(kquant("q4_K", n, k)))
           for name, (n, k) in Q4KM_Q4K_SHAPES.items()}
    for name, w in q4k.items():
        m = 8
        a = quantize_q8_1(randn(m, w.k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact q4_k {name}: max|err| {err} > {tol}")
        k1_bits(f"q4_k {name}", w, a, got)
        act = m * w.k + 2 * m * (w.k // 32) * 2 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        record("gemm_exact", f"q4_k {name} M={m} N={w.n} K={w.k}", err,
               f"max|err| <= {tol:.3e}, == k1_order bit for bit",
               timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(kq_bytes("q4_K", w.n, w.k) + act, ops, "int8"), None,
               main=False,
               layout_bnd=bound(q4k_layout_bytes(w.n, w.k) + act, ops,
                                "int8"))
    for name, w in q4k.items():
        m = 128
        a = fold_q8_1(quantize_q8_1(randn(m, w.k)))
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        tol = 1e-5 * ref.abs().max().item()
        if not (e <= 1e-4 and err <= tol):
            fail(f"K4 gemm_dequant q4_k {name}: NMSE {e} > 1e-4 or "
                 f"max|err| {err} > {tol}")
        same_bits(f"K4 gemm_dequant q4_k {name}", got,
                  lambda: gemm_dequant(w, a))
        wb = layout.dequantize(w, torch.bfloat16)
        act = m * w.k * 2 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        record("gemm_dequant", f"q4_k {name} M={m} N={w.n} K={w.k}", err,
               f"NMSE {e:.3e} <= 1e-4, max|err| <= {tol:.3e}",
               timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(kq_bytes("q4_K", w.n, w.k) + act, ops, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)), main=False,
               layout_bnd=bound(q4k_layout_bytes(w.n, w.k) + act, ops,
                                "bf16"))
    k16_cases = [("q6_K", name, n, k) for name, (n, k) in
                 Q4KM_Q6K_SHAPES.items()]
    k16_cases += [(q, "output", VOCAB, DIM) for q in ("q3_K", "q2_K")]
    for qtype, name, n, k in k16_cases:
        m = 8
        w = layout.prepare_k16(kquant(qtype, n, k))
        a = quantize_q8_1(randn(m, k))
        got, ref = gemm_exact_k16(w, a), gemm_exact_k16_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K7 gemm_exact_k16 {qtype} {name}: max|err| {err} > {tol}")
        if not torch.equal(got, k1_order(k16_block_terms(w, a))):
            fail(f"K7 gemm_exact_k16 {qtype} {name}: differs from k1_order "
                 "of its block terms (the summation order moved)")
        same_bits(f"K7 gemm_exact_k16 {qtype} {name}", got,
                  lambda: gemm_exact_k16(w, a))
        act = m * k + m * (k // 32) * 2 + m * n * 4  # codes, d_a, out
        record("gemm_exact_k16", f"{qtype} {name} M={m} N={n} K={k}", err,
               f"max|err| <= {tol:.3e}, == k1_order bit for bit, two calls "
               "bit-equal", timer(lambda: gemm_exact_k16(w, a)),
               timer(lambda: gemm_exact_k16_plain(w, a), reps=5),
               bound(kq_bytes(qtype, n, k) + act, 2 * m * n * k, "int8"),
               None, main=qtype == "q6_K",
               layout_bnd=bound(k16_layout_bytes(w) + act, 2 * m * n * k,
                                "int8"))
        # K7's yardstick: K1's q8_0 form (8.5 bits a weight against
        # compact q6_K's 8.5625) at the same N, K and codes
        w8 = layout.prepare(quantize_q8_0(randn(n, k, scale=k ** -0.5)))
        unfused("same N, K and codes", timer(lambda: gemm_exact(w8, a)),
                "k1_q8_0_ms")
        del w8
        if qtype == "q6_K":
            # the prefill route of the same weight (M = 128): dequantize
            # to float32 and multiply, plain torch, not a kernel of the
            # port (as the JAX package leaves it to XLA)
            m = 128
            x = randn(m, k)
            ms = timer(lambda: k16_dequant_gemm(w, x))
            b = bound(kq_bytes(qtype, n, k) + m * k * 4 + m * n * 4,
                      2 * m * n * k, "f32")
            rows.append({"kernel": "k16_dequant_gemm", "shape":
                         f"{qtype} {name} M={m} N={n} K={k}", "ms": ms,
                         "bound_ms": b[0], "bound_by": b[1], "main": False})
            print(f"  {'plain K16 prefill route':13s} {qtype} {name} M={m} "
                  f"N={n} K={k}: ms={ms:.5f} bound_ms={b[0]:.5f} ({b[1]})",
                  flush=True)

    # K6: K1 with the Q8_1 quantization of a float32 x inside, M = 8, on
    # the q4_0 decode shapes (run (a)) and the Q4_K_M q4_K ones (run (c));
    # bit-identical to quantize_q8_1 + K1, also where a block is all zero
    # (d = 0) or its amax / 127 saturates f16
    m = 8
    for label, w, main in ([(f"q4_0 {n}", w, True) for n, w in weights.items()]
                           + [(f"q4_k {n}", w, False) for n, w in q4k.items()]):
        x = randn(m, w.k)
        odd = x.clone()
        odd[0, :32], odd[-1, 32:64], odd[m // 2, 64:96] = 0.0, 7e8, -7e8
        for xx in (odd, x):  # max_abs_err and tol: the plain input's
            got = gemm_exact_fused(w, xx)
            want = gemm_exact(w, quantize_q8_1(xx))
            ref = gemm_exact_fused_plain(w, xx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K6 gemm_exact_fused {label}: differs from "
                     "quantize_q8_1 + K1")
            err = (got - ref).abs().max().item()
            tol = (1e-4 if w.m is None else 1e-5) * ref.abs().max().item()
            if not err <= tol:
                fail(f"K6 gemm_exact_fused {label}: max|err| {err} > {tol}")
        act = m * w.k * 4 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        wbytes = (q4_bytes(w.n, w.k) if w.m is None
                  else kq_bytes("q4_K", w.n, w.k))
        record("gemm_exact_fused", f"{label} M={m} N={w.n} K={w.k}", err,
               f"== quantize_q8_1 + K1, max|err| <= {tol:.3e}",
               timer(lambda: gemm_exact_fused(w, x)),
               timer(lambda: gemm_exact_fused_plain(w, x), reps=5),
               bound(wbytes + act, ops, "int8"), None, main=main,
               layout_bnd=None if w.m is None else bound(
                   q4k_layout_bytes(w.n, w.k) + act, ops, "int8"))
        unfused("quantize_q8_1 + K1",
                timer(lambda: gemm_exact(w, quantize_q8_1(x))))
        a = quantize_q8_1(x)
        unfused("the same codes", timer(lambda: gemm_exact(w, a)), "k1_ms")

    # K8: the layer tail wo .. w_down in one launch, M = 8 (the serving
    # batch, run (b)) and 1, against its plain chain on the layer update,
    # at TinyLlama-1.1B width and at Mistral-7B-v0.1's, beside the unfused
    # kernel chain and K6 on each of its three weights, summed; its wo and
    # w_down stages equal quantize_q8_1 + K1 bit for bit at both widths
    def zero_scales(w):
        return w._replace(d=torch.zeros_like(w.d))

    for label, dim, dff in (("TinyLlama", DIM, D_FF),
                            ("Mistral", M_DIM, M_D_FF)):
        if label == "TinyLlama":
            wo, wgu, wd = weights["wo"], weights["wgu"], weights["w_down"]
        else:
            wo, wgu, wd = (weight(dim, dim), weight(2 * dff, dim),
                           weight(dim, dff))
        nw = 1.0 + 0.1 * randn(dim)

        def tail_kernels(attn, x):
            """The same chain through the unfused kernels (K1 and eager
            quantize, RMSNorm, SiLU)."""
            xm = x + gemm_exact(wo, quantize_q8_1(attn))
            gu = gemm_exact(wgu, quantize_q8_1(rms_norm(xm, nw, 1e-5)))
            ff = silu_mul(gu[:, :dff], gu[:, dff:])
            return xm + gemm_exact(wd, quantize_q8_1(ff))

        for m in (8, 1):
            attn, x = randn(m, dim), randn(m, dim, scale=3.0)
            args = (attn, x, nw, wo, wgu, wd, 1e-5, dff)
            got, ref = attn_tail(*args), attn_tail_plain(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 2e-3 * (ref - x).abs().max().item()
            if not err <= tol:
                fail(f"K8 attn_tail {label} M={m}: max|err| {err} > {tol}")
            same_bits(f"K8 attn_tail {label} M={m}", got,
                      lambda: attn_tail(*args))
            nbytes = sum(q4_bytes(w.n, w.k) for w in (wo, wgu, wd)) \
                + 3 * m * dim * 4 + dim * 4
            ops = 2 * m * sum(w.n * w.k for w in (wo, wgu, wd))
            record("attn_tail", f"{label} M={m} dim={dim} d_ff={dff}", err,
                   f"max|err| <= {tol:.3e} (2e-3 x max|update|), two calls "
                   "bit-equal", timer(lambda: attn_tail(*args)),
                   timer(lambda: attn_tail_plain(*args), reps=5),
                   bound(nbytes, ops, "int8"), None,
                   main=label == "TinyLlama" and m == 8)
            unfused("3 x (quantize_q8_1 + K1), RMSNorm, SiLU",
                    timer(lambda: tail_kernels(attn, x)))
            ffx = randn(m, dff)
            unfused("wo, wgu, w_down", sum(
                timer(lambda: gemm_exact_fused(w, xx))
                for w, xx in ((wo, attn), (wgu, x), (wd, ffx))), "k6_ms")

        # with x = 0 and w_down's scales 0, out is the wo stage; with wo's
        # scales 0, rows of mostly +1 (an exact RMSNorm at eps 0) and
        # positive gate weights (gate outputs far above 17, where SiLU is
        # the identity in float32), out is x + the w_down stage
        m = 8
        attn = randn(m, dim)
        got = attn_tail(attn, torch.zeros(m, dim, device=dev), nw, wo, wgu,
                        zero_scales(wd), 1e-5, dff)
        if not torch.equal(got, gemm_exact(wo, quantize_q8_1(attn))):
            fail(f"K8 attn_tail {label}: its wo stage differs from "
                 "quantize_q8_1 + K1")
        gate = 0.5 + 0.5 * torch.rand(dff, dim, generator=g, device=dev)
        wgu_pos = layout.prepare(quantize_q4_0(torch.cat(
            [gate, randn(dff, dim, scale=dim ** -0.5)])))
        del gate
        x = torch.where(torch.rand(m, dim, generator=g, device=dev) < 0.1,
                        -1.0, 1.0)
        got = attn_tail(attn, x, nw.abs(), zero_scales(wo), wgu_pos, wd, 0.0,
                        dff)
        gu = gemm_exact(wgu_pos, quantize_q8_1(rms_norm(x, nw.abs(), 0.0)))
        want = x + gemm_exact(wd, quantize_q8_1(silu_mul(gu[:, :dff],
                                                         gu[:, dff:])))
        if not (gu[:, :dff].min() > 100.0 and torch.equal(got, want)):
            fail(f"K8 attn_tail {label}: its w_down stage differs from "
                 "quantize_q8_1 + K1")
        print(f"  {'attn_tail':13s} {label} wo and w_down stages at M={m}: "
              "equal to quantize_q8_1 + K1", flush=True)
        del wgu_pos
    del wo, wgu, wd
    mistral_kernel_rows(dev, timer, record, randn, g)
    slice6_kernel_rows(dev, timer, record, randn)
    slice7_kernel_rows(dev, timer, record, unfused, randn)
    slice14_kernel_rows(dev, timer, record, unfused, randn)
    slice15_kernel_rows(dev, timer, record, randn)
    act_quant_rows(timer, record, randn)
    return rows


def act_quant_rows(timer, record, randn):
    """The activation quantizers' launches (not TPU kernels) at the
    serving path's shapes, bit for bit against their torch twins: Q8_1 at
    a decode step's M = 8 over K 2048 (wo, wgu, lm_head) and 5632
    (w_down), the bf16 fold at a chunk's M = 128 over the same K (main),
    and both at Mistral's K 4096 and 14336.  Each input has an all-zero
    block per row.  Bound: bytes (x read, codes and f16 scales, or the
    fold, written); yardstick the twin's eager chain, no library call."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.kernels import act_quant

    for k, main in ((DIM, True), (D_FF, True), (M_DIM, False),
                    (M_D_FF, False)):
        for m, fn, plain in (
                (8, act_quant.quantize_q8_1, act_quant.quantize_q8_1_plain),
                (128, act_quant.quantize_fold_q8_1,
                 act_quant.quantize_fold_q8_1_plain)):
            x = randn(m, k, scale=3.0)
            x[:, :32] = 0.0
            got, want = fn(x), plain(x)
            same = (all(torch.equal(a, b) for a, b in zip(got, want))
                    if m == 8 else torch.equal(got, want))
            if not same:
                fail(f"{fn.__name__} M={m} K={k}: not bit-equal to the twin")
            out = m * k + 4 * m * (k // 32) if m == 8 else 2 * m * k
            record(fn.__name__, f"M={m} K={k}", 0.0, "bit-equal to the twin",
                   timer(lambda: fn(x)), timer(lambda: plain(x)),
                   bound(4 * m * k + out, 0, "f32"), None, main=main)


# the spec runner's full-width shapes (Mistral-7B-v0.1): K9 at a decode
# step's 8 rows, a 128-token chunk and a 4096-token prompt at hidden
# 4096; K10 at a decode step's logits over the vocab and at 32 heads x
# 128 query rows of a ring chunk's scores over R = 4608 slots; the GEMMs
# at wqkv and w_down
SPEC_RMSNORM = [(8, M_DIM), (128, M_DIM), (4096, M_DIM)]
SPEC_SOFTMAX = [(8, VOCAB), (M_HEADS * 128, M_RING)]
SPEC_GEMM = {"wqkv": (M_HEADS * M_HD + 2 * M_KV * M_HD, M_DIM),
             "w_down": (M_DIM, M_D_FF)}


# a ragged C <= 1024: a short row with no multiple of 32 elements
RAGGED_ROWS = (7, 1000)


def slice6_kernel_rows(dev, timer, record, randn):
    """K9 and K10 against their plain versions at the definitions' own R x
    C, at ``RAGGED_ROWS`` and at the spec runner's full-width shapes (the
    row plan, ``ops/rows.py::plan``, splits 8 x 32000 over clusters), bit
    for bit equal to the plain steps on the sum taken in the kernel's
    order (``rows.ordered_sum``), two calls bit-equal, beside ``torch.nn.
    functional.rms_norm`` and ``torch.softmax`` (yardsticks the port never
    calls); K1 (M = 8) and K4 (M = 128, bf16 and float32 activations) in
    the q4_0, q4_1, q5_0, q5_1 and q8_0 forms at Mistral's wqkv and
    w_down, K4 beside ``torch.matmul`` on the weight dequantized in
    advance (no PyTorch call applies K1's per-block integer scales)."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.formats import quant as tq
    from quant_gemm_tpu_torch.specs import spec_runner
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        gemm_dequant, gemm_dequant_plain)
    from quant_gemm_tpu_torch.kernels.gemm_exact import (gemm_exact,
                                                         gemm_exact_plain)
    from quant_gemm_tpu_torch.ops import rows
    from quant_gemm_tpu_torch.ops.rms_norm import (rms_norm_pallas,
                                                   rms_norm_pallas_plain,
                                                   rsqrt)
    from quant_gemm_tpu_torch.ops.softmax import (softmax_pallas,
                                                  softmax_pallas_plain)

    def rows_of(stem, full):
        """(R, C, on the main path) for K9 / K10: the definition's own
        shape, the ragged one, then the full-width ones."""
        path = next(p for p in spec_runner.definitions() if p.stem == stem)
        prm = spec_runner.load(path)["params"]
        return ([(prm["R"], prm["C"], True), (*RAGGED_ROWS, False)]
                + [(r, c, True) for r, c in full])

    eps = 1e-5
    for r, c, main in rows_of("rmsnorm", SPEC_RMSNORM):
        x, w = randn(r, c), 0.5 + randn(c).abs()
        got, ref = rms_norm_pallas(x, w, eps), rms_norm_pallas_plain(x, w, eps)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K9 rms_norm_pallas {r}x{c}: max|err| {err} > {tol}")
        same_bits(f"K9 rms_norm_pallas {r}x{c}", got,
                  lambda: rms_norm_pallas(x, w, eps))
        ms = tq.div(rows.ordered_sum(x * x, rows.plan(r, c))[:, None], c)
        if not torch.equal(got, x * rsqrt(ms + eps) * w):
            fail(f"K9 rms_norm_pallas {r}x{c}: differs from the plain steps "
                 "on its sum of squares in the kernel's order")
        lib = torch.nn.functional.rms_norm
        record("rms_norm_pallas", f"R={r} C={c}", err,
               f"max|err| <= {tol:.3e}, == ordered_sum steps, two calls "
               "bit-equal",
               timer(lambda: rms_norm_pallas(x, w, eps)),
               timer(lambda: rms_norm_pallas_plain(x, w, eps), reps=5),
               bound(8 * r * c + 4 * c, 3 * r * c, "f32"),
               timer(lambda: lib(x, (c,), w, eps)), main=main)
    for r, c, main in rows_of("softmax", SPEC_SOFTMAX):
        x = 4.0 * randn(r, c)
        got, ref = softmax_pallas(x), softmax_pallas_plain(x)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 1e-6:
            fail(f"K10 softmax_pallas {r}x{c}: max|err| {err} > 1e-6")
        same_bits(f"K10 softmax_pallas {r}x{c}", got,
                  lambda: softmax_pallas(x))
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        if not torch.equal(got, e / rows.ordered_sum(e, rows.plan(r, c))[
                :, None]):
            fail(f"K10 softmax_pallas {r}x{c}: differs from exp(x - max) "
                 "over its sum in the kernel's order")
        record("softmax_pallas", f"R={r} C={c}", err,
               "max|err| <= 1e-6, == ordered_sum steps, two calls "
               "bit-equal",
               timer(lambda: softmax_pallas(x)),
               timer(lambda: softmax_pallas_plain(x), reps=5),
               bound(8 * r * c, 5 * r * c, "f32"),
               timer(lambda: torch.softmax(x, -1)), main=main)
    for qtype in ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0"):
        for name, (n, k) in SPEC_GEMM.items():
            w = layout.prepare(tq.QUANTIZE[qtype](randn(n, k, scale=k ** -0.5)))
            wbytes = n * k // 32 * Q32_BLOCK_BYTES[qtype]
            m = 8
            a = tq.quantize_q8_1(randn(m, k))
            got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item()
            if not err <= tol:
                fail(f"K1 gemm_exact {qtype} {name}: max|err| {err} > {tol}")
            k1_bits(f"{qtype} {name}", w, a, got)
            act = m * k + 2 * m * (k // 32) * 2 + m * n * 4
            record("gemm_exact", f"{qtype} Mistral {name} M={m} N={n} K={k}",
                   err, f"max|err| <= {tol:.3e}, == k1_order bit for bit",
                   timer(lambda: gemm_exact(w, a)),
                   timer(lambda: gemm_exact_plain(w, a), reps=5),
                   bound(wbytes + act, 2 * m * n * k, "int8"), None,
                   main=False)
            m = 128
            x = randn(m, k)
            for adt, kind, peak in ((torch.bfloat16, "bf16", "bf16"),
                                    (torch.float32, "f32", "bf16x3")):
                a = x.to(adt)
                got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
                # yardstick: one matmul on the weight dequantized in
                # advance to A's type (TF32 off for float32)
                wd = layout.dequantize(w, adt)
                lib = torch.matmul(a, wd.T).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                e, e_lib = nmse(got, ref), nmse(lib, ref)
                if not e <= 1e-4:
                    fail(f"K4 gemm_dequant {qtype} {kind} {name}: NMSE {e} "
                         "> 1e-4")
                same_bits(f"K4 gemm_dequant {qtype} {kind} {name}", got,
                          lambda: gemm_dequant(w, a))
                if not e_lib <= 1e-3:
                    fail(f"K4 yardstick matmul {qtype} {kind} {name}: NMSE "
                         f"{e_lib} > 1e-3")
                act = m * k * a.element_size() + m * n * 4
                record("gemm_dequant", f"{qtype} {kind} A Mistral {name} "
                       f"M={m} N={n} K={k}", err, f"NMSE {e:.3e} <= 1e-4",
                       timer(lambda: gemm_dequant(w, a)),
                       timer(lambda: gemm_dequant_plain(w, a), reps=5),
                       bound(wbytes + act, 2 * m * n * k, peak),
                       timer(lambda: torch.matmul(a, wd.T)), main=False)
                del wd
            del w


def slice7_kernel_rows(dev, timer, record, unfused, randn):
    """K2 in the q4_1, q4_k, q5_0, q5_1 and q5_k forms at TinyLlama's and
    Mistral's wqkv (M = 8); K6 in q4_1 and q8_0 at TinyLlama's four
    decode GEMMs, bit for bit against quantize_q8_1 + K1; K1 (M = 8) and
    K4 (M = 128, bf16) on q5_k at TinyLlama's wqkv and w_down; K4
    ``fused_quant`` (bf16 and float32 operands, M = 128) in the spec
    definitions' five per-32 forms at the spec phase's full-width wqkv
    and w_down, beside ``torch.matmul`` on the weight dequantized and the
    activation fake-quantized in advance.  K-quant weights count their
    GGUF block bytes in bound_ms, the port's f32-plane layout beside."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats import quant as tq
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        fake_quant_q8, gemm_dequant, gemm_dequant_plain)
    from quant_gemm_tpu_torch.kernels.gemm_exact import (
        gemm_exact, gemm_exact_fused, gemm_exact_fused_plain,
        gemm_exact_plain)
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import (
        norm_qkv, norm_qkv_plain)
    from quant_gemm_tpu_torch.ops.rms_norm import rms_norm

    g = torch.Generator(device=dev).manual_seed(77)
    effective = {"q4_k": ("q4_K", kquants.to_effective),
                 "q5_k": ("q5_K", kquants.to_effective_q5_k)}

    def weight(qtype, n, k):
        """(weight, its format's bytes, the port layout's bytes or None)."""
        if qtype in effective:
            name, eff = effective[qtype]
            w = layout.prepare(eff(kquants.random_blocks(
                name, n, k, k ** -0.5, g)))
            lay = n * k // 2 + n * (k // 32) * 8 \
                + (n * k // 8 if w.qh is not None else 0)
            return w, n * k // 256 * KQ_BLOCK_BYTES[name], lay
        w = layout.prepare(tq.QUANTIZE[qtype](randn(n, k, scale=k ** -0.5)))
        return w, n * k // 32 * Q32_BLOCK_BYTES[qtype], None

    tiny = {"wqkv": (HEADS * HD + 2 * KV_HEADS * HD, DIM),
            "wo": (DIM, DIM), "wgu": (2 * D_FF, DIM),
            "w_down": (DIM, D_FF), "lm_head": (VOCAB, DIM)}
    m = 8
    for qtype in ("q4_1", "q4_k", "q5_0", "q5_1", "q5_k"):
        for label, (n, k) in (("wqkv", tiny["wqkv"]),
                              ("Mistral wqkv", SPEC_GEMM["wqkv"])):
            w, wbytes, lay = weight(qtype, n, k)
            x = randn(m, k, scale=3.0)
            nw = 1.0 + 0.1 * randn(k)
            got, ref = norm_qkv(w, x, nw, 1e-5), norm_qkv_plain(w, x, nw,
                                                                1e-5)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 2e-3 * ref.abs().max().item()
            if not err <= tol:
                fail(f"K2 norm_qkv {qtype} {label}: max|err| {err} > {tol}")
            act = m * k * 4 + k * 4 + m * n * 4
            ops = 2 * m * n * k
            k2_bits(f"{qtype} {label}", w, dev)
            record("norm_qkv", f"{qtype} {label} M={m} N={n} K={k}", err,
                   f"max|err| <= {tol:.3e}, == quantize_q8_1 + K1 on exact "
                   "rows",
                   timer(lambda: norm_qkv(w, x, nw, 1e-5)),
                   timer(lambda: norm_qkv_plain(w, x, nw, 1e-5), reps=5),
                   bound(wbytes + act, ops, "int8"), None, main=False,
                   layout_bnd=lay and bound(lay + act, ops, "int8"))
            unfused("rms_norm + quantize_q8_1 + K1", timer(
                lambda: gemm_exact(w, tq.quantize_q8_1(rms_norm(x, nw,
                                                                1e-5)))))

    # K6: q4_1 and q8_0 at the four decode GEMMs, bit-equal to
    # quantize_q8_1 + K1, also on zero and f16-saturating blocks
    for qtype in ("q4_1", "q8_0"):
        for label in ("wo", "wgu", "w_down", "lm_head"):
            n, k = tiny[label]
            w, wbytes, _ = weight(qtype, n, k)
            x = randn(m, k)
            odd = x.clone()
            odd[0, :32], odd[-1, 32:64], odd[m // 2, 64:96] = 0.0, 7e8, -7e8
            for xx in (odd, x):  # max_abs_err and tol: the plain input's
                got = gemm_exact_fused(w, xx)
                want = gemm_exact(w, tq.quantize_q8_1(xx))
                ref = gemm_exact_fused_plain(w, xx)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"K6 gemm_exact_fused {qtype} {label}: differs "
                         "from quantize_q8_1 + K1")
                err = (got - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item()
                if not err <= tol:
                    fail(f"K6 gemm_exact_fused {qtype} {label}: max|err| "
                         f"{err} > {tol}")
            record("gemm_exact_fused", f"{qtype} {label} M={m} N={n} K={k}",
                   err, f"== quantize_q8_1 + K1, max|err| <= {tol:.3e}",
                   timer(lambda: gemm_exact_fused(w, x)),
                   timer(lambda: gemm_exact_fused_plain(w, x), reps=5),
                   bound(wbytes + m * k * 4 + m * n * 4, 2 * m * n * k,
                         "int8"), None, main=False)
            unfused("quantize_q8_1 + K1",
                    timer(lambda: gemm_exact(w, tq.quantize_q8_1(x))))
            a = tq.quantize_q8_1(x)
            unfused("the same codes", timer(lambda: gemm_exact(w, a)),
                    "k1_ms")

    # K1 (M = 8) and K4 (M = 128, bf16) on q5_k
    for label in ("wqkv", "w_down"):
        n, k = tiny[label]
        w, wbytes, lay = weight("q5_k", n, k)
        a = tq.quantize_q8_1(randn(m, k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact q5_k {label}: max|err| {err} > {tol}")
        k1_bits(f"q5_k {label}", w, a, got)
        act = m * k + 2 * m * (k // 32) * 2 + m * n * 4
        ops = 2 * m * n * k
        record("gemm_exact", f"q5_k {label} M={m} N={n} K={k}", err,
               f"max|err| <= {tol:.3e}, == k1_order bit for bit",
               timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(wbytes + act, ops, "int8"), None, main=False,
               layout_bnd=bound(lay + act, ops, "int8"))
        mm = 128
        a = randn(mm, k).to(torch.bfloat16)
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        wb = layout.dequantize(w, torch.bfloat16)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        if not e <= 1e-4:
            fail(f"K4 gemm_dequant q5_k {label}: NMSE {e} > 1e-4")
        same_bits(f"K4 gemm_dequant q5_k {label}", got,
                  lambda: gemm_dequant(w, a))
        act = mm * k * 2 + mm * n * 4
        ops = 2 * mm * n * k
        record("gemm_dequant", f"q5_k {label} M={mm} N={n} K={k}", err,
               f"NMSE {e:.3e} <= 1e-4", timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(wbytes + act, ops, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)), main=False,
               layout_bnd=bound(lay + act, ops, "bf16"))
        del wb

    # K4 fused_quant at the spec phase's full-width shapes, M = 128
    mm = 128
    for qtype in ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0"):
        for label, (n, k) in SPEC_GEMM.items():
            w, wbytes, _ = weight(qtype, n, k)
            x = randn(mm, k)
            for adt, kind, peak in ((torch.bfloat16, "bf16", "bf16"),
                                    (torch.float32, "f32", "bf16x3")):
                got = gemm_dequant(w, x, fused_quant=True, a_dtype=adt)
                ref = gemm_dequant_plain(w, x, fused_quant=True, a_dtype=adt)
                # yardstick: one matmul on the weight dequantized and the
                # activation fake-quantized in advance, in the operand type
                wd, xq = layout.dequantize(w, adt), fake_quant_q8(x).to(adt)
                lib = torch.matmul(xq, wd.T).float()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                e, e_lib = nmse(got, ref), nmse(lib, ref)
                if not e <= FQ_NMSE:
                    fail(f"K4 fused_quant {qtype} {kind} {label}: NMSE {e} "
                         f"> {FQ_NMSE}")
                same_bits(f"K4 fused_quant {qtype} {kind} {label}", got,
                          lambda: gemm_dequant(w, x, fused_quant=True,
                                               a_dtype=adt))
                if not e_lib <= 1e-3:
                    fail(f"K4 fused_quant yardstick {qtype} {kind} {label}:"
                         f" NMSE {e_lib} > 1e-3")
                record("gemm_dequant", f"fused_quant {qtype} {kind} "
                       f"Mistral {label} M={mm} N={n} K={k}", err,
                       f"NMSE {e:.3e} <= {FQ_NMSE}",
                       timer(lambda: gemm_dequant(w, x, fused_quant=True,
                                                  a_dtype=adt)),
                       timer(lambda: gemm_dequant_plain(
                           w, x, fused_quant=True, a_dtype=adt), reps=5),
                       bound(wbytes + mm * k * 4 + mm * n * 4,
                             2 * mm * n * k, peak),
                       timer(lambda: torch.matmul(xq, wd.T)), main=False)
                del wd, xq
            del w

    # the prologue alone, bit for bit: through a q8_0 identity weight
    # (code 1, d = 1 on the diagonal) each output is one product a' * 1
    # plus zeros, so out == fake_quant_q8(x) in the operand type
    for k in sorted({k for _, k in SPEC_GEMM.values()}):
        eye = layout.PreparedWeight(
            "q8_0", k, k, torch.eye(k, dtype=torch.int8, device=dev),
            torch.ones(k, k // 32, dtype=torch.float16, device=dev))
        x = randn(mm, k, scale=4.0)
        x[0, :32], x[-1, 32:64], x[mm // 2, 64:96] = 0.0, 7e8, -7e8
        x[:, -32:] *= 1e-3
        for adt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            got = gemm_dequant(eye, x, fused_quant=True, a_dtype=adt)
            if not torch.equal(got, fake_quant_q8(x).to(adt).float()):
                fail(f"K4 fused_quant {kind} K={k}: the in-kernel fake "
                     "quantization differs from fake_quant_q8")
        del eye
        print(f"  K4 fused_quant prologue, q8_0 identity M={mm} K={k}: "
              "bf16 and f32 outputs == fake_quant_q8(x) bit for bit",
              flush=True)


def ring_keep(pos, n_slots, window):
    """[B, R] bool: the ring slots a decode query at ``pos`` attends with
    its current token written at slot ``pos % R``: ages (pos - slot) mod R
    below min(window, pos + 1)."""
    span = torch.arange(n_slots, device=pos.device)
    p = pos.long()[:, None]
    return torch.remainder(p - span, n_slots) < torch.clamp(p + 1,
                                                            max=window)


def ring_prefill_keep(pos0, t, n_slots, window):
    """[T, R] bool: the slots a chunk's query rows attend on the ring (by
    the global position g each slot holds)."""
    span = torch.arange(n_slots, device=pos0.device)[None, :]
    p_cache = int(pos0) + t - 1
    g = p_cache - torch.remainder(p_cache - span, n_slots)
    qpos = (int(pos0) + torch.arange(t, device=pos0.device))[:, None]
    return (g <= qpos) & (g >= 0) & (g > qpos - window)


def mistral_kernel_rows(dev, timer, record, randn, g):
    """K3 on the ring at Mistral-7B-v0.1's shapes (B = 8, positions past
    R) and K5 on it (a 128-token chunk at pos0 R - 64, across the ring's
    edge), bf16 and int8, each against its plain version, SDPA with the
    ring's boolean mask beside the bf16 rows."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.ops.attention import (
        decode_max_pieces, decode_s_hi, flash_decode, flash_decode_plain,
        flash_prefill, flash_prefill_plain)

    # the ring: R = 4608 slots of a 2-layer stacked cache, all written
    b, layer, ring = 8, 1, M_RING
    shape = (2, b, M_KV, ring, M_HD)
    kc = randn(*shape).to(torch.bfloat16)
    vc = randn(*shape).to(torch.bfloat16)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    s8 = dict(k_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev),
              v_scale=0.005 + 0.025 * torch.rand(
                  shape[:-1], generator=g, device=dev))
    caches = {"bf16": (kc, vc, {}), "int8": (k8, v8, s8)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(b, M_KV, M_REP, M_HD)
    kcur = randn(b, M_KV, 1, M_HD).to(torch.bfloat16)
    vcur = randn(b, M_KV, 1, M_HD).to(torch.bfloat16)
    # every slot past the ring's first lap, the first just past its edge
    pos = torch.tensor([4609, 4700, 5000, 6000, 8703, 9216, 12000, 32000],
                       dtype=torch.int32, device=dev)
    seen = min(M_WINDOW - 1, int(pos.min()))  # cached slots per query
    for ctype in ("bf16", "int8"):
        k_, v_, sc = caches[ctype]
        kw = dict(k_current=kcur, v_current=vcur, layer=layer,
                  window=M_WINDOW, ring=ring, **sc)
        got = flash_decode(q, k_, v_, pos, **kw)
        ns = flash_decode.last_pieces
        ref = flash_decode_plain(q, k_, v_, pos, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K3 flash_decode ring {ctype}: max|err| {err} > 2e-3")
        same_bits(f"K3 flash_decode ring {ctype}", got,
                  lambda: flash_decode(q, k_, v_, pos, **kw))
        # the wide split: s_hi as the Server passes it at these positions
        # and one tile a piece, against the call without s_hi
        s_hi = decode_s_hi(min(int(pos.max()), M_WINDOW))
        most = decode_max_pieces(M_WINDOW, ring, s_hi)
        wkw = dict(kw, s_hi=s_hi, pieces=most)
        wide = flash_decode(q, k_, v_, pos, **wkw)
        torch.cuda.synchronize()
        werr = (wide - got).abs().max().item()
        if not werr <= 2e-3:
            fail(f"K3 flash_decode ring {ctype} wide split (s_hi={s_hi}, "
                 f"ns={most}): max|delta| {werr} from ns={ns} > 2e-3")
        wide_ms = timer(lambda: flash_decode(q, k_, v_, pos, **wkw))
        print(f"  K3 ring {ctype} wide split: s_hi={s_hi} ns={most} "
              f"kernel_ms={wide_ms:.5f} max|delta| from ns={ns} "
              f"{werr:.3e} [<= 2e-3]", flush=True)
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * b * M_KV * seen * (M_HD * elt + (4 if sc else 0)) \
            + 2 * b * M_KV * M_HD * 2 + 2 * b * M_HEADS * M_HD * 4 + b * 4
        ops = 4 * b * M_HEADS * (seen + 1) * M_HD
        lib_ms = None
        if not sc:
            # yardstick: SDPA over the ring with the current token written
            # at its slot pos % R (the slot end() writes), bf16, the ring's
            # boolean mask by age
            kl, vl = kc[layer].clone(), vc[layer].clone()
            slot = pos.long() % ring
            bi = torch.arange(b, device=dev)
            kl[bi, :, slot], vl[bi, :, slot] = kcur[:, :, 0], vcur[:, :, 0]
            qh = q.reshape(b, M_HEADS, 1, M_HD).to(torch.bfloat16)
            mask = ring_keep(pos, ring, M_WINDOW)[:, None, None, :]
            lib = sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)
            lib_err = (lib.float().reshape(got.shape) - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K3 ring yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=mask,
                                        enable_gqa=True))
        record("flash_decode", f"Mistral ring {ctype} window={M_WINDOW} "
               f"B={b} KV={M_KV} rep={M_REP} hd={M_HD} R={ring} "
               f"pos={int(pos.min())}..{int(pos.max())} ns={ns}", err,
               "max|err| <= 2e-3, two calls bit-equal",
               timer(lambda: flash_decode(q, k_, v_, pos, **kw)),
               timer(lambda: flash_decode_plain(q, k_, v_, pos, **kw), reps=5),
               bound(nbytes, ops, "bf16"), lib_ms, main=False)

    # K5: one 128-token chunk of one slot at pos0 R - 64, across the edge
    t5, slot, p0 = 128, 3, ring - 64
    q5 = randn(1, M_KV, t5 * M_REP, M_HD)
    pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
    qpos = p0 + np.arange(t5)
    seen5 = np.minimum(qpos + 1, M_WINDOW)
    rows5 = p0 + t5 - max(p0 - M_WINDOW + 1, 0)  # slots any row attends
    for ctype in ("bf16", "int8"):
        k_, v_, sc = caches[ctype]
        view = slice(slot, slot + 1)
        k_, v_ = k_[:, view], v_[:, view]
        kw = dict(rep=M_REP, layer=layer, window=M_WINDOW, ring=ring,
                  **{n: x[:, view] for n, x in sc.items()})
        got = flash_prefill(q5, k_, v_, pos0, **kw)
        ref = flash_prefill_plain(q5, k_, v_, pos0, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K5 flash_prefill ring {ctype}: max|err| {err} > 2e-3")
        same_bits(f"K5 flash_prefill ring {ctype}", got,
                  lambda: flash_prefill(q5, k_, v_, pos0, **kw))
        elt = 1 if ctype == "int8" else 2
        nbytes = 2 * q5.numel() * 4 + 4 \
            + 2 * M_KV * rows5 * (M_HD * elt + (4 if sc else 0))
        ops = 4 * M_HEADS * M_HD * int(seen5.sum())
        lib_ms = None
        if not sc:
            qh = (q5.reshape(1, M_KV, t5, M_REP, M_HD).transpose(2, 3)
                  .reshape(1, M_HEADS, t5, M_HD).to(torch.bfloat16))
            kl, vl = k_[layer], v_[layer]
            keep = ring_prefill_keep(pos0, t5, ring, M_WINDOW)
            lib = sdpa(qh, kl, vl, attn_mask=keep, enable_gqa=True)
            lib = (lib.float().reshape(1, M_KV, M_REP, t5, M_HD)
                   .transpose(2, 3).reshape(got.shape))
            lib_err = (lib - ref).abs().max().item()
            if not lib_err <= 2e-2:
                fail(f"K5 ring yardstick SDPA disagrees: {lib_err}")
            lib_ms = timer(lambda: sdpa(qh, kl, vl, attn_mask=keep,
                                        enable_gqa=True))
        record("flash_prefill", f"Mistral ring {ctype} window={M_WINDOW} "
               f"B=1 KV={M_KV} rep={M_REP} hd={M_HD} R={ring} T={t5} "
               f"pos0={p0}", err, "max|err| <= 2e-3",
               timer(lambda: flash_prefill(q5, k_, v_, pos0, **kw)),
               timer(lambda: flash_prefill_plain(q5, k_, v_, pos0, **kw),
                     reps=5),
               bound(nbytes, ops, "bf16"), lib_ms, main=False)


def traffic(rng):
    """16 prompts of 64-512 tokens; requests 4-11 open with one shared
    256-token system prompt, so that the second wave (8-15, admitted when
    the first eight finish together) finds it in four freed slots.
    Returns the prompts and each one's expected reused prefix length."""
    shared = rng.integers(0, VOCAB, 256).tolist()
    prompts, reuse = [], []
    for i in range(16):
        if 4 <= i < 12:
            n = int(rng.integers(272, 513))
            prompts.append(shared + rng.integers(0, VOCAB, n - 256).tolist())
        else:
            prompts.append(rng.integers(0, VOCAB,
                                        int(rng.integers(64, 513))).tolist())
        reuse.append(256 if 8 <= i < 12 else 0)
    return prompts, reuse


def chunks(prompts, reuse, chunk=128, bucket=16):
    """The bucket-padded length of every prefill chunk the server runs
    (chunks of 64 or more tokens take K5)."""
    out = []
    for p, r in zip(prompts, reuse):
        for off in range(r, len(p), chunk):
            out.append(max(bucket,
                           -(-min(chunk, len(p) - off) // bucket) * bucket))
    return out


def heads(prompts, reuse):
    """The prefill chunks that run the head: a prompt's last, one per
    prompt with tokens left past its reused prefix (the others run
    none)."""
    return sum(len(p) > r for p, r in zip(prompts, reuse))


def check_heads(name, st, prompts, reuse, chunk, bucket):
    """The Server's head counters hold to the traffic: ``heads`` chunks
    ran the head on one row each, every other chunk ran none."""
    n, h = len(chunks(prompts, reuse, chunk, bucket)), heads(prompts, reuse)
    got = st["prefill_chunks_headless"], st["prefill_head_rows"]
    if got != (n - h, h):
        fail(f"{name}: {got[0]} chunks without the head and {got[1]} head "
             f"rows, expected {n - h} and {h}")


def drive(srv, prompts, max_new, counters):
    """Submit ``prompts`` to ``srv``, set every counter to 0 just before
    the run and read it just after: returns ({request id: generated
    tokens}, the launches the card ran, wall seconds).  A replayed graph
    moves no counter: the launches add ``srv.replay_launches()`` (each
    graph's launches per replay, as its capture counted them, times its
    replays, less the capture's own count)."""
    for p in prompts:
        srv.submit(p, max_new=max_new)
    zero(counters)
    t0 = time.perf_counter()
    results = srv.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return results, served_launches(srv, counters), wall


def zero(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def served_launches(srv, counters):
    """The launches the card ran since the counters were set to 0: their
    moves plus ``srv.replay_launches()``."""
    extra = srv.replay_launches()
    if set(extra) - set(counters):
        fail(f"graph launches of uncounted kernels: {extra}")
    return {k: getattr(fn, attr) + extra.get(k, 0)
            for k, (fn, attr) in counters.items()}


@contextlib.contextmanager
def graphs(on: bool):
    """``serve.CUDA_GRAPHS`` set for the block, restored after it."""
    from quant_gemm_tpu_torch.models import serve

    old = serve.CUDA_GRAPHS
    serve.CUDA_GRAPHS = on
    try:
        yield
    finally:
        serve.CUDA_GRAPHS = old


def captured_pair(name, eager, captured, chunk_window=False):
    """Hold a captured run (``serve.CUDA_GRAPHS`` on) to the eager run of
    the same Server and traffic, both ``(server, results, launches,
    wall)``: transcripts and launches equal; prints the graphs (launches
    per replay by counter, replays, seconds of each key's eager first call
    and capture), both runs' median decode step and prefill tok/s, and
    the profiler's view of one replay of the most-replayed decode graph
    (and with ``chunk_window`` of the chunk graph of 128 tokens)."""
    from quant_gemm_tpu_torch.harness.profiling import device_breakdown

    (se, re_, le, we), (sc, rc, lc, wc) = eager, captured
    if rc != re_:
        diff = [r for r in re_ if rc.get(r) != re_[r]]
        fail(f"{name}: captured transcripts differ from eager ones "
             f"(requests {diff})")
    if lc != le:
        fail(f"{name}: captured launches {lc} differ from eager {le}")
    if not sc.graphs:
        fail(f"{name}: the captured run replayed no graph")
    st_e, st_c = se.stats(), sc.stats()
    print(f"    captured vs eager (same call): all {len(rc)} transcripts "
          f"equal, launches equal; {st_c['graphs']} graphs captured in "
          f"{st_c['capture_seconds']:.3f} s (first eager call + capture "
          f"each), {st_c['graph_replays']} replays; wall {wc:.2f} vs "
          f"{we:.2f} s", flush=True)
    for key, g in sorted(sc.graphs.items(), key=lambda kv: str(kv[0])):
        print(f"      {key[0]} {key[1]}: {sum(g.launches.values())} counted "
              f"launches per replay {json.dumps(g.launches)}, {g.replays} "
              f"replays, {g.capture_s:.3f} s", flush=True)
    pre = [st["prefill_tokens"] / st["prefill_seconds"]
           for st in (st_c, st_e)]
    mean = [1e3 * st["decode_seconds"] / st["decode_steps"]
            for st in (st_c, st_e)]
    print(f"    mean decode step captured {mean[0]:.3f} ms vs eager "
          f"{mean[1]:.3f} ms; prefill "
          f"captured {pre[0]:.1f} vs eager {pre[1]:.1f} tok/s (captured "
          "includes each key's first call and capture)", flush=True)
    dec = max((kg for kg in sc.graphs.items() if kg[0][0] == "decode"),
              key=lambda kg: kg[1].replays)
    device_breakdown(f"{name} captured decode replay (s_hi {dec[0][1]})",
                     dec[1].graph.replay, graph=True)
    # the chunk graph of 128 tokens with the head on its read row, else
    # the one with none (a prompt's middle chunk)
    chunk = sc.graphs.get(("chunk", 128) + dec[0][2:-1] + (1,)) \
        or sc.graphs.get(("chunk", 128) + dec[0][2:-1] + (0,))
    if chunk_window and chunk is not None:
        device_breakdown(f"{name} captured chunk replay (128 tokens)",
                         chunk.graph.replay, graph=True)


def serve_traffic(name, qp, cfg, dev, prompts, reuse, counters,
                  chunk_window=False, vocab=VOCAB, **kw):
    """A warm-up request, then the requests (16, or the first 8) through
    ``Server(qp, cfg, n_slots=8, **kw)`` eagerly, then again through a
    new Server replaying CUDA graphs (``captured_pair``).  Checks what
    every run must show; returns the eager run's (launches, stats,
    {request id: generated tokens}), which the captured run equals."""
    from quant_gemm_tpu_torch.models import serve

    with graphs(False):
        warm = serve.Server(qp, cfg, n_slots=8, device=dev, **kw)
        warm.submit(list(range(1, 65)), max_new=2)  # first-use costs
        warm.run_until_done()
        del warm
        srv = serve.Server(qp, cfg, n_slots=8, device=dev, **kw)
        results, launches, wall = drive(srv, prompts, 32, counters)
    st = srv.stats()
    if sorted(results) != list(range(len(prompts))):
        fail(f"{name}: not every request finished: {sorted(results)}")
    if any(len(t) != 32 for t in results.values()):
        fail(f"{name}: a request stopped short of max_new=32")
    if not all(0 <= t < vocab for ts in results.values() for t in ts):
        fail(f"{name}: a generated token is outside the vocabulary")
    if st["cached_prompt_tokens"] != sum(reuse):
        fail(f"{name}: reused {st['cached_prompt_tokens']} cached "
             f"prompt tokens, expected {sum(reuse)}")
    check_heads(name, st, prompts, reuse, srv.max_chunk, srv.bucket)
    print(f"  {name}: {len(prompts)} requests, {st['prefill_tokens']} "
          f"prompt tokens "
          f"prefilled and {st['cached_prompt_tokens']} reused from the "
          f"cache, {st['generated_tokens']} generated, "
          f"{st['decode_steps']} decode steps in {wall:.2f} s (eager)",
          flush=True)
    pre = st["prefill_tokens"] / st["prefill_seconds"]
    dec = st["decode_tokens"] / st["decode_seconds"]
    print(f"    eager: prefill {pre:.1f} tok/s, decode {dec:.1f} tok/s, "
          f"mean decode step "
          f"{1e3 * st['decode_seconds'] / st['decode_steps']:.3f} ms",
          flush=True)
    print(f"    launches: {json.dumps(launches)}", flush=True)
    with graphs(True):
        cap = serve.Server(qp, cfg, n_slots=8, device=dev, **kw)
        captured = (cap, *drive(cap, prompts, 32, counters))
        captured_pair(name, (srv, results, launches, wall), captured,
                      chunk_window)
    return launches, st, results


@contextlib.contextmanager
def twin_quantize():
    """The activation quantizers routed through their torch twins for
    the block, restored after it: the eager chain of about 27 ops that
    each GEMM ran before the hand launch, for the "before" profiler
    windows.  The counters keep the wrappers."""
    from quant_gemm_tpu_torch.kernels import act_quant

    old = act_quant.quantize_q8_1, act_quant.quantize_fold_q8_1
    act_quant.quantize_q8_1 = act_quant.quantize_q8_1_plain
    act_quant.quantize_fold_q8_1 = act_quant.quantize_fold_q8_1_plain
    try:
        yield
    finally:
        act_quant.quantize_q8_1, act_quant.quantize_fold_q8_1 = old


@contextlib.contextmanager
def switches(fused: bool, tail: bool = False):
    """``registry.FUSED_DECODE`` and ``gemm_megalayer.ENABLE_TAIL`` set
    for the block, restored after it."""
    from quant_gemm_tpu_torch.kernels import gemm_megalayer, registry

    old = registry.FUSED_DECODE, gemm_megalayer.ENABLE_TAIL
    registry.FUSED_DECODE, gemm_megalayer.ENABLE_TAIL = fused, tail
    try:
        yield
    finally:
        registry.FUSED_DECODE, gemm_megalayer.ENABLE_TAIL = old


RUN_A = "q4_0 FUSED_DECODE"
RUN_B = "q4_0 FUSED_DECODE+ENABLE_TAIL"
RUN_C = "Q4_K_M FUSED_DECODE"


def check_launches(name, launches, want):
    """Every kernel of the path launched, each exactly as often as the
    path says.  A serving run's rules (those with K1, K7 and K4 counts)
    add the activation quantize: one ``quantize_q8_1`` launch per decode
    GEMM that K2, K6 or K8 do not serve (each K1 and K7 call) and one
    ``quantize_fold_q8_1`` per K4 call, unless they name their own."""
    want = dict(want)
    if "gemm_exact_k16" in want:
        want.setdefault("quantize_q8_1",
                        want["gemm_exact"] + want["gemm_exact_k16"])
        want.setdefault("quantize_fold_q8_1", want["gemm_dequant"])
    never = [k for k, v in want.items() if v and not launches[k]]
    if never:
        fail(f"{name}: kernels of the path never launched: {never}")
    if any(launches[k] != v for k, v in want.items()):
        fail(f"{name}: launches {launches} differ from the path's {want}")


def layerwise(qp, cfg, tokens, cache, act_mode="q8_1"):
    """Kernels and plain versions from the same hidden state at every
    layer (the kernels'): the largest NMSE of a layer's update (output -
    input) and the NMSE of the logits of the last state.  A last-bit
    difference that moves a Q8_1 code across a .5 rounding tie then shows
    in its own layer only, not compounded over all."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama

    cache_p = cache.clone()
    x, step = llama.begin(qp, cfg, tokens, cache, act_mode=act_mode)
    worst = 0.0
    for li, lyr in enumerate(qp["layers"]):
        xk, _ = llama.layer(lyr, li, cfg, x, cache, step)
        xp, _ = llama.layer(lyr, li, cfg, x, cache_p, step, registry.PLAIN)
        worst = max(worst, nmse(xk - x, xp - x))
        x = xk
    lk = llama.head(qp, cfg, x, act_mode=act_mode)
    if not bool(torch.isfinite(lk).all()):
        fail("non-finite logits through the kernels")
    return worst, nmse(lk, llama.head(qp, cfg, x, registry.PLAIN, act_mode))


def check(qp, cfg, tokens, cache, act_mode="q8_1"):
    """layerwise() and the free run of both op sets end to end."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama

    free = nmse(llama.forward(qp, cfg, tokens, cache.clone(),
                              act_mode=act_mode)[0],
                llama.forward(qp, cfg, tokens, cache.clone(),
                              act_mode=act_mode, ops=registry.PLAIN)[0])
    return (*layerwise(qp, cfg, tokens, cache.clone(), act_mode), free)


def report_cases(cases):
    for name, (layer_e, logit_e, free) in cases:
        print(f"  {name}, kernels vs plain versions: worst layer update "
              f"NMSE {layer_e:.3e}, logits NMSE {logit_e:.3e} (limits "
              f"1e-4); run free end to end: logits NMSE {free:.3e} "
              "(limit 1e-2)", flush=True)
        if not (layer_e <= 1e-4 and logit_e <= 1e-4):
            fail(f"{name}: the kernels disagree with the plain versions")
        # Q8_1 tie flips compounding over 22 layers give NMSE near 6e-4
        # at this width (PERF.md); a wrong kernel gives order 1
        if not free <= 1e-2:
            fail(f"{name}: the free run through the kernels diverges")


def decode_case(qp, cfg, rng, dev, qtype="bf16", act_mode="q8_1"):
    """One 8-slot decode step at ragged positions after a 48-token
    prefill."""
    from quant_gemm_tpu_torch.models import llama

    cache = llama.KVCache.init(cfg, 8, qtype, device=dev)
    llama.forward(qp, cfg, torch.as_tensor(
        rng.integers(0, cfg.vocab, (8, 48)), device=dev), cache,
        act_mode=act_mode)
    cache.pos = torch.tensor([48, 40, 33, 47, 20, 48, 1, 16],
                             dtype=torch.int32, device=dev)
    nt = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 1)), device=dev)
    return check(qp, cfg, nt, cache, act_mode)


def decode_breakdown(name, qp, cfg, dev, rng):
    """Device breakdown of one 8-slot decode step after a 48-token
    prefill."""
    from quant_gemm_tpu_torch.harness.profiling import device_breakdown
    from quant_gemm_tpu_torch.models import llama
    from quant_gemm_tpu_torch.ops.attention import decode_s_hi

    cache = llama.KVCache.init(cfg, 8, device=dev)
    llama.forward(qp, cfg, torch.as_tensor(
        rng.integers(0, VOCAB, (8, 48)), device=dev), cache)
    nt = torch.as_tensor(rng.integers(0, VOCAB, (8, 1)), device=dev)
    # with the bound the Server passes at 48 cached tokens (K3 one piece)
    device_breakdown(f"{name} decode step, 8 slots at 49 cached tokens",
                     lambda: llama.forward(qp, cfg, nt, cache,
                                           s_hi=decode_s_hi(48)))


def breakdowns(name, qp, cfg, dev, rng, decode=True):
    """Device breakdown of one 8-slot decode step and one 128-token
    prefill chunk of one slot (eager)."""
    from quant_gemm_tpu_torch.harness.profiling import device_breakdown
    from quant_gemm_tpu_torch.models import llama

    if decode:
        decode_breakdown(name, qp, cfg, dev, rng)
    c1 = llama.KVCache.init(cfg, 1, device=dev)
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
    device_breakdown(f"{name} prefill chunk of 128 tokens at pos0 128",
                     lambda: llama.forward(qp, cfg, toks, c1))


def tinyllama_cfg():
    from quant_gemm_tpu_torch.models import llama

    return llama.LlamaConfig(vocab=VOCAB, dim=DIM, n_layers=LAYERS,
                             n_heads=HEADS, n_kv_heads=KV_HEADS, d_ff=D_FF,
                             max_seq=2048, rope_base=10000.0, eps=1e-5)


def main_path(dev, counters, prompts, reuse):
    """The q4_0 server with both caches, then with the decode fusions;
    returns each run's launches."""
    from quant_gemm_tpu_torch.models import llama

    cfg = tinyllama_cfg()
    t0 = time.perf_counter()
    qp = llama.init_qparams(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"main path: TinyLlama-1.1B width, {LAYERS} layers, random q4_0 "
          f"weights built on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)

    n_chunks, n_heads = chunks(prompts, reuse), heads(prompts, reuse)
    prefill = {"gemm_dequant": len(n_chunks) * 4 * LAYERS + n_heads,
               "flash_prefill": LAYERS * sum(t >= 64 for t in n_chunks),
               "gemm_exact_k16": 0}
    by_run = {}
    for qtype in ("bf16", "q8"):
        # the JAX defaults: bucket 16, chunk 128, cache_prompt=True
        kw = {} if qtype == "bf16" else {"cache_qtype": "q8"}
        name = f"Server(qp, cfg, n_slots=8{', cache_qtype=q8' if kw else ''})"
        launches, st, results = serve_traffic(name, qp, cfg, dev, prompts,
                                              reuse, counters,
                                              chunk_window=not kw, **kw)
        # every decode step runs K2 and K3 once per layer and K1 for wo,
        # wgu, w_down and lm_head; prefill (M >= 16) never reaches K1, and
        # every chunk of 64 tokens or more runs K5 once per layer
        steps = st["decode_steps"]
        check_launches(name, launches, {
            "gemm_exact": steps * (3 * LAYERS + 1),
            "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS,
            "gemm_exact_fused": 0, "attn_tail": 0, **prefill})
        by_run[f"q4_0 {qtype}"] = launches
        if qtype == "bf16":
            default = results

    rng = np.random.default_rng(1)
    cases = []
    for qtype in ("bf16", "q8"):
        # two 128-token chunks of one slot (K5 at pos0 0 and 128), then
        # one 8-slot decode step at ragged positions
        toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 256)), device=dev)
        cache = llama.KVCache.init(cfg, 1, qtype, device=dev)
        cases.append((f"{qtype} chunk 128 at pos0 0",
                      check(qp, cfg, toks[:, :128], cache)))
        llama.forward(qp, cfg, toks[:, :128], cache)
        cases.append((f"{qtype} chunk 128 at pos0 128",
                      check(qp, cfg, toks[:, 128:], cache)))
        cases.append((f"{qtype} decode step",
                      decode_case(qp, cfg, rng, dev, qtype)))
    report_cases(cases)

    # the decode fusions, bf16 cache.  (a) FUSED_DECODE: K6 takes every
    # decode GEMM K1 took (wo, wgu, w_down per layer and the lm_head) and
    # is bit-identical to it, so the transcripts are the default run's
    with switches(fused=True):
        launches, st, results = serve_traffic(
            f"{RUN_A}: Server(qp, cfg, n_slots=8)", qp, cfg, dev, prompts,
            reuse, counters)
        steps = st["decode_steps"]
        check_launches(RUN_A, launches, {
            "gemm_exact_fused": steps * (3 * LAYERS + 1), "gemm_exact": 0,
            "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS,
            "attn_tail": 0, **prefill})
        by_run[RUN_A] = launches
        if results != default:
            fail(f"{RUN_A}: the transcripts differ from the default run's")
        print(f"    per decode step: K6 {3 * LAYERS + 1}, K2 {LAYERS}, K3 "
              f"{LAYERS}, K1 0; all 16 transcripts equal the default "
              "run's", flush=True)
    # (b) and ENABLE_TAIL: K8 per layer, K6 for the lm_head; K8's RMSNorm
    # and SiLU round in its own float32 order, so a transcript may leave
    # the default's at a near-tie
    with switches(fused=True, tail=True):
        launches, st, results = serve_traffic(
            f"{RUN_B}: Server(qp, cfg, n_slots=8)", qp, cfg, dev, prompts,
            reuse, counters)
        steps = st["decode_steps"]
        check_launches(RUN_B, launches, {
            "attn_tail": steps * LAYERS, "gemm_exact_fused": steps,
            "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS,
            "gemm_exact": 0, **prefill})
        by_run[RUN_B] = launches
        first = {rid: next((i for i, (a, b) in enumerate(
            zip(results[rid], default[rid])) if a != b), None)
            for rid in sorted(default)}
        same = sum(f is None for f in first.values())
        print(f"    per decode step: K8 {LAYERS}, K6 1, K2 {LAYERS}, K3 "
              f"{LAYERS}, K1 0; {same} of 16 transcripts equal the default "
              f"run's; first differing step by request: "
              f"{json.dumps({r: f for r, f in first.items() if f is not None})}",
              flush=True)
        report_cases([(f"{RUN_B} decode step",
                       decode_case(qp, cfg, rng, dev))])

    # the device's view of one 8-slot decode step and one chunk, eager:
    # first with the quantize as it ran before its hand launch (the torch
    # twin's chain), then as it runs now, unfused and fused
    with twin_quantize():
        breakdowns("q4_0 (twin quantize chain, as before)", qp, cfg, dev,
                   np.random.default_rng(3))
    breakdowns("q4_0", qp, cfg, dev, np.random.default_rng(3), decode=False)
    for name, sw in (("q4_0", {"fused": False}), (RUN_A, {"fused": True}),
                     (RUN_B, {"fused": True, "tail": True})):
        with switches(**sw):
            decode_breakdown(name, qp, cfg, dev, np.random.default_rng(3))
    return by_run


def random_blocks32(qtype, n, k, std, g):
    """A per-32 container (q4_0, q4_1, q5_0, q5_1, q8_0) of random valid
    blocks
    drawn on ``g``'s device, values of mean about 0 and standard deviation
    about ``std``: uniform codes, f16 scales +-25% around the target, and
    (q4_1, q5_1) mins that centre the codes; the per-32 counterpart of
    ``kquants.random_blocks``."""
    from quant_gemm_tpu_torch.formats import blocks, quant

    dev = g.device
    nb = k // 32
    top, sd = {"q4_0": (16, 4.61), "q4_1": (16, 4.61), "q5_0": (32, 9.23),
               "q5_1": (32, 9.23), "q8_0": (255, 73.6)}[qtype]
    u = torch.rand(n, nb, generator=g, device=dev)
    d = (std / sd * (0.75 + 0.5 * u)).to(torch.float16)
    codes = torch.randint(0, top, (n, k), generator=g, device=dev)
    if qtype == "q8_0":
        return blocks.Q8_0Tensor((codes - 127).to(torch.int8), d)
    packed = quant.pack_planar_4bit(codes & 0xF)
    if qtype == "q4_0":  # x = (q - 8) d
        return blocks.Q4_0Tensor(packed, d)
    mid = (top - 1) / 2  # the min that centres the codes
    m = (-mid * d.to(torch.float32)).to(torch.float16)
    if qtype == "q4_1":
        return blocks.Q4_1Tensor(packed, d, m)
    qh = quant.pack_planar_bits(codes >> 4)
    if qtype == "q5_0":
        return blocks.Q5_0Tensor(packed, qh, d)
    return blocks.Q5_1Tensor(packed, qh, d, m)


def write_gguf_mix(path, mix, dev, seed=0, extra_md=None):
    """A GGUF file of llama.cpp's ``mix`` (``FILE_MIXES``) at
    TinyLlama-1.1B width: random valid blocks drawn on the card from a
    ``torch.Generator`` seed, each weight at about the scale 1/sqrt(K)
    (the embedding 0.02), f32 norms of 1, TinyLlama's metadata and
    ``extra_md`` (a tokenizer)."""
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats.gguf_file import write_gguf

    types = FILE_MIXES[mix]
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(qtype, n, k, std=None):
        draw = (random_blocks32 if qtype in Q32_BLOCK_BYTES
                else kquants.random_blocks)
        return draw(qtype, n, k, std or k ** -0.5, g)

    ones = torch.ones(DIM, device=dev)
    tensors = {"token_embd.weight": lin(types["default"], VOCAB, DIM, 0.02),
               "output_norm.weight": ones}
    for i in range(LAYERS):
        base = types["default"]
        big = types.get("more_bits", base) if i in MORE_BITS else base
        blk = f"blk.{i}."
        tensors.update({
            blk + "attn_norm.weight": ones,
            blk + "attn_q.weight": lin(base, HEADS * HD, DIM),
            blk + "attn_k.weight": lin(base, KV_HEADS * HD, DIM),
            blk + "attn_v.weight": lin(big, KV_HEADS * HD, DIM),
            blk + "attn_output.weight": lin(base, DIM, HEADS * HD),
            blk + "ffn_norm.weight": ones,
            blk + "ffn_gate.weight": lin(base, D_FF, DIM),
            blk + "ffn_up.weight": lin(base, D_FF, DIM),
            blk + "ffn_down.weight": lin(big, DIM, D_FF),
        })
    tensors["output.weight"] = lin(types["output"], VOCAB, DIM)
    metadata = {
        "general.architecture": "llama",
        "general.name": f"TinyLlama-1.1B width, {mix} mix, random blocks",
        "general.file_type": types["file_type"],
        "llama.vocab_size": VOCAB, "llama.embedding_length": DIM,
        "llama.block_count": LAYERS, "llama.feed_forward_length": D_FF,
        "llama.attention.head_count": HEADS,
        "llama.attention.head_count_kv": KV_HEADS,
        "llama.context_length": 2048, "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        **(extra_md or {}),
    }
    write_gguf(path, tensors, metadata)


def device_bytes(qp) -> int:
    """Bytes of every tensor the parameters hold."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0
    return walk(qp)


def q4_k_m_path(dev, counters, prompts, reuse):
    """Write, load and serve the Q4_K_M file, at the defaults and with
    FUSED_DECODE; returns each run's launches."""
    from quant_gemm_tpu_torch.models import gguf_loader, llama

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tinyllama-1.1b-q4_k_m-random.gguf"
        t0 = time.perf_counter()
        write_gguf_mix(path, "Q4_K_M", dev)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        qp, cfg = gguf_loader.load_llama(path, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        size = path.stat().st_size
    print(f"Q4_K_M path: {size} bytes of GGUF ({LAYERS} layers, q6_K "
          f"attn_v/ffn_down in layers {MORE_BITS} and output) written in "
          f"{t_write:.1f} s, loaded onto the card in {t_load:.1f} s, "
          f"{device_bytes(qp)} bytes on the card", flush=True)
    if cfg != tinyllama_cfg():
        fail(f"config from the file's metadata differs: {cfg}")
    split = [i for i, ly in enumerate(qp["layers"])
             if isinstance(ly["wqkv"], llama.SplitLinear)]
    if split != MORE_BITS or qp["lm_head"].qtype != "q6_k":
        fail(f"unexpected structure: SplitLinear wqkv in layers {split}")

    n_chunks, n_heads = chunks(prompts, reuse), heads(prompts, reuse)
    name = "Server(qp, cfg, n_slots=8) on the Q4_K_M file"
    launches, st, _ = serve_traffic(name, qp, cfg, dev, prompts, reuse,
                                    counters, chunk_window=True)
    # a decode step: K1 on the q4_K linears (fused wqkv, or q and k of a
    # split one; wo, wgu; w_down unless q6_K), 4 per layer; K7 on the
    # q6_K attn_v and ffn_down of the more-bits layers and the lm_head;
    # K3 per layer.  A prefill chunk: K4 on the same q4_K linears, the
    # plain float32 matmul on the q6_K ones, and on the lm_head in a
    # prompt's last chunk only, K5 per layer for chunks of 64 or more
    # tokens
    steps, n_q6 = st["decode_steps"], 2 * len(MORE_BITS) + 1
    prefill = {"gemm_dequant": len(n_chunks) * 4 * LAYERS,
               "flash_prefill": LAYERS * sum(t >= 64 for t in n_chunks),
               "k16_dequant_gemm": len(n_chunks) * (n_q6 - 1) + n_heads}
    check_launches(name, launches, {
        "gemm_exact": steps * 4 * LAYERS, "gemm_exact_k16": steps * n_q6,
        "flash_decode": steps * LAYERS, "norm_qkv": 0,
        "gemm_exact_fused": 0, "attn_tail": 0, **prefill})
    print(f"    per decode step: K1 {4 * LAYERS}, K7 {n_q6}, K3 {LAYERS}, "
          f"K2 0; per prefill chunk: K4 {4 * LAYERS}, plain K16 matmul "
          f"{n_q6 - 1} (+1, the head, in a prompt's last), K5 {LAYERS} at "
          "64 tokens or more", flush=True)

    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
    cache = llama.KVCache.init(cfg, 1, device=dev)
    report_cases([("Q4_K_M chunk 128 at pos0 0", check(qp, cfg, toks, cache)),
                  ("Q4_K_M decode step", decode_case(qp, cfg, rng, dev))])
    breakdowns("Q4_K_M", qp, cfg, dev, rng)

    # (c) FUSED_DECODE: K6 takes the 88 q4_K decode GEMMs of a step, the
    # per-16 weights keep quantize + K7, K8 does not apply (q4_K)
    with switches(fused=True):
        fused, st, _ = serve_traffic(f"{RUN_C}: Server(qp, cfg, n_slots=8)",
                                     qp, cfg, dev, prompts, reuse, counters)
        steps = st["decode_steps"]
        check_launches(RUN_C, fused, {
            "gemm_exact_fused": steps * 4 * LAYERS, "gemm_exact": 0,
            "gemm_exact_k16": steps * n_q6, "flash_decode": steps * LAYERS,
            "norm_qkv": 0, "attn_tail": 0, **prefill})
        print(f"    per decode step: K6 {4 * LAYERS}, K7 {n_q6}, K3 "
              f"{LAYERS}, K1 0", flush=True)
        report_cases([(f"{RUN_C} decode step",
                       decode_case(qp, cfg, rng, dev))])
    return {"Q4_K_M bf16": launches, RUN_C: fused}


def route_launches(qp, steps, n_chunks, n_heads, fused, k2):
    """The launches of a run on ``qp`` worked out from its layers and the
    route rules: per decode step (8 rows), K2 for every layer's wqkv when
    the mix takes K2 (``k2``, ``FILE_MIXES``), else the wqkv's parts as
    GEMMs; each decode GEMM K7 on a per-16 weight, K6 with FUSED_DECODE on
    a ``gemm_exact.FUSED_QTYPES`` form, else K1; K3 per layer.  Per
    prefill chunk, K4 on every per-32 weight, the plain float32 matmul on
    every per-16 one, K5 per layer at 64 tokens or more; the lm_head's
    GEMM only in the ``n_heads`` last chunks."""
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_exact import FUSED_QTYPES
    from quant_gemm_tpu_torch.models import llama

    layers = qp["layers"]

    def parts(w):
        return w.parts if isinstance(w, llama.SplitLinear) else (w,)

    gemms = [p for ly in layers for name in ("wqkv", "wo", "wgu", "w_down")
             for p in parts(ly[name])]
    decode = [p for ly in layers for name in ("wo", "wgu", "w_down")
              for p in parts(ly[name])] + [qp["lm_head"]]
    if not k2:
        decode += [p for ly in layers for p in parts(ly["wqkv"])]
    k16 = [isinstance(w, layout.PreparedK16) for w in decode]
    k6 = [fused and not k and w.qtype in FUSED_QTYPES
          for w, k in zip(decode, k16)]
    prefill_k16 = sum(isinstance(w, layout.PreparedK16) for w in gemms)
    head_k16 = isinstance(qp["lm_head"], layout.PreparedK16)
    return {
        "norm_qkv": steps * len(layers) if k2 else 0,
        "flash_decode": steps * len(layers),
        "gemm_exact_k16": steps * sum(k16),
        "gemm_exact_fused": steps * sum(k6),
        "gemm_exact": steps * (len(decode) - sum(k16) - sum(k6)),
        "attn_tail": 0,
        "gemm_dequant": (len(n_chunks) * (len(gemms) - prefill_k16)
                         + n_heads * (not head_k16)),
        "k16_dequant_gemm": len(n_chunks) * prefill_k16 + n_heads * head_k16,
        "flash_prefill": len(layers) * sum(t >= 64 for t in n_chunks),
    }


def check_structure(mix, qp):
    """The loaded parameters hold the mix's weights: one whole weight of
    the default format per slot, a SplitLinear wqkv and per-16 wqkv part
    and w_down in the more-bits layers, the output's format."""
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.models import llama

    types = {k: v.lower() for k, v in FILE_MIXES[mix].items()
             if isinstance(v, str)}
    for i, ly in enumerate(qp["layers"]):
        big = i in MORE_BITS and "more_bits" in types
        want_split = big and types["more_bits"] != types["default"]
        if isinstance(ly["wqkv"], llama.SplitLinear) != want_split:
            fail(f"{mix}: layer {i} wqkv is {type(ly['wqkv']).__name__}")
        for name in ("wo", "wgu", "w_down"):
            qt = types["more_bits"] if big and name == "w_down" \
                else types["default"]
            if ly[name].qtype != qt:
                fail(f"{mix}: layer {i} {name} is {ly[name].qtype}, "
                     f"expected {qt}")
        if not want_split and (not isinstance(ly["wqkv"],
                                              layout.PreparedWeight)
                               or ly["wqkv"].qtype != types["default"]):
            fail(f"{mix}: layer {i} wqkv is not one {types['default']} "
                 "weight")
    if qp["lm_head"].qtype != types["output"]:
        fail(f"{mix}: lm_head is {qp['lm_head'].qtype}")


def formats_path(dev, counters, prompts, reuse):
    """Slice 7: write, load and serve a GGUF file of each of
    ``FORMAT_FILES`` (one on disk at a time), with the first 8 requests of
    the traffic, launches checked against ``route_launches`` and the
    mix's K2 rule; the layer-by-layer check of a chunk and a decode step;
    then ``FUSED_FILES`` again with FUSED_DECODE, whose transcripts must
    equal the default run's.  Returns each run's launches."""
    from quant_gemm_tpu_torch.models import gguf_loader, llama

    prompts, reuse = prompts[:8], reuse[:8]
    n_chunks, n_heads = chunks(prompts, reuse), heads(prompts, reuse)
    by_run, rng = {}, np.random.default_rng(4)
    for seed, mix in enumerate(FORMAT_FILES):
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / f"tinyllama-1.1b-{mix.lower()}-random.gguf"
            t0 = time.perf_counter()
            write_gguf_mix(path, mix, dev, seed=10 + seed)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            qp, cfg = gguf_loader.load_llama(path, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            size = path.stat().st_size
        on_card = device_bytes(qp)
        print(f"{mix} file: {size} bytes of GGUF written in {t_write:.1f} s, "
              f"loaded onto the card in {t_load:.1f} s, {on_card} bytes on "
              f"the card ({on_card / size:.3f} x the file)", flush=True)
        if cfg != tinyllama_cfg():
            fail(f"{mix}: config from the file's metadata differs: {cfg}")
        check_structure(mix, qp)
        name = f"{mix}: Server(qp, cfg, n_slots=8)"
        launches, st, default = serve_traffic(name, qp, cfg, dev, prompts,
                                              reuse, counters)
        k2 = FILE_MIXES[mix]["k2"]
        want = route_launches(qp, st["decode_steps"], n_chunks, n_heads,
                              False, k2)
        check_launches(name, launches, want)
        steps = st["decode_steps"]
        print(f"    per decode step: K2 {want['norm_qkv'] // steps}, K1 "
              f"{want['gemm_exact'] // steps}, K7 "
              f"{want['gemm_exact_k16'] // steps}, K3 {LAYERS}", flush=True)
        by_run[f"{mix} bf16"] = launches
        toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
        cache = llama.KVCache.init(cfg, 1, device=dev)
        report_cases([(f"{mix} chunk 128 at pos0 0",
                       check(qp, cfg, toks, cache)),
                      (f"{mix} decode step",
                       decode_case(qp, cfg, rng, dev))])
        if mix in FUSED_FILES:
            run = f"{mix} FUSED_DECODE"
            with switches(fused=True):
                fused, st, results = serve_traffic(
                    f"{run}: Server(qp, cfg, n_slots=8)", qp, cfg, dev,
                    prompts, reuse, counters)
            want = route_launches(qp, st["decode_steps"], n_chunks,
                                  n_heads, True, k2)
            check_launches(run, fused, want)
            if results != default:
                fail(f"{run}: the transcripts differ from the default "
                     "run's")
            print(f"    per decode step: K6 "
                  f"{want['gemm_exact_fused'] // st['decode_steps']}, K2 "
                  f"{want['norm_qkv'] // st['decode_steps']}, K1 0; all "
                  f"{len(prompts)} transcripts equal the default run's",
                  flush=True)
            by_run[run] = fused
        del qp
        torch.cuda.empty_cache()
    return by_run


def mistral_cfg(ring=True, max_seq=M_MAX_SEQ):
    from quant_gemm_tpu_torch.models import llama

    return llama.LlamaConfig(vocab=VOCAB, dim=M_DIM, n_layers=M_LAYERS,
                             n_heads=M_HEADS, n_kv_heads=M_KV, d_ff=M_D_FF,
                             max_seq=max_seq, rope_base=10000.0, eps=1e-5,
                             window=M_WINDOW, ring=ring,
                             ring_chunk=M_RING_CHUNK)


def random_rows(cache, g):
    """Fill every slot of ``cache`` with random k/v rows (bf16 normal, or
    int8 codes with scales of 0.005-0.03), in place."""
    if cache.quantized:
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=t.device, dtype=torch.int8))
        for t in (cache.ks, cache.vs):
            t.copy_(0.005 + 0.025 * torch.rand(t.shape, generator=g,
                                               device=t.device))
    else:
        for t in (cache.k, cache.v):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def ring_from_linear(ring_cache, lin, ring):
    """Write the newest ``ring`` rows below each slot's position of the
    linear cache ``lin`` into the ring at slot g % ring; both get lin's
    positions."""
    for b, p in enumerate(lin.pos.tolist()):
        gs = torch.arange(max(p - ring, 0), p, device=lin.k.device)
        for dst, src in ((ring_cache.k, lin.k), (ring_cache.v, lin.v),
                         (ring_cache.ks, lin.ks), (ring_cache.vs, lin.vs)):
            if dst is not None:
                dst[:, b, :, gs % ring] = src[:, b, :, gs]
    ring_cache.pos = lin.pos.clone()


def pair_layerwise(qp, tokens, a, b):
    """Two (cfg, cache) runs of the same tokens through the kernels from
    the same hidden state (b's) at every layer: per layer and for the
    logits, (NMSE, max|delta| / max|b's|) of a's update against b's."""
    from quant_gemm_tpu_torch.models import llama

    (cfg_a, cache_a), (cfg_b, cache_b) = a, b
    x, step_a = llama.begin(qp, cfg_a, tokens, cache_a)
    _, step_b = llama.begin(qp, cfg_b, tokens, cache_b)
    worst_nmse = worst_rel = 0.0
    for li, lyr in enumerate(qp["layers"]):
        xa, _ = llama.layer(lyr, li, cfg_a, x, cache_a, step_a)
        xb, _ = llama.layer(lyr, li, cfg_b, x, cache_b, step_b)
        da, db = xa - x, xb - x
        worst_nmse = max(worst_nmse, nmse(da, db))
        worst_rel = max(worst_rel, ((da - db).abs().max()
                                    / db.abs().max()).item())
        x = xb
    la, lb = llama.head(qp, cfg_a, xa), llama.head(qp, cfg_b, xb)
    if not bool(torch.isfinite(la).all() and torch.isfinite(lb).all()):
        fail("non-finite logits through the kernels")
    return (worst_nmse, worst_rel, nmse(la, lb),
            ((la - lb).abs().max() / lb.abs().max()).item())


RUN_M1 = "Mistral ring bf16"
M_PROMPTS = (4600, 4800, 5100, 300)
M_DECODE_POS = [4000, 4500, 4606, 4607, 4608, 4609, 4660, 4720]


def mistral_path(dev, counters):
    """Mistral-7B-v0.1 width on the ring cache: (m1) the ring Server,
    (m2) kernels against plain versions on the ring and the ring against
    the linear windowed cache, (m3) context_shift on the linear cache,
    and the profiler's view of a decode step and a chunk.  Returns m1's
    launches."""
    from quant_gemm_tpu_torch.harness.profiling import device_breakdown
    from quant_gemm_tpu_torch.models import llama, serve

    cfg = mistral_cfg()
    ring = cfg.ring_capacity
    if ring != M_RING:
        fail(f"Mistral ring capacity {ring}, expected {M_RING}")
    t0 = time.perf_counter()
    qp = llama.init_qparams(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    cache_bytes = 2 * M_LAYERS * 8 * M_KV * ring * M_HD * 2
    print(f"Mistral path: Mistral-7B-v0.1 width, {M_LAYERS} layers, random "
          f"q4_0 weights built on the card in {time.perf_counter() - t0:.1f}"
          f" s, {device_bytes(qp)} bytes on the card; ring of {ring} slots "
          f"(window {M_WINDOW} + ring_chunk {M_RING_CHUNK}), bf16 cache of 8 "
          f"slots {cache_bytes} bytes (a linear cache at max_seq "
          f"{M_MAX_SEQ}: {cache_bytes * M_MAX_SEQ // ring})", flush=True)

    # (m1) the ring Server at its defaults: chunk 128 (within ring_chunk),
    # prompt caching off; 4600 crosses the edge decoding, 4800 and 5100
    # wrap the ring in prefill
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in M_PROMPTS]
    with graphs(False):
        warm = serve.Server(qp, cfg, n_slots=8, device=dev)
        warm.submit(list(range(1, 200)), max_new=2)  # first-use costs
        warm.run_until_done()
        del warm
        torch.cuda.empty_cache()
        srv = serve.Server(qp, cfg, n_slots=8, device=dev)
        if (srv.max_chunk, srv.cache_prompt) != (min(128, M_RING_CHUNK),
                                                 False):
            fail(f"ring Server: chunk {srv.max_chunk}, cache_prompt "
                 f"{srv.cache_prompt}; expected 128, False")
        if tuple(srv.cache.k.shape) != (M_LAYERS, 8, M_KV, ring, M_HD):
            fail(f"ring Server cache {tuple(srv.cache.k.shape)}")
        results, launches, wall = drive(srv, prompts, 64, counters)
    st = srv.stats()
    if sorted(results) != [0, 1, 2, 3] or any(
            len(t) != 64 for t in results.values()):
        fail(f"m1: not every request finished with 64 tokens: "
             f"{ {r: len(t) for r, t in results.items()} }")
    if not all(0 <= t < VOCAB for ts in results.values() for t in ts):
        fail("m1: a generated token is outside the vocabulary")
    if st["cached_prompt_tokens"] != 0:
        fail(f"m1: reused {st['cached_prompt_tokens']} prompt tokens")
    n_chunks = chunks(prompts, [0] * len(prompts), srv.max_chunk)
    steps = st["decode_steps"]
    check_launches(RUN_M1, launches, {
        "gemm_exact": steps * (3 * M_LAYERS + 1),
        "norm_qkv": steps * M_LAYERS, "flash_decode": steps * M_LAYERS,
        "gemm_dequant": len(n_chunks) * 4 * M_LAYERS + len(prompts),
        "flash_prefill": M_LAYERS * sum(t >= 64 for t in n_chunks),
        "gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0,
        "k16_dequant_gemm": 0})
    check_heads(RUN_M1, st, prompts, [0] * len(prompts), srv.max_chunk,
                srv.bucket)
    print(f"  (m1) Server(qp, cfg, n_slots=8) on the ring: 4 requests "
          f"(prompts {list(M_PROMPTS)}), {st['prefill_tokens']} prompt "
          f"tokens in {len(n_chunks)} chunks, {st['generated_tokens']} "
          f"generated, {steps} decode steps in {wall:.2f} s (eager), "
          f"cache {list(srv.cache.k.shape)}, 0 reused", flush=True)
    print(f"    eager: prefill "
          f"{st['prefill_tokens'] / st['prefill_seconds']:.1f} tok/s, "
          f"decode {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tok/s, mean decode step "
          f"{1e3 * st['decode_seconds'] / st['decode_steps']:.3f} ms",
          flush=True)
    print(f"    per decode step: K2 {M_LAYERS}, K3 {M_LAYERS}, K1 "
          f"{3 * M_LAYERS + 1}, Q8_1 quantize {3 * M_LAYERS + 1}; per "
          f"chunk: K4 and its quantize-fold {4 * M_LAYERS + 1}, K5 "
          f"{M_LAYERS} at 64 tokens or more; K6, K7, K8 0", flush=True)
    print(f"    launches: {json.dumps(launches)}", flush=True)
    eager = (srv, results, launches, wall)
    with graphs(True):
        cap = serve.Server(qp, cfg, n_slots=8, device=dev)
        captured_pair(RUN_M1, eager, (cap, *drive(cap, prompts, 64,
                                                   counters)),
                      chunk_window=True)
    staging_copies(cfg, cap.cache, dev)
    del srv, cap, eager
    torch.cuda.empty_cache()

    # (m2) kernels against plain versions on the ring: a 128-token chunk
    # at pos0 R - 64 (across the edge) and an 8-slot decode step at
    # positions on both sides of R, both caches; then the same tokens on
    # the ring and on a linear window-4096 cache holding the same rows
    g = torch.Generator(device=dev).manual_seed(7)
    lin_cfg = mistral_cfg(ring=False, max_seq=M_LIN_SEQ)
    cases, pairs = [], []
    for qtype in ("bf16", "q8"):
        for b, pos, t in ((1, [ring - 64], 128), (8, M_DECODE_POS, 1)):
            what = (f"{qtype} chunk {t} at pos0 {ring - 64}" if t > 1 else
                    f"{qtype} decode step at {M_DECODE_POS}")
            lin = llama.KVCache.init(lin_cfg, b, qtype, device=dev)
            random_rows(lin, g)
            lin.pos = torch.tensor(pos, dtype=torch.int32, device=dev)
            rc = llama.KVCache.init(cfg, b, qtype, device=dev)
            random_rows(rc, g)
            ring_from_linear(rc, lin, ring)
            toks = torch.randint(0, VOCAB, (b, t), generator=g, device=dev)
            cases.append((f"ring {what}", check(qp, cfg, toks, rc)))
            pairs.append((what, pair_layerwise(qp, toks, (cfg, rc),
                                               (lin_cfg, lin))))
            del lin, rc
            torch.cuda.empty_cache()
    report_cases(cases)
    for what, (layer_e, layer_rel, logit_e, logit_rel) in pairs:
        print(f"  ring vs linear window {M_WINDOW} (same rows), {what}: "
              f"worst layer update NMSE {layer_e:.3e} (rel max "
              f"{layer_rel:.3e}), logits NMSE {logit_e:.3e} (rel max "
              f"{logit_rel:.3e}) (limits: NMSE 1e-4)", flush=True)
        if not (layer_e <= 1e-4 and logit_e <= 1e-4):
            fail(f"ring vs linear, {what}: the ring disagrees")

    mistral_shift(qp, dev, rng, counters)

    # the device's view of one ring decode step past R and one chunk,
    # with the model's RoPE tables made once, as the Server makes them
    # (at max_seq 32768 a forward without them builds 16 MB of tables)
    rope = llama.rope_for(cfg, qp, dev)
    cache = llama.KVCache.init(cfg, 8, device=dev)
    random_rows(cache, g)
    cache.pos = torch.tensor(M_DECODE_POS, dtype=torch.int32, device=dev)
    nt = torch.randint(0, VOCAB, (8, 1), generator=g, device=dev)
    device_breakdown(f"Mistral ring decode step, 8 slots at "
                     f"{M_DECODE_POS}", lambda: llama.forward(
                         qp, cfg, nt, cache, rope_cache=rope))
    del cache
    c1 = llama.KVCache.init(cfg, 1, device=dev)
    random_rows(c1, g)
    c1.pos = torch.tensor([ring - 64], dtype=torch.int32, device=dev)
    toks = torch.randint(0, VOCAB, (1, 128), generator=g, device=dev)
    device_breakdown(f"Mistral ring prefill chunk of 128 tokens at pos0 "
                     f"{ring - 64} (then {ring + 64})",
                     lambda: llama.forward(qp, cfg, toks, c1,
                                           rope_cache=rope))
    return launches


def staging_copies(cfg, cache, dev):
    """CUDA-event times of the copies a staged prefill makes
    (``Server._prefill``: slot 0 of ``cache`` into a one-slot cache only
    where a prefix is reused, so never on the ring; back into the slot
    at every admission), each against its bound: the slab read and
    written once at 3.35 TB/s."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.models import llama

    c1 = llama.KVCache.init(cfg, 1, "q8" if cache.quantized else "bf16",
                            device=dev)
    stage, view = c1.buffers(), [t[:, :1] for t in cache.buffers()]
    nbytes = sum(t.numel() * t.element_size() for t in stage)
    times = []
    for pairs in (list(zip(stage, view)), list(zip(view, stage))):
        for dst, src in pairs:  # warm
            dst.copy_(src)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for dst, src in pairs:
            dst.copy_(src)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    bnd = bound(2 * nbytes, 0, "bf16")[0]
    print(f"  staging copies of one slot ({nbytes} bytes): extract "
          f"(prefix reuse only) {times[0]:.3f} ms, insert (every "
          f"admission) {times[1]:.3f} ms (bound {bnd:.3f} ms each: read "
          "and written once)", flush=True)
    del c1


def mistral_shift(qp, dev, rng, counters):
    """(m3) context_shift on the linear windowed cache at max_seq 4608: a
    4600-token prompt generates 64 tokens, its slot shifted to the
    window's 4096 tokens at 4607, eagerly and captured, each run's
    launches counted and held to the route; then one decode step from a
    shifted cache against the same step from an unshifted one (max_seq
    4736), layer by layer."""
    from quant_gemm_tpu_torch.models import llama, serve

    cfg = mistral_cfg(ring=False, max_seq=M_RING)
    prompt = rng.integers(0, VOCAB, M_SHIFT_PROMPT).tolist()
    runs = {}
    for on in (False, True):
        with graphs(on):
            srv = serve.Server(qp, cfg, n_slots=8, context_shift=True,
                               device=dev)
            rid = srv.submit(prompt, max_new=64)
            trace = []
            zero(counters)
            t0 = time.perf_counter()
            while srv.queue or any(s is not None for s in srv.slots):
                srv.step()
                trace.append(int(srv.cache.pos[0]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = served_launches(srv, counters)
        steps = srv.stats()["decode_steps"]
        n_chunks = chunks([prompt], [0], srv.max_chunk)
        check_launches(f"(m3) context shift, graphs {on}", launches, {
            "gemm_exact": steps * (3 * M_LAYERS + 1),
            "norm_qkv": steps * M_LAYERS, "flash_decode": steps * M_LAYERS,
            "gemm_dequant": len(n_chunks) * 4 * M_LAYERS + 1,
            "flash_prefill": M_LAYERS * sum(t >= 64 for t in n_chunks),
            "gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0,
            "k16_dequant_gemm": 0})
        runs[on] = (srv, {rid: srv.finished[rid].generated}, trace, wall,
                    launches)
    srv, res, trace, _, _ = runs[False]
    toks = res[rid]
    low = min(trace)
    if len(toks) != 64 or not all(0 <= t < VOCAB for t in toks):
        fail(f"m3: {len(toks)} tokens generated, expected 64 in the vocab")
    if not (max(trace) == M_RING - 1 and low == M_WINDOW + 1
            and trace[-1] > low):
        fail(f"m3: the slot did not shift to {M_WINDOW} and grow: "
             f"positions {trace}")
    print(f"  (m3) Server(qp, cfg, n_slots=8, context_shift=True), max_seq "
          f"{M_RING}: 64 tokens generated from a {M_SHIFT_PROMPT}-token "
          f"prompt; "
          f"position after each step {trace[0]}..{max(trace)}, shifted to "
          f"{M_WINDOW} and on to {trace[-1]}", flush=True)
    if runs[True][2] != trace:
        fail("m3: the captured run's positions differ from the eager run's")
    print(f"    launches: {json.dumps(runs[False][4])}", flush=True)
    (se, re_, _, we, le), (sc, rc, _, wc, lc) = runs[False], runs[True]
    captured_pair("(m3) context shift", (se, re_, le, we), (sc, rc, lc, wc))
    del srv, runs
    torch.cuda.empty_cache()

    big = mistral_cfg(ring=False, max_seq=M_LIN_SEQ)
    prompt = torch.as_tensor(rng.integers(0, VOCAB, (1, M_RING - 1)),
                             device=dev)
    cb = llama.KVCache.init(big, 1, device=dev)
    for off in range(0, M_RING - 1, 128):
        llama.forward(qp, big, prompt[:, off:off + 128], cb)
    cs = llama.KVCache.init(cfg, 1, device=dev)
    cs.k[:, :, :, :M_RING - 1] = cb.k[:, :, :, :M_RING - 1]
    cs.v[:, :, :, :M_RING - 1] = cb.v[:, :, :, :M_RING - 1]
    cs.pos = cb.pos.clone()
    llama.shift_context(cs, cfg, M_WINDOW)
    if cs.pos.tolist() != [M_WINDOW]:
        fail(f"m3: shift_context left pos {cs.pos.tolist()}")
    tok = torch.as_tensor(rng.integers(0, VOCAB, (1, 1)), device=dev)
    layer_e, layer_rel, logit_e, logit_rel = pair_layerwise(
        qp, tok, (cfg, cs), (big, cb))
    print(f"  (m3) decode step from the shifted cache (pos {M_WINDOW}) vs "
          f"the unshifted one (pos {M_RING - 1}), kernels, same hidden "
          f"state per layer: worst layer update rel max {layer_rel:.3e} "
          f"(NMSE {layer_e:.3e}), logits rel max {logit_rel:.3e} (NMSE "
          f"{logit_e:.3e}); limit rel max {SHIFT_TOL:g}", flush=True)
    if not (layer_rel <= SHIFT_TOL and logit_rel <= SHIFT_TOL):
        fail("m3: the shifted cache's step disagrees with the unshifted")


FIXTURE = ROOT / "tests" / "golden" / "tiny_llama_q4km.gguf"
PROMPT_IDS = [0, 262, 312, 311, 292]  # tests/test_gguf_interop.py
GREEDY_CONT = [252, 44, 79, 306, 79, 306]


def foreign_bytes(dev):
    """The independent generator's Q4_K_M file on the card: prefill and
    six greedy steps through the kernels, teacher-forced along the pinned
    transcript.  Each pinned token must be the argmax, or within 2 x 2e-2
    x max|logits| of it (the near-tie rule of the CPU server tests)."""
    from quant_gemm_tpu_torch.models import gguf_loader, llama

    qp, cfg = gguf_loader.load_llama(FIXTURE, device=dev)
    cache = llama.KVCache.init(cfg, 1, device=dev)
    feed = [PROMPT_IDS] + [[t] for t in GREEDY_CONT[:-1]]
    own, margins = [], []
    for want, toks in zip(GREEDY_CONT, feed):
        logits, cache = llama.forward(
            qp, cfg, torch.tensor([toks], device=dev), cache)
        last = logits[0, -1]
        own.append(int(last.argmax()))
        slack = float(last.max() - last[want])
        margins.append(slack / float(last.abs().max()))
        if own[-1] != want:
            print(f"  near-tie at step {len(own) - 1}: pinned {want}, "
                  f"argmax {own[-1]}, margin {margins[-1]:.3e} x "
                  "max|logits|", flush=True)
        if slack > 4e-2 * float(last.abs().max()):
            fail(f"fixture transcript: step {len(own) - 1} picks {own[-1]}, "
                 f"pinned {want} is {margins[-1]:.3e} x max|logits| below")
    print(f"foreign bytes: {FIXTURE.name} on the card, greedy (teacher-"
          f"forced) {own}, pinned {GREEDY_CONT}: "
          f"{'equal' if own == GREEDY_CONT else 'near-tie'}", flush=True)


RUN_SPEC = "spec runner"


def spec_phase(dev, counters):
    """The port's spec runner on the card: every definition at its own
    parameters, every gemm definition under each ladder rung its
    activation takes, and the full-width runs; counters from 0 just before
    and read just after, checked against the phase's launches."""
    from quant_gemm_tpu_torch.specs import spec_runner

    defs = spec_runner.definitions()
    gemm = [p for p in defs if spec_runner.load(p)["op_type"] == "gemm_quant"]
    q8 = [p for p in gemm
          if spec_runner.load(p)["inputs"]["A"]["dtype"] == "q8_1"]
    a16 = [p for p in gemm if p not in q8]
    failed = []

    def run(path, impl=None, params=None, memo=None):
        r = spec_runner.run_spec(path, impl=impl, params=params, device=dev,
                                 memo=memo)
        if not r.passed:
            failed.append((path.stem, impl, params, r.row()))
        return r

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    print(f"  every committed definition ({len(defs)}), on the card:",
          flush=True)
    for p in defs:
        print(f"    {run(p).row()}", flush=True)
    rungs = {"pallas_exact": q8, "pallas_f32": gemm, "pallas_bf16": gemm,
             "pallas": gemm, "pallas_fused_quant": a16, "xla_dequant": gemm,
             "xla_int": q8, "xla_compensated": q8}
    for impl, paths in rungs.items():
        res = [run(p, impl) for p in paths]
        worst = max(r.nmse / r.threshold for r in res)
        print(f"  ladder {impl:16s} {len(res)} gemm definitions, worst NMSE "
              f"/ threshold {worst:.3f}", flush=True)
    print("  full width (Mistral-7B-v0.1 shapes):", flush=True)
    for r, c in SPEC_RMSNORM:
        row = run(defs[[p.stem for p in defs].index("rmsnorm")],
                  params={"R": r, "C": c}).row()
        print(f"    R={r} C={c} {row}", flush=True)
    for r, c in SPEC_SOFTMAX:
        row = run(defs[[p.stem for p in defs].index("softmax")],
                  params={"R": r, "C": c}).row()
        print(f"    R={r} C={c} {row}", flush=True)
    for name, (n, k) in SPEC_GEMM.items():
        memo = {}  # this shape's draws and goldens, drawn once
        for p in gemm:
            row = run(p, params={"M": 128, "N": n, "K": k}, memo=memo).row()
            print(f"    {name} M=128 N={n} K={k} pallas_f32 {row}",
                  flush=True)
            if p in q8:
                row = run(p, "pallas_exact", {"M": 8, "N": n, "K": k},
                          memo).row()
                print(f"    {name} M=8 N={n} K={k} pallas_exact {row}",
                      flush=True)
        del memo
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    print(f"  spec phase: {len(defs)} definitions, "
          f"{sum(len(v) for v in rungs.values())} ladder runs, "
          f"{len(SPEC_RMSNORM) + len(SPEC_SOFTMAX) + 2 * (len(gemm) + len(q8))}"
          f" full-width runs in {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(launches)}", flush=True)
    if failed:
        fail(f"spec runner on the card: {len(failed)} runs failed: {failed}")
    # K9/K10: rmsnorm / softmax once each, then at each full-width shape;
    # K4: every gemm definition by default (pallas_f32), three K4 rungs
    # each, and at both shapes, and pallas_fused_quant for each float-
    # activation definition; K1: pallas_exact for each Q8_1 definition
    # and at both shapes; K3/K5: the two attention definitions
    check_launches(RUN_SPEC, launches, {
        "rms_norm_pallas": 1 + len(SPEC_RMSNORM),
        "softmax_pallas": 1 + len(SPEC_SOFTMAX),
        "gemm_dequant": len(gemm) * (1 + 3 + len(SPEC_GEMM)) + len(a16),
        "gemm_exact": len(q8) * (1 + len(SPEC_GEMM)),
        "flash_decode": 1, "flash_prefill": 1, "norm_qkv": 0,
        "gemm_exact_k16": 0, "gemm_exact_fused": 0, "attn_tail": 0,
        "quantize_q8_1": 0, "quantize_fold_q8_1": 0})
    return launches


# Qwen2.5-1.5B-Instruct (huggingface.co/Qwen/Qwen2.5-1.5B-Instruct
# config.json): hidden 1536, intermediate 8960, 28 layers, 12 heads, 2 KV
# heads (head_dim 128, rep 6), vocab 151936, rope_theta 1e6,
# rms_norm_eps 1e-6, max_position_embeddings 32768, tie_word_embeddings,
# biases on q/k/v
Q_DIM, Q_D_FF, Q_LAYERS, Q_HEADS, Q_KV = 1536, 8960, 28, 12, 2
Q_VOCAB, Q_CTX, Q_ROPE, Q_EPS = 151936, 32768, 1000000.0, 1e-6
Q_HD = Q_DIM // Q_HEADS
Q_REP = Q_HEADS // Q_KV
# Qwen's specials (its tokenizer_config.json): <|endoftext|> (bos and
# padding), <|im_start|>, <|im_end|> (eos of the instruct model)
Q_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
              "<|im_end|>": 151645}
Q_BOS, Q_EOS = 151643, 151645
# ChatML, the template of Qwen2.5's chat turns without tools
CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] "
          "+ '\\n' + message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}"
          "{% endif %}")
# the Qwen files written and served, in order (FILE_MIXES)
QWEN_MIXES = ("Q4_0", "IQ4_XS", "IQ4_NL")
Q_NEW = 32  # new tokens of each chat request
Q_FIRST_DOWN = Q_LAYERS // 8  # IQ4 mixes: ffn_down q5_K in layers below


def chatml(messages) -> str:
    """What ``CHATML`` renders (the path without jinja2)."""
    return "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                   for m in messages) + "<|im_start|>assistant\n"


def qwen_cfg():
    from quant_gemm_tpu_torch.models import llama

    return llama.LlamaConfig(vocab=Q_VOCAB, dim=Q_DIM, n_layers=Q_LAYERS,
                             n_heads=Q_HEADS, n_kv_heads=Q_KV, d_ff=Q_D_FF,
                             max_seq=Q_CTX, rope_base=Q_ROPE, eps=Q_EPS)


def qwen_vocab(seed=0, size=Q_VOCAB, specials=None) -> dict:
    """A byte-level BPE vocabulary of ``Q_VOCAB`` entries drawn from a
    seed, as ``tokenizer.ggml.*`` metadata with ``pre = "qwen2"``: the 256
    byte symbols, then merges up to id 151642 (each joins two earlier
    tokens of at most 6 symbols into a new one: a word piece, or with
    GPT-2's space symbol in front a word start), Qwen's three specials at
    151643-151645 and control pads to 151935, as Qwen's GGUF files pad
    the vocabulary; the ChatML chat template."""
    import random

    from quant_gemm_tpu_torch.models import tokenizer

    specials = specials or Q_SPECIALS
    first = min(specials.values())
    rnd = random.Random(seed)
    b2u = tokenizer._B2U
    tokens = [b2u[b] for b in range(256)]
    seen = set(tokens)
    merges = []
    space = b2u[ord(" ")]
    # the tokens of at most 6 symbols a merge may join
    pieces = [b2u[b] for b in range(ord("a"), ord("z") + 1)]
    starts = []

    def add(a, b):
        t = a + b
        tokens.append(t)
        seen.add(t)
        merges.append(f"{a} {b}")
        if len(t) <= 6:
            (starts if t.startswith(space) else pieces).append(t)

    for c in list(pieces):
        add(space, c)
    while len(tokens) < first:
        a = rnd.choice(starts) if rnd.random() < 0.5 else rnd.choice(pieces)
        b = rnd.choice(pieces)
        if a + b not in seen:
            add(a, b)
    types = [1] * len(tokens)
    for name in sorted(specials, key=specials.get):
        tokens.append(name)
        types.append(3)
    while len(tokens) < size:
        tokens.append(f"[PAD{len(tokens)}]")
        types.append(3)
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": first,
            "tokenizer.ggml.eos_token_id": max(specials.values()),
            "tokenizer.ggml.padding_token_id": first,
            "tokenizer.ggml.add_bos_token": False,
            "tokenizer.chat_template": CHATML}


def write_qwen_gguf(path, mix, dev, vocab_md, seed=0):
    """A Qwen2.5-1.5B-width GGUF file of llama.cpp's ``mix`` (Q4_0 or
    IQ4_XS / IQ4_NL, ``FILE_MIXES``): random valid blocks from a
    ``torch.Generator`` seed on the card, weights at about 1/sqrt(K), no
    ``output.weight`` (tied: ``token_embd`` is the head, q6_K, values of
    about 0.02), f32 norms of 1 and f32 QKV biases of about 0.1, qwen2
    metadata and the tokenizer ``vocab_md``."""
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats.gguf_file import RawTensor, write_gguf

    types = FILE_MIXES[mix]
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(qtype, n, k, std=None):
        std = std or k ** -0.5
        if qtype in ("iq4_nl", "iq4_xs"):
            return RawTensor(qtype, (n, k),
                             kquants.random_iq4(qtype, n, k, std, g))
        if qtype in Q32_BLOCK_BYTES:
            return random_blocks32(qtype, n, k, std, g)
        return kquants.random_blocks(qtype, n, k, std, g)

    def vec(n, std):
        return torch.randn(n, generator=g, device=dev) * std

    ones = torch.ones(Q_DIM, device=dev)
    base = types["default"]
    tensors = {"token_embd.weight": lin(types["output"], Q_VOCAB, Q_DIM,
                                        0.02),
               "output_norm.weight": ones}
    for i in range(Q_LAYERS):
        blk = f"blk.{i}."
        down = types.get("first_down", base) if i < Q_FIRST_DOWN else base
        tensors.update({
            blk + "attn_norm.weight": ones,
            blk + "attn_q.weight": lin(base, Q_HEADS * Q_HD, Q_DIM),
            blk + "attn_q.bias": vec(Q_HEADS * Q_HD, 0.1),
            blk + "attn_k.weight": lin(base, Q_KV * Q_HD, Q_DIM),
            blk + "attn_k.bias": vec(Q_KV * Q_HD, 0.1),
            blk + "attn_v.weight": lin(types.get("attn_v", base),
                                       Q_KV * Q_HD, Q_DIM),
            blk + "attn_v.bias": vec(Q_KV * Q_HD, 0.1),
            blk + "attn_output.weight": lin(base, Q_DIM, Q_HEADS * Q_HD),
            blk + "ffn_norm.weight": ones,
            blk + "ffn_gate.weight": lin(base, Q_D_FF, Q_DIM),
            blk + "ffn_up.weight": lin(base, Q_D_FF, Q_DIM),
            blk + "ffn_down.weight": lin(down, Q_DIM, Q_D_FF),
        })
    metadata = {
        "general.architecture": "qwen2",
        "general.name": f"Qwen2.5-1.5B width, {mix} mix, random blocks",
        "general.file_type": types["file_type"],
        "qwen2.vocab_size": Q_VOCAB, "qwen2.embedding_length": Q_DIM,
        "qwen2.block_count": Q_LAYERS, "qwen2.feed_forward_length": Q_D_FF,
        "qwen2.attention.head_count": Q_HEADS,
        "qwen2.attention.head_count_kv": Q_KV,
        "qwen2.context_length": Q_CTX, "qwen2.rope.freq_base": Q_ROPE,
        "qwen2.attention.layer_norm_rms_epsilon": Q_EPS,
        **vocab_md,
    }
    write_gguf(path, tensors, metadata)


def check_qwen_structure(mix, qp):
    """The loaded Qwen parameters hold the mix: every layer's float32
    ``bqkv`` [2048], one whole default-format wqkv (Q4_0) or a
    SplitLinear of q, k in the default format and v q5_k (IQ4), ffn_down
    q5_k in the first eighth (IQ4), the tied q6_K head."""
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.models import llama

    types = FILE_MIXES[mix]
    base = {"iq4_nl": "q8_0"}.get(types["default"], types["default"])
    for i, ly in enumerate(qp["layers"]):
        b = ly.get("bqkv")
        if b is None or b.dtype != torch.float32 or \
                b.shape != ((Q_HEADS + 2 * Q_KV) * Q_HD,):
            fail(f"{mix}: layer {i} has no float32 bqkv of "
                 f"{(Q_HEADS + 2 * Q_KV) * Q_HD}")
        w = ly["wqkv"]
        if "attn_v" in types:
            if not (isinstance(w, llama.SplitLinear)
                    and [p.qtype for p in w.parts] == [base, base, "q5_k"]):
                fail(f"{mix}: layer {i} wqkv is not q, k {base} + v q5_k")
        elif not (isinstance(w, layout.PreparedWeight) and w.qtype == base):
            fail(f"{mix}: layer {i} wqkv is not one {base} weight")
        down = "q5_k" if "first_down" in types and i < Q_FIRST_DOWN \
            else base
        if ly["w_down"].qtype != down or ly["wo"].qtype != base \
                or ly["wgu"].qtype != base:
            fail(f"{mix}: layer {i} wo/wgu/w_down are "
                 f"{ly['wo'].qtype}/{ly['wgu'].qtype}/{ly['w_down'].qtype}")
    head = qp["lm_head"]
    if not (isinstance(head, layout.PreparedK16) and head.qtype == "q6_k"
            and head.n == Q_VOCAB):
        fail(f"{mix}: the tied head is not q6_K [{Q_VOCAB}, {Q_DIM}]")


def qwen_words(tok, rnd, n_tokens) -> str:
    """Text of random lower-case words that tokenizes to ``n_tokens``
    (each word, a space in front, is a piece of its own in the qwen2
    split, so the counts add up)."""
    words, total = [], 0
    while total < n_tokens:
        w = " " + "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz")
                          for _ in range(rnd.randint(2, 9)))
        n = len(tok.encode(w, add_bos=False))
        if total + n <= n_tokens:
            words.append(w)
            total += n
    return "".join(words)


def qwen_traffic(tok, n=16, seed=0):
    """``n`` chat turns: one shared system prompt of 200 tokens and user
    turns of 64-512 tokens."""
    import random

    rnd = random.Random(seed)
    system = qwen_words(tok, rnd, 200).strip()
    return [[{"role": "system", "content": system},
             {"role": "user",
              "content": qwen_words(tok, rnd, rnd.randint(64, 512)).strip()}]
            for _ in range(n)]


def http_post(base, path, obj, timeout=600):
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_stream(base, path, obj, timeout=600) -> list:
    """The data payloads of a Server-Sent Events answer."""
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if not r.headers["Content-Type"].startswith("text/event-stream"):
            fail(f"{path}: a stream answered {r.headers['Content-Type']}")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[6:])
    if events[-1] != "[DONE]":
        fail(f"{path}: the stream did not end with [DONE]")
    return [json.loads(e) for e in events[:-1]]


@contextlib.contextmanager
def http_server(engine):
    """The port's HTTP front end over ``engine`` on 127.0.0.1 in a
    thread; yields its base URL; shuts both down after the block."""
    import threading
    from http.server import ThreadingHTTPServer

    from quant_gemm_tpu_torch.scripts import server as http

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), http.make_handler(engine))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(60)
        engine.shutdown()
        if th.is_alive() or engine.thread.is_alive():
            fail("the HTTP server or its engine thread did not stop")


def release() -> None:
    """Free what no one holds any more (Servers in reference cycles
    too) and hand the cached device memory back."""
    gc.collect()
    torch.cuda.empty_cache()


def admissions(srv) -> list:
    """Wrap ``srv.submit`` and ``srv.step`` to record (steps run before
    it, request id, prompt ids) of each submission, in a list returned:
    a Server fed the same ids at the same steps replays the run."""
    trace, steps = [], [0]
    submit, step = srv.submit, srv.step

    def submitted(prompt_ids, **kw):
        rid = submit(prompt_ids, **kw)
        trace.append((steps[0], rid, list(prompt_ids)))
        return rid

    def stepped():
        out = step()
        steps[0] += 1
        return out

    srv.submit, srv.step = submitted, stepped
    return trace


def http_chats(base, turns, use_chat, stream_one=0):
    """All ``turns`` at once, each from its own thread: through
    ``/v1/chat/completions`` (``use_chat``) or as ChatML text through
    ``/completion``; request ``stream_one`` streamed.  Returns each
    one's (text, completion tokens) and the wall seconds."""
    import threading

    out: dict = {}

    def go(i):
        body = ({"messages": turns[i]} if use_chat
                else {"prompt": chatml(turns[i])})
        body.update({"max_tokens": Q_NEW, "n_predict": Q_NEW})
        path = "/v1/chat/completions" if use_chat else "/completion"
        if i == stream_one:
            body["stream"] = True
            ev = http_stream(base, path, body)
            if use_chat:
                text = "".join(e["choices"][0]["delta"].get("content", "")
                               for e in ev)
            else:
                text = "".join(e["content"] for e in ev)
            out[i] = (text, None)
            return
        r = http_post(base, path, body)
        if use_chat:
            out[i] = (r["choices"][0]["message"]["content"],
                      r["usage"]["completion_tokens"])
        else:
            out[i] = (r["content"], r["tokens_predicted"])

    t0 = time.perf_counter()
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(turns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts) or len(out) != len(turns):
        fail(f"HTTP chats: {len(out)} of {len(turns)} answered")
    return out, wall


def replay(name, qp, cfg, dev, trace, counters, captured):
    """A new ``Server(qp, cfg, n_slots=8, eos_id=Q_EOS)`` fed the ids of
    an Engine's ``admissions`` at the same steps (so it admits and
    decodes as that run did), eagerly or replaying CUDA graphs, every
    counter set to 0 just before and read just after.  Returns (server,
    {engine request id: tokens}, launches, wall seconds, the chunk
    lengths)."""
    from quant_gemm_tpu_torch.models import serve

    with graphs(captured):
        srv = serve.Server(qp, cfg, n_slots=8, eos_id=Q_EOS, device=dev)
        seen = []
        chunk = srv._chunk

        def counted(tokens, t, cache, *rest, **kw):
            seen.append(t)
            return chunk(tokens, t, cache, *rest, **kw)

        srv._chunk = counted
        pending = sorted(trace, key=lambda e: (e[0], e[1]))
        rids, step = {}, 0
        zero(counters)
        t0 = time.perf_counter()
        while pending or srv.queue or any(srv.slots):
            if not (srv.queue or any(srv.slots)) and pending[0][0] != step:
                fail(f"{name}: the replay is idle before step "
                     f"{pending[0][0]}")
            while pending and pending[0][0] == step:
                _, rid, prompt = pending.pop(0)
                rids[srv.submit(prompt, max_new=Q_NEW)] = rid
            srv.step()
            step += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = served_launches(srv, counters)
    del srv._chunk  # unwrapped: nothing but the caller holds the Server
    results = {rids[r]: req.generated for r, req in srv.finished.items()}
    return srv, results, launches, wall, seen


def qwen_http_run(label, qp, cfg, dev, tok, md, turns, counters):
    """Serve ``turns`` over HTTP (an Engine over the Server's defaults),
    then the same admissions straight into the Server, eagerly and
    captured: every HTTP transcript equals both; launches checked against
    the route rules; the captured pair's graphs, medians and profiler
    windows.  Then (Q4_0) a JSON-grammar request, an ``n_probs: 5``
    request and ``/v1/embeddings`` of 4 inputs (checked afterwards by
    ``check_qwen_extras``).  Returns (the eager replay's launches, the
    Engine's admissions, what the extra requests answered, the
    transcripts by engine request id)."""
    from quant_gemm_tpu_torch.models import serve
    from quant_gemm_tpu_torch.models.tokenizer import (encode_with_specials,
                                                       render_chat)
    from quant_gemm_tpu_torch.scripts import server as http

    try:
        import jinja2  # noqa: F401
        use_chat = True
    except ImportError:
        use_chat = False
        print(f"  {label}: jinja2 does not import on this machine: the chat "
              "turns go to /completion as the ChatML text the template "
              "renders", flush=True)
    want_ids = []
    for t in turns:
        if use_chat:
            text = render_chat(md, t)
            if text != chatml(t):
                fail(f"{label}: render_chat differs from ChatML")
            want_ids.append(encode_with_specials(tok, text))
        else:
            want_ids.append(tok.encode(chatml(t)))
    server = serve.Server(qp, cfg, n_slots=8, eos_id=tok.eos_id, device=dev)
    trace = admissions(server)
    engine = http.Engine(server, tok, md)
    extra = {}
    with http_server(engine) as base:
        import urllib.request

        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail(f"{label}: /health is not ok")
        answers, wall = http_chats(base, turns, use_chat)
        trace = list(trace)
        st = engine.server.stats()
        if label.startswith("Q4_0"):
            extra = qwen_extras(base, engine, qp, cfg, dev, tok)
    # the Server's 8.4 GB of cache goes before the replays' (its wrapped
    # methods unwrapped first, so that nothing holds it)
    del server.submit, server.step
    del engine, server
    release()
    print(f"  {label} over HTTP: {len(turns)} concurrent chat requests "
          f"({'/v1/chat/completions' if use_chat else '/completion'}, "
          f"request 0 streamed), prompts of "
          f"{min(map(len, want_ids))}-{max(map(len, want_ids))} tokens, "
          f"{st['prefill_tokens']} prefilled and "
          f"{st['cached_prompt_tokens']} reused, {st['generated_tokens']} "
          f"generated in {st['decode_steps']} decode steps, {wall:.2f} s "
          f"wall; engine graphs {st['graphs']}, mean decode step "
          f"{1e3 * st['decode_seconds'] / st['decode_steps']:.3f} ms",
          flush=True)
    by_prompt = {tuple(p): (s_, rid) for s_, rid, p in trace}
    rid_of = []
    for i, ids in enumerate(want_ids):
        hit = by_prompt.get(tuple(ids))
        if hit is None:
            fail(f"{label}: request {i}'s ids differ from the server's")
        rid_of.append(hit[1])
    runs = {}
    for captured in (False, True):
        runs[captured] = replay(f"{label} replay", qp, cfg, dev, trace,
                                counters, captured)
    srv, results, launches, wall_e, seen = runs[False]
    for i, (text, n) in answers.items():
        ids = results[rid_of[i]]
        if text != tok.decode(ids) or (n is not None and n != len(ids)):
            fail(f"{label}: HTTP request {i} answered {n} tokens {text!r}, "
                 f"the Server {len(ids)}: {tok.decode(ids)!r}")
    print(f"  {label}: all {len(answers)} HTTP transcripts (the streamed "
          "one's deltas joined) equal the Server driven with the same "
          "admissions, eager and captured", flush=True)
    steps = srv.stats()["decode_steps"]
    # every admission prefills at least its last prompt token: one head
    want = route_launches(qp, steps, seen, len(trace), False,
                          FILE_MIXES[label.split()[0]]["k2"])
    check_launches(f"{label} replay", launches, want)
    per = {k: v // steps for k, v in want.items()
           if k in ("norm_qkv", "gemm_exact", "gemm_exact_k16",
                    "flash_decode")}
    print(f"    launches {json.dumps(launches)}; per decode step "
          f"{json.dumps(per)}; {len(seen)} prefill chunks "
          f"({sum(t >= 64 for t in seen)} of 64 tokens or more)", flush=True)
    captured_pair(f"{label} Server", runs[False][:4], runs[True][:4],
                  chunk_window=True)
    return launches, trace, extra, results


def qwen_extras(base, engine, qp, cfg, dev, tok):
    """The JSON-grammar request (4 new tokens, its seconds a step), the
    ``n_probs: 5`` request (ids and top ids equal a fresh Server's), and
    ``/v1/embeddings`` of 4 inputs (each equal to ``llama.embed`` on the
    engine thread's inputs, run here after the server stops)."""
    from quant_gemm_tpu_torch.models.grammar import JSON_GBNF

    out = {}
    prompt = " the reply is a json object with two keys"
    t0 = time.perf_counter()
    r = http_post(base, "/completion", {"prompt": prompt, "n_predict": 4,
                                        "grammar": JSON_GBNF,
                                        "cache_prompt": False})
    dt = time.perf_counter() - t0
    n = r["tokens_predicted"]
    if not (1 <= n <= 4 and r["content"].startswith("{")):
        fail(f"JSON grammar request: {n} tokens {r['content']!r}")
    print(f"  JSON grammar request: {n} tokens {r['content']!r} in "
          f"{dt:.2f} s over HTTP ({dt / n:.2f} s a token; the grammar "
          f"filter walks all {Q_VOCAB} ids on the host)", flush=True)
    out["grammar"] = (prompt, r["content"], n, dt)
    prompt = " one two three four five"
    r = http_post(base, "/completion", {"prompt": prompt, "n_predict": 4,
                                        "n_probs": 5, "cache_prompt": False})
    probs = r["completion_probabilities"]
    if len(probs) != 4 or any(
            len(p["probs"]) != 5 or p["id"] != p["probs"][0]["id"]
            or [e["logprob"] for e in p["probs"]]
            != sorted((e["logprob"] for e in p["probs"]), reverse=True)
            or p["probs"][0]["logprob"] > 1e-6 for p in probs):
        fail(f"n_probs request: malformed {probs}")
    out["n_probs"] = (prompt, [p["id"] for p in probs],
                      [[e["id"] for e in p["probs"]] for p in probs])
    inputs = ["hello world", "the quick brown fox", "a json object",
              "one two three"]
    r = http_post(base, "/v1/embeddings", {"input": inputs})
    vecs = [d["embedding"] for d in r["data"]]
    if len(vecs) != 4 or any(len(v) != Q_DIM for v in vecs):
        fail(f"/v1/embeddings: {len(vecs)} vectors")
    out["embed"] = (inputs, vecs)
    print(f"  n_probs request: ids {out['n_probs'][1]}, top-5 ids of the "
          f"first token {out['n_probs'][2][0]}; /v1/embeddings: 4 vectors "
          f"of {Q_DIM}, {r['usage']['prompt_tokens']} prompt tokens",
          flush=True)
    return out


def check_qwen_extras(extra, qp, cfg, dev, tok):
    """The n_probs request's tokens and top-5 ids against a fresh Server
    (eager), the embeddings against ``llama.embed`` here, the grammar
    request's tokens against a fresh Server's."""
    from quant_gemm_tpu_torch.models import llama, serve
    from quant_gemm_tpu_torch.models.grammar import JSON_GBNF, GrammarSampler

    with graphs(False):
        srv = serve.Server(qp, cfg, n_slots=8, eos_id=tok.eos_id, device=dev)
        prompt, ids, tops = extra["n_probs"]
        rid = srv.submit(tok.encode(prompt), max_new=4, n_probs=5)
        prompt_g, text_g, n_g, _ = extra["grammar"]
        gid = srv.submit(tok.encode(prompt_g), max_new=4,
                         grammar=GrammarSampler(JSON_GBNF, tok))
        srv.run_until_done()
    r = srv.finished[rid]
    if r.generated != ids or [[t for t, _ in p] for p in r.probs] != tops:
        fail(f"n_probs: the Server gives {r.generated} / "
             f"{[[t for t, _ in p] for p in r.probs]}, HTTP {ids} / {tops}")
    g = srv.finished[gid]
    if tok.decode(g.generated) != text_g or len(g.generated) != n_g:
        fail(f"grammar: the Server gives {tok.decode(g.generated)!r}, HTTP "
             f"{text_g!r}")
    inputs, vecs = extra["embed"]
    for text, v in zip(inputs, vecs):
        ids = tok.encode(text)
        width = max(-(-len(ids) // 16) * 16, 16)
        want = llama.embed(qp, cfg, torch.tensor(
            [ids + [0] * (width - len(ids))], device=dev),
            lengths=torch.tensor([len(ids)], device=dev))[0]
        got = torch.tensor(v, device=dev)
        if not (torch.isfinite(got).all()
                and abs(float(got.norm()) - 1.0) < 1e-3
                and torch.equal(got, want)):
            fail(f"embedding of {text!r} differs from llama.embed "
                 f"(max|d| {float((got - want).abs().max()):.3e})")
    print("  n_probs (tokens, top-5 ids), grammar (tokens) and the 4 "
          "embeddings equal the Server / llama.embed driven directly",
          flush=True)


def qwen_path(dev, counters):
    """Slice 14: the GGUF user path at Qwen2.5-1.5B width.  For each of
    ``QWEN_MIXES``: write the file (tokenizer embedded), load it, check
    its structure, serve chat traffic over HTTP against the Server driven
    directly (eager and captured), the kernels against plain versions
    layer by layer; Q4_0 also the grammar, n_probs and embeddings
    requests, IQ4_XS again with FUSED_DECODE (K6's iq4_xs form; its
    transcripts equal the default run's).  Returns each run's launches."""
    from quant_gemm_tpu_torch.models import gguf_loader, llama
    from quant_gemm_tpu_torch.models.tokenizer import tokenizer_from_gguf

    t0 = time.perf_counter()
    vocab_md = qwen_vocab()
    tok = tokenizer_from_gguf(vocab_md)
    turns = qwen_traffic(tok)
    print(f"Qwen path: a byte-level BPE vocabulary of {Q_VOCAB} entries "
          f"({len(vocab_md['tokenizer.ggml.merges'])} merges, pre qwen2) "
          f"and 16 chat turns made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    by_run, rng = {}, np.random.default_rng(14)
    for seed, mix in enumerate(QWEN_MIXES):
        held = torch.cuda.memory_allocated()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / f"qwen2.5-1.5b-{mix.lower()}-random.gguf"
            t0 = time.perf_counter()
            write_qwen_gguf(path, mix, dev, vocab_md, seed=20 + seed)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            from quant_gemm_tpu_torch.formats.gguf_file import GGUFFile

            with GGUFFile(path) as gf:
                qp, cfg = gguf_loader.load_llama(gf, device=dev)
                md = gf.metadata
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            size = path.stat().st_size
        on_card = device_bytes(qp)
        print(f"{mix} Qwen file: {size} bytes of GGUF written in "
              f"{t_write:.1f} s, loaded onto the card in {t_load:.1f} s, "
              f"{on_card} bytes on the card ({on_card / size:.3f} x the "
              f"file; {held} bytes allocated before it)", flush=True)
        if cfg != qwen_cfg():
            fail(f"{mix}: config from the file's metadata differs: {cfg}")
        check_qwen_structure(mix, qp)
        mtok = tokenizer_from_gguf(md)
        if mtok.tokens != tok.tokens or mtok.eos_id != Q_EOS:
            fail(f"{mix}: the file's tokenizer differs from the one written")
        label = f"{mix} Qwen"
        n = 16 if mix == "Q4_0" else 8
        launches, trace, extra, default = qwen_http_run(
            label, qp, cfg, dev, tok, md, turns[:n], counters)
        by_run[label] = launches
        if extra:
            check_qwen_extras(extra, qp, cfg, dev, tok)
        release()
        # the layer checks on caches of 1024 rows (7.5 GB at the file's
        # 32768 for 8 slots, and each check clones its cache)
        short = cfg._replace(max_seq=1024)
        toks = torch.as_tensor(rng.integers(0, Q_VOCAB, (1, 128)), device=dev)
        cache = llama.KVCache.init(short, 1, device=dev)
        report_cases([(f"{label} chunk 128 at pos0 0",
                       check(qp, short, toks, cache)),
                      (f"{label} decode step",
                       decode_case(qp, short, rng, dev))])
        del cache
        release()
        if mix == "IQ4_XS":
            run = f"{label} FUSED_DECODE"
            with switches(fused=True):
                srv_f, res_f, fused, _, seen = replay(
                    run, qp, cfg, dev, trace, counters, True)
            if res_f != default:
                fail(f"{run}: the transcripts differ from the default run's")
            steps = srv_f.stats()["decode_steps"]
            want = route_launches(qp, steps, seen, len(trace), True, False)
            check_launches(run, fused, want)
            print(f"    {run}: per decode step K6 "
                  f"{want['gemm_exact_fused'] // steps} (iq4_xs), K1 "
                  f"{want['gemm_exact'] // steps} (q5_k), K7 "
                  f"{want['gemm_exact_k16'] // steps}; all {len(res_f)} "
                  "transcripts equal the default run's", flush=True)
            by_run[run] = fused
            del srv_f
        del qp
        release()
    return by_run


def slice14_kernel_rows(dev, timer, record, unfused, randn):
    """Slice 14 at Qwen2.5-1.5B's shapes: the iq4_xs form of K1 (M = 8,
    bit for bit ``k1_order``), K4 (M = 128, bf16 operand, two calls
    bit-equal, beside ``torch.matmul``) and K6 (M = 8, bit for bit
    quantize_q8_1 + K1, with degenerate blocks) at wq, wgu and w_down; q4_0
    K1 at wo, wgu, w_down, K2 at wqkv (N 2048), K4 at the four GEMMs; K7
    q6_K at the tied head (N 151936: bit for bit ``k1_order``, two calls
    equal); K3 at B 8, KV 2, rep 6, hd 128 (context 512, and ragged
    contexts up to 1000 with the Server's ``s_hi``); K5 at rep 6 (T 128
    at pos0 0 and 384, a ragged T 80 at pos0 200).  iq4_xs weights count
    the file's 136 bytes per 256 in bound_ms, the port's layout (q8_0's
    with f32 scales) beside."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0, quantize_q8_1
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        gemm_dequant, gemm_dequant_plain)
    from quant_gemm_tpu_torch.kernels.gemm_exact import (
        gemm_exact, gemm_exact_fused, gemm_exact_fused_plain,
        gemm_exact_plain, k1_order)
    from quant_gemm_tpu_torch.kernels.gemm_exact_k16 import (
        gemm_exact_k16, gemm_exact_k16_plain, k16_block_terms)
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import (
        norm_qkv, norm_qkv_plain)
    from quant_gemm_tpu_torch.kernels.registry import fold_q8_1
    from quant_gemm_tpu_torch.ops.attention import (
        decode_s_hi, flash_decode, flash_decode_plain, flash_prefill,
        flash_prefill_plain)

    g = torch.Generator(device=dev).manual_seed(1414)
    shapes = {"wqkv": ((Q_HEADS + 2 * Q_KV) * Q_HD, Q_DIM),
              "wq, wo": (Q_DIM, Q_DIM), "wgu": (2 * Q_D_FF, Q_DIM),
              "w_down": (Q_DIM, Q_D_FF)}

    def iq4_xs(n, k):
        return layout.prepare(kquants.from_bytes_iq4_xs(
            kquants.random_iq4("iq4_xs", n, k, k ** -0.5, g)))

    def iq4_bytes(n, k):  # the file's, and the port layout's
        return n * k // 256 * 136, n * k + n * (k // 32) * 4

    m = 8
    xs = {name: iq4_xs(*shapes[name]) for name in ("wq, wo", "wgu",
                                                   "w_down")}
    for name, w in xs.items():
        a = quantize_q8_1(randn(m, w.k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact iq4_xs {name}: max|err| {err} > {tol}")
        k1_bits(f"iq4_xs {name}", w, a, got)
        act = m * w.k + 2 * m * (w.k // 32) * 2 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        fb, lb = iq4_bytes(w.n, w.k)
        record("gemm_exact", f"iq4_xs Qwen {name} M={m} N={w.n} K={w.k}",
               err, f"max|err| <= {tol:.3e}, == k1_order bit for bit",
               timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(fb + act, ops, "int8"), None, main=False,
               layout_bnd=bound(lb + act, ops, "int8"))
    for name, w in xs.items():
        x = randn(m, w.k)
        odd = x.clone()
        odd[0, :32], odd[-1, 32:64], odd[m // 2, 64:96] = 0.0, 7e8, -7e8
        for xx in (odd, x):
            got = gemm_exact_fused(w, xx)
            want = gemm_exact(w, quantize_q8_1(xx))
            ref = gemm_exact_fused_plain(w, xx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K6 gemm_exact_fused iq4_xs {name}: differs from "
                     "quantize_q8_1 + K1")
            err = (got - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            if not err <= tol:
                fail(f"K6 gemm_exact_fused iq4_xs {name}: max|err| {err} > "
                     f"{tol}")
        act = m * w.k * 4 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        fb, lb = iq4_bytes(w.n, w.k)
        record("gemm_exact_fused", f"iq4_xs Qwen {name} M={m} N={w.n} "
               f"K={w.k}", err, f"== quantize_q8_1 + K1, max|err| <= "
               f"{tol:.3e}", timer(lambda: gemm_exact_fused(w, x)),
               timer(lambda: gemm_exact_fused_plain(w, x), reps=5),
               bound(fb + act, ops, "int8"), None, main=False,
               layout_bnd=bound(lb + act, ops, "int8"))
        a = quantize_q8_1(x)
        unfused("quantize_q8_1 + K1",
                timer(lambda: gemm_exact(w, quantize_q8_1(x))))
        unfused("the same codes", timer(lambda: gemm_exact(w, a)), "k1_ms")
    m = 128
    for name, w in xs.items():
        a = fold_q8_1(quantize_q8_1(randn(m, w.k)))
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        tol = 1e-5 * ref.abs().max().item()
        if not (e <= 1e-4 and err <= tol):
            fail(f"K4 gemm_dequant iq4_xs {name}: NMSE {e} > 1e-4 or "
                 f"max|err| {err} > {tol}")
        same_bits(f"K4 gemm_dequant iq4_xs {name}", got,
                  lambda: gemm_dequant(w, a))
        wb = layout.dequantize(w, torch.bfloat16)
        act = m * w.k * 2 + m * w.n * 4
        ops = 2 * m * w.n * w.k
        fb, lb = iq4_bytes(w.n, w.k)
        record("gemm_dequant", f"iq4_xs Qwen {name} M={m} N={w.n} K={w.k}",
               err, f"NMSE {e:.3e} <= 1e-4, max|err| <= {tol:.3e}",
               timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(fb + act, ops, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)), main=False,
               layout_bnd=bound(lb + act, ops, "bf16"))
    del xs, wb

    # the Q4_0 file's GEMMs
    def q4(n, k):
        return layout.prepare(quantize_q4_0(randn(n, k, scale=k ** -0.5)))

    q4w = {name: q4(*shape) for name, shape in shapes.items()}
    m = 8
    for name in ("wq, wo", "wgu", "w_down"):
        w = q4w[name]
        a = quantize_q8_1(randn(m, w.k))
        got, ref = gemm_exact(w, a), gemm_exact_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        if not err <= tol:
            fail(f"K1 gemm_exact q4_0 Qwen {name}: max|err| {err} > {tol}")
        k1_bits(f"q4_0 Qwen {name}", w, a, got)
        nbytes = q4_bytes(w.n, w.k) + m * w.k + 2 * m * (w.k // 32) * 2 \
            + m * w.n * 4
        record("gemm_exact", f"q4_0 Qwen {name} M={m} N={w.n} K={w.k}", err,
               f"max|err| <= {tol:.3e}, == k1_order bit for bit",
               timer(lambda: gemm_exact(w, a)),
               timer(lambda: gemm_exact_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "int8"), None, main=False)
    w = q4w["wqkv"]
    x = randn(m, w.k, scale=3.0)
    nw = 1.0 + 0.1 * randn(w.k)
    got, ref = norm_qkv(w, x, nw, Q_EPS), norm_qkv_plain(w, x, nw, Q_EPS)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 2e-3 * ref.abs().max().item()
    if not err <= tol:
        fail(f"K2 norm_qkv q4_0 Qwen wqkv: max|err| {err} > {tol}")
    k2_bits("q4_0 Qwen wqkv", w, dev)
    nbytes = q4_bytes(w.n, w.k) + m * w.k * 4 + w.k * 4 + m * w.n * 4
    record("norm_qkv", f"q4_0 Qwen wqkv M={m} N={w.n} K={w.k}", err,
           f"max|err| <= {tol:.3e}, == quantize_q8_1 + K1 on exact rows",
           timer(lambda: norm_qkv(w, x, nw, Q_EPS)),
           timer(lambda: norm_qkv_plain(w, x, nw, Q_EPS), reps=5),
           bound(nbytes, 2 * m * w.n * w.k, "int8"), None, main=False)
    m = 128
    for name, w in q4w.items():
        a = fold_q8_1(quantize_q8_1(randn(m, w.k)))
        got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        e = nmse(got, ref)
        if not e <= 1e-4:
            fail(f"K4 gemm_dequant q4_0 Qwen {name}: NMSE {e} > 1e-4")
        same_bits(f"K4 gemm_dequant q4_0 Qwen {name}", got,
                  lambda: gemm_dequant(w, a))
        wb = layout.dequantize(w, torch.bfloat16)
        nbytes = q4_bytes(w.n, w.k) + m * w.k * 2 + m * w.n * 4
        record("gemm_dequant", f"q4_0 Qwen {name} M={m} N={w.n} K={w.k}",
               err, f"NMSE {e:.3e} <= 1e-4",
               timer(lambda: gemm_dequant(w, a)),
               timer(lambda: gemm_dequant_plain(w, a), reps=5),
               bound(nbytes, 2 * m * w.n * w.k, "bf16"),
               timer(lambda: torch.matmul(a, wb.T)), main=False)
    del q4w, wb

    # K7: the tied q6_K head, N 151936 (a multiple of 128, not of 256)
    m, n, k = 8, Q_VOCAB, Q_DIM
    w = layout.prepare_k16(kquants.random_blocks("q6_K", n, k, 0.02, g))
    a = quantize_q8_1(randn(m, k))
    got, ref = gemm_exact_k16(w, a), gemm_exact_k16_plain(w, a)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()
    if not err <= tol:
        fail(f"K7 gemm_exact_k16 q6_K Qwen head: max|err| {err} > {tol}")
    if not torch.equal(got, k1_order(k16_block_terms(w, a))):
        fail("K7 gemm_exact_k16 q6_K Qwen head: differs from k1_order of "
             "its block terms")
    same_bits("K7 gemm_exact_k16 q6_K Qwen head", got,
              lambda: gemm_exact_k16(w, a))
    act = m * k + m * (k // 32) * 2 + m * n * 4
    record("gemm_exact_k16", f"q6_K Qwen tied head M={m} N={n} K={k}", err,
           f"max|err| <= {tol:.3e}, == k1_order bit for bit, two calls "
           "bit-equal", timer(lambda: gemm_exact_k16(w, a)),
           timer(lambda: gemm_exact_k16_plain(w, a), reps=5),
           bound(kq_bytes("q6_K", n, k) + act, 2 * m * n * k, "int8"),
           None, main=False,
           layout_bnd=bound(k16_layout_bytes(w) + act, 2 * m * n * k,
                            "int8"))
    del w

    # K3 / K5 at KV 2, rep 6, hd 128 (16 query rows a block: 10 padded)
    b, s, nl, layer = 8, 2048, 4, 2
    shape = (nl, b, Q_KV, s, Q_HD)
    kc = randn(*shape).to(torch.bfloat16)
    vc = randn(*shape).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    span = torch.arange(s, device=dev)
    q = randn(b, Q_KV, Q_REP, Q_HD)
    kcur = randn(b, Q_KV, 1, Q_HD).to(torch.bfloat16)
    vcur = randn(b, Q_KV, 1, Q_HD).to(torch.bfloat16)
    for label, ctxs in (("ctx 512", [512] * b),
                        ("ragged ctx", [900, 17, 512, 300, 64, 1000, 5,
                                        777])):
        pos = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        s_hi = decode_s_hi(max(ctxs))
        kw = dict(k_current=kcur, v_current=vcur, layer=layer, s_hi=s_hi)
        got = flash_decode(q, kc, vc, pos, **kw)
        ns = flash_decode.last_pieces
        ref = flash_decode_plain(q, kc, vc, pos, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K3 flash_decode Qwen {label}: max|err| {err} > 2e-3")
        same_bits(f"K3 flash_decode Qwen {label}", got,
                  lambda: flash_decode(q, kc, vc, pos, **kw))
        seen = sum(ctxs)
        nbytes = 2 * Q_KV * seen * Q_HD * 2 + 2 * b * Q_KV * Q_HD * 2 \
            + 2 * b * Q_HEADS * Q_HD * 4 + b * 4
        ops = 4 * Q_HEADS * Q_HD * (seen + b)
        kl, vl = kc[layer].clone(), vc[layer].clone()
        bidx = torch.arange(b, device=dev)
        kl[bidx, :, pos.long()] = kcur[:, :, 0]
        vl[bidx, :, pos.long()] = vcur[:, :, 0]
        qh = q.reshape(b, Q_HEADS, 1, Q_HD).to(torch.bfloat16)
        mask = (span[None, :] <= pos[:, None].long())[:, None, None, :]
        lib = sdpa(qh, kl, vl, attn_mask=mask, enable_gqa=True)
        lib_err = (lib.float().reshape(got.shape) - ref).abs().max().item()
        if not lib_err <= 2e-2:
            fail(f"K3 yardstick SDPA disagrees: {lib_err}")
        record("flash_decode", f"bf16 Qwen {label} B={b} KV={Q_KV} "
               f"rep={Q_REP} hd={Q_HD} S={s} s_hi={s_hi} ns={ns}", err,
               "max|err| <= 2e-3, two calls bit-equal",
               timer(lambda: flash_decode(q, kc, vc, pos, **kw)),
               timer(lambda: flash_decode_plain(q, kc, vc, pos, **kw),
                     reps=5),
               bound(nbytes, ops, "bf16"),
               timer(lambda: sdpa(qh, kl, vl, attn_mask=mask,
                                  enable_gqa=True)), main=False)
    slot = 3
    view = slice(slot, slot + 1)
    k1v, v1v = kc[:, view], vc[:, view]
    for t5, p0 in ((128, 0), (128, 384), (80, 200)):
        q5 = randn(1, Q_KV, t5 * Q_REP, Q_HD)
        kw = dict(rep=Q_REP, layer=layer)
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        got = flash_prefill(q5, k1v, v1v, pos0, **kw)
        ref = flash_prefill_plain(q5, k1v, v1v, pos0, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= 2e-3:
            fail(f"K5 flash_prefill Qwen T={t5} pos0={p0}: max|err| {err} "
                 "> 2e-3")
        same_bits(f"K5 flash_prefill Qwen T={t5} pos0={p0}", got,
                  lambda: flash_prefill(q5, k1v, v1v, pos0, **kw))
        qpos = p0 + np.arange(t5)
        nbytes = 2 * q5.numel() * 4 + 4 + 2 * Q_KV * (p0 + t5) * Q_HD * 2
        ops = 4 * Q_HEADS * Q_HD * int((qpos + 1).sum())
        qh = (q5.reshape(1, Q_KV, t5, Q_REP, Q_HD).transpose(2, 3)
              .reshape(1, Q_HEADS, t5, Q_HD).to(torch.bfloat16))
        kl, vl = k1v[layer], v1v[layer]
        keep = span[None, :] <= torch.as_tensor(qpos, device=dev)[:, None]
        lib = sdpa(qh, kl, vl, attn_mask=keep, enable_gqa=True)
        lib = (lib.float().reshape(1, Q_KV, Q_REP, t5, Q_HD)
               .transpose(2, 3).reshape(got.shape))
        lib_err = (lib - ref).abs().max().item()
        if not lib_err <= 2e-2:
            fail(f"K5 yardstick SDPA disagrees: {lib_err}")
        record("flash_prefill", f"bf16 Qwen B=1 KV={Q_KV} rep={Q_REP} "
               f"hd={Q_HD} S={s} T={t5} pos0={p0}", err, "max|err| <= 2e-3, "
               "two calls bit-equal",
               timer(lambda: flash_prefill(q5, k1v, v1v, pos0, **kw)),
               timer(lambda: flash_prefill_plain(q5, k1v, v1v, pos0, **kw),
                     reps=5),
               bound(nbytes, ops, "bf16"),
               timer(lambda: sdpa(qh, kl, vl, attn_mask=keep,
                                  enable_gqa=True)), main=False)


# -- slice 15: the rest of the serving surface ------------------------------

RUN_A16P = "W4A16 prefill_a16"
RUN_A16 = "W4A16 act_mode=bf16"
RUN_WD = "w_down_a16"
RUN_WDT = "w_down_a16+ENABLE_TAIL"
RUN_LORA = "LoRA TinyLlama"
RUN_SPEC_D = "speculative, TinyLlama draft"
RUN_SPEC_S = "speculative, self draft"
RUN_PPL = "perplexity {}"
RUN_HF = "HF Llama-3.2-1B (4 layers)"
SPEC_K, SPEC_B, SPEC_NEW = 4, 4, 64
LORA_RANK, LORA_ALPHA = 16, 32.0
# Llama-3.2-1B (huggingface.co/meta-llama/Llama-3.2-1B config.json):
# hidden 2048, intermediate 8192, 16 layers (4 written here), 32 / 8 heads
# of 64, vocab 128256, rope_theta 500000, rms_norm_eps 1e-5, tied
# embeddings, llama3 rope_scaling (factor 32, low 1, high 4, original
# 8192), max_position_embeddings 131072 (served at 4096)
HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
             "hidden_size": 2048, "intermediate_size": 8192,
             "num_hidden_layers": 4, "num_attention_heads": 32,
             "num_key_value_heads": 8, "head_dim": 64,
             "max_position_embeddings": 131072, "rope_theta": 500000.0,
             "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
             "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                              "low_freq_factor": 1.0,
                              "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 8192}}
HF_MAX_SEQ = 4096


def launches_now(counters, graphs=None):
    """Every counter as it stands, plus a ``serve.Graphs``' replays."""
    extra = graphs.replay_launches() if graphs is not None else {}
    return {k: getattr(fn, attr) + extra.get(k, 0)
            for k, (fn, attr) in counters.items()}


def slice15_kernel_rows(dev, timer, record, randn):
    """K4 on bf16 activations at decode shapes (the W4A16 route: M 1 and
    8) at TinyLlama's five GEMMs, against its plain version (NMSE <=
    1e-4, two calls bit-equal), beside ``torch.matmul`` in bf16 on the
    weight dequantized in advance; bound: the weight's bytes (and the
    activation's and output's) over the HBM rate."""
    from quant_gemm_tpu_torch.harness.profiling import bound
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import (
        gemm_dequant, gemm_dequant_plain)

    shapes = {"wqkv": (HEADS * HD + 2 * KV_HEADS * HD, DIM),
              "wo": (DIM, DIM), "wgu": (2 * D_FF, DIM),
              "w_down": (DIM, D_FF), "lm_head": (VOCAB, DIM)}
    for name, (n, k) in shapes.items():
        w = layout.prepare(quantize_q4_0(randn(n, k, scale=k ** -0.5)))
        wb = layout.dequantize(w, torch.bfloat16)
        for m in (1, 8):
            a = randn(m, k).to(torch.bfloat16)
            got, ref = gemm_dequant(w, a), gemm_dequant_plain(w, a)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            e = nmse(got, ref)
            if not e <= 1e-4:
                fail(f"K4 bf16 {name} M={m}: NMSE {e} > 1e-4")
            same_bits(f"K4 bf16 {name} M={m}", got,
                      lambda: gemm_dequant(w, a))
            nbytes = q4_bytes(n, k) + m * k * 2 + m * n * 4
            record("gemm_dequant", f"W4A16 decode {name} M={m} N={n} K={k}",
                   err, f"NMSE {e:.3e} <= 1e-4",
                   timer(lambda: gemm_dequant(w, a)),
                   timer(lambda: gemm_dequant_plain(w, a), reps=5),
                   bound(nbytes, 2 * m * n * k, "bf16"),
                   timer(lambda: torch.matmul(a, wb.T)), main=False)
        del wb


def a16_path(dev, counters, prompts, reuse, qp, cfg):
    """W4A16 at TinyLlama width: ``Server(prefill_a16=True)``,
    ``Server(act_mode="bf16")`` and ``w_down_a16`` (again with
    ENABLE_TAIL: K8 serves w_down), each eager and captured on the first 8
    requests; launches against the routes; kernels against plain
    versions layer by layer in each mode."""
    from quant_gemm_tpu_torch.models import llama

    prompts, reuse = prompts[:8], reuse[:8]
    n_chunks, n_heads = chunks(prompts, reuse), heads(prompts, reuse)
    L = LAYERS
    k5 = L * sum(t >= 64 for t in n_chunks)
    # the chunks' K4 calls: four a layer, and the head in a prompt's last
    k4 = len(n_chunks) * 4 * L + n_heads
    zeros = {"gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0,
             "k16_dequant_gemm": 0}
    cfg_wd = cfg._replace(w_down_a16=True)
    runs = [
        # decode as the default server; chunks on bf16 activations: K4
        # with no quantize-fold
        (RUN_A16P, cfg, dict(prefill_a16=True), False, lambda s: {
            "gemm_exact": s * (3 * L + 1), "norm_qkv": s * L,
            "flash_decode": s * L, "quantize_q8_1": s * (3 * L + 1),
            "gemm_dequant": k4, "quantize_fold_q8_1": 0}),
        # every GEMM of a decode step on K4 too; K2 off
        (RUN_A16, cfg, dict(act_mode="bf16"), False, lambda s: {
            "gemm_exact": 0, "norm_qkv": 0, "flash_decode": s * L,
            "quantize_q8_1": 0, "quantize_fold_q8_1": 0,
            "gemm_dequant": k4 + s * (4 * L + 1)}),
        # w_down on K4 (bf16) at decode and in the chunks
        (RUN_WD, cfg_wd, {}, False, lambda s: {
            "gemm_exact": s * (2 * L + 1), "norm_qkv": s * L,
            "flash_decode": s * L, "quantize_q8_1": s * (2 * L + 1),
            "gemm_dequant": k4 + s * L,
            "quantize_fold_q8_1": k4 - len(n_chunks) * L}),
        # K8 takes wo to the second residual at decode: w_down_a16 only
        # reaches the chunks
        (RUN_WDT, cfg_wd, {}, True, lambda s: {
            "attn_tail": s * L, "gemm_exact": s, "norm_qkv": s * L,
            "flash_decode": s * L, "quantize_q8_1": s,
            "gemm_dequant": k4,
            "quantize_fold_q8_1": k4 - len(n_chunks) * L}),
    ]
    by_run = {}
    for name, c, kw, tail, want in runs:
        with switches(fused=False, tail=tail):
            launches, st, _ = serve_traffic(
                f"{name}: Server(qp, cfg, n_slots=8"
                f"{''.join(f', {k}={v!r}' for k, v in kw.items())})", qp, c,
                dev, prompts, reuse, counters, **kw)
            rule = {**zeros, "flash_prefill": k5,
                    **want(st["decode_steps"])}
            check_launches(name, launches, rule)
            by_run[name] = launches
    print(f"    W4A16 per decode step: prefill_a16 as the default (K2 {L}, "
          f"K1 {3 * L + 1}); act_mode=bf16 K4 {4 * L + 1}, K2 0, K1 0, no "
          f"quantize; w_down_a16 K4 {L} + K1 {2 * L + 1}; with ENABLE_TAIL "
          f"K8 {L} and K4 0 at decode (K8 takes precedence)", flush=True)
    # the precedence bit for bit: one decode step from one cache, with and
    # without w_down_a16, under ENABLE_TAIL
    rng = np.random.default_rng(15)
    cache = llama.KVCache.init(cfg, 8, device=dev)
    llama.forward(qp, cfg, torch.as_tensor(rng.integers(0, VOCAB, (8, 40)),
                                           device=dev), cache)
    nt = torch.as_tensor(rng.integers(0, VOCAB, (8, 1)), device=dev)
    with switches(fused=False, tail=True):
        a, b = (llama.forward(qp, c, nt, cache.clone())[0]
                for c in (cfg, cfg_wd))
    if not torch.equal(a, b):
        fail("ENABLE_TAIL: w_down_a16 changed a decode step K8 serves")
    cases = []
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
    for label, c, mode in (("bf16 mode", cfg, "bf16"),
                           ("w_down_a16", cfg_wd, "q8_1")):
        cases.append((f"{label} chunk 128 at pos0 0", check(
            qp, c, toks, llama.KVCache.init(c, 1, device=dev), mode)))
        cases.append((f"{label} decode step",
                      decode_case(qp, c, rng, dev, act_mode=mode)))
    report_cases(cases)
    return by_run


def lora_path(dev, counters, prompts, cfg):
    """A TinyLlama-width q4_0 GGUF (tokenizer embedded) and an adapter
    GGUF from ``export_lora`` (rank 16, alpha 32, f16, attn_q/k/v,
    attn_output, ffn_gate/up/down of every layer), served through
    ``build_engine(lora_path=)``'s Server eagerly and again captured, and
    once through ``generate.py --lora``; K2 and K8 off; kernels against
    plain versions layer by layer; the first step's logits against the
    deltas merged into the dequantized weights through
    ``forward_float``."""
    import contextlib as ctx
    import io

    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.models import llama, lora, serve
    from quant_gemm_tpu_torch.scripts import generate
    from quant_gemm_tpu_torch.scripts.server import build_engine

    L = LAYERS
    g = torch.Generator(device=dev).manual_seed(15)
    parts = {"attn_q": (HEADS * HD, DIM), "attn_k": (KV_HEADS * HD, DIM),
             "attn_v": (KV_HEADS * HD, DIM), "attn_output": (DIM, DIM),
             "ffn_gate": (D_FF, DIM), "ffn_up": (D_FF, DIM),
             "ffn_down": (DIM, D_FF)}
    tensors = {f"blk.{i}.{p}.weight": (
        (torch.randn(LORA_RANK, k, generator=g, device=dev) * k ** -0.5
         ).half(),
        (torch.randn(n, LORA_RANK, generator=g, device=dev) * 0.02).half())
        for i in range(L) for p, (n, k) in parts.items()}
    specials = {"<|endoftext|>": VOCAB - 3, "<|im_start|>": VOCAB - 2,
                "<|im_end|>": VOCAB - 1}
    with tempfile.TemporaryDirectory() as tmp:
        model, adapter = Path(tmp) / "tinyllama-q4_0.gguf", Path(tmp) / "a.gguf"
        t0 = time.perf_counter()
        write_gguf_mix(model, "all Q4_0", dev, seed=15, extra_md=qwen_vocab(
            15, VOCAB, specials))
        lora.export_lora(adapter, LORA_ALPHA, tensors)
        print(f"LoRA path: a TinyLlama-width all-q4_0 GGUF "
              f"({model.stat().st_size} bytes) and a rank-{LORA_RANK} f16 "
              f"adapter ({adapter.stat().st_size} bytes, "
              f"{len(tensors)} pairs) written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        with graphs(False):
            engine = build_engine(model, n_slots=8, lora_path=adapter,
                                  device=dev)
            engine.shutdown()
            srv = engine.server
            ql = srv.qparams
            if not all(isinstance(ly[s], lora.LoraLinear)
                       for ly in ql["layers"]
                       for s in ("wqkv", "wo", "wgu", "w_down")):
                fail("LoRA: build_engine did not attach every layer's slots")
            # the same model without its deltas
            base = {**ql, "layers": [
                {k: (v.inner if isinstance(v, lora.LoraLinear) else v)
                 for k, v in ly.items()} for ly in ql["layers"]]}
            with switches(fused=False, tail=True):
                base_route = llama.routes(base, cfg, 8, 1)
                lora_route = llama.routes(ql, cfg, 8, 1)
            if base_route != (True, True) or lora_route != (False, False):
                fail(f"LoRA routes: base {base_route}, LoRA'd {lora_route}"
                     " (expected K2 and K8 on the base, off with LoRA)")
            results, launches, wall = drive(srv, prompts[:8], 32, counters)
        st = srv.stats()
        n_chunks = chunks(prompts[:8], [0] * 8)
        steps = st["decode_steps"]
        check_launches(RUN_LORA, launches, {
            "gemm_exact": steps * (4 * L + 1), "norm_qkv": 0,
            "attn_tail": 0, "flash_decode": steps * L,
            "gemm_dequant": len(n_chunks) * 4 * L + 8,
            "flash_prefill": L * sum(t >= 64 for t in n_chunks),
            "gemm_exact_fused": 0, "gemm_exact_k16": 0})
        print(f"  {RUN_LORA}: build_engine(lora_path=) Server, 8 requests, "
              f"{steps} decode steps in {wall:.2f} s (eager); per decode "
              f"step K1 {4 * L + 1} (wqkv too), K2 0, K8 0 (K2 and K8 on the"
              f" base with ENABLE_TAIL: {base_route}, LoRA'd: {lora_route})",
              flush=True)
        print(f"    launches: {json.dumps(launches)}", flush=True)
        with graphs(True):
            cap = serve.Server(ql, cfg, n_slots=8, eos_id=srv.eos_id,
                               device=dev)
            captured_pair(RUN_LORA, (srv, results, launches, wall),
                          (cap, *drive(cap, prompts[:8], 32, counters)))
            del cap
            # generate.py --lora on the same files: a one-slot Server's
            # tokens (CUDA graphs on, as the CLI runs)
            ids = prompts[0][:64]
            one = serve.Server(ql, cfg, n_slots=1, eos_id=srv.eos_id,
                               device=dev)
            rid = one.submit(ids, max_new=8)
            want = one.run_until_done()[rid]
            del one
            out = io.StringIO()
            with ctx.redirect_stdout(out), ctx.redirect_stderr(io.StringIO()):
                generate.main(["-m", str(model), "--ids",
                               ",".join(map(str, ids)), "-n", "8",
                               "--lora", str(adapter), "--device",
                               str(dev)])
            got = [int(t) for t in out.getvalue().strip().split(",")]
            if got != want:
                fail(f"generate.py --lora printed {got}, the Server {want}")
            print(f"  generate.py --lora: {got} (= a one-slot Server's)",
                  flush=True)
        del srv, engine
    rng = np.random.default_rng(16)
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
    report_cases([
        ("LoRA chunk 128 at pos0 0", check(
            ql, cfg, toks, llama.KVCache.init(cfg, 1, device=dev))),
        ("LoRA decode step", decode_case(ql, cfg, rng, dev))])
    # the merged float reference: the base dequantized, + scale B A merged
    scale = LORA_ALPHA / LORA_RANK

    def merged(w, with_lora):
        if not isinstance(w, lora.LoraLinear):
            return llama._FloatLinear(layout.dequantize(w))
        f = layout.dequantize(w.inner)
        for off, sc, d in (w.deltas if with_lora else ()):
            f[off:off + d.b.shape[0]] += sc * (d.b @ d.a)
        return llama._FloatLinear(f)

    def float_model(with_lora):
        return {"embed": ql["embed"].float(), "final_norm": ql["final_norm"],
                "lm_head": merged(ql["lm_head"], with_lora),
                "layers": [{k: (merged(v, with_lora) if k in (
                    "wqkv", "wo", "wgu", "w_down") else v)
                    for k, v in ly.items()} for ly in ql["layers"]]}

    def logits(qp, float_=False):
        cache = llama.KVCache.init(cfg, 1, device=dev)
        if float_:
            return llama.forward_float(qp, cfg, toks, cache)[0]
        return llama.forward(qp, cfg, toks, cache)[0]

    m = nmse(logits(ql), logits(float_model(True), True))
    m0 = nmse(logits(base), logits(float_model(False), True))
    moved = float((logits(ql) - logits(base)).abs().max())
    print(f"  LoRA against the merged float reference (forward_float, the "
          f"deltas merged into the dequantized weights, scale {scale}): "
          f"logits NMSE {m:.3e}; the base against its own float reference "
          f"{m0:.3e} (limit 1.3 x base + 1e-4); the adapter moves the "
          f"logits by up to {moved:.3f}", flush=True)
    if not m <= 1.3 * m0 + 1e-4 or not moved > 1e-3:
        fail("LoRA: the LoRA'd forward strays from its merged reference")
    del ql, base
    return {RUN_LORA: launches}


def spec_path(dev, counters):
    """Speculative decoding: target Mistral-7B-v0.1 width (linear cache),
    draft TinyLlama-1.1B width, both q4_0 built on the card; k = 4, B =
    4 prompts of one length drawn from 128-512, 64 new tokens, greedy:
    with the TinyLlama draft and with the target as its own draft.  Each
    transcript is the target's greedy decode under the near-tie rule;
    tokens per target call printed, the self draft's at least 0.9 (k +
    1); then one ``sample_decode`` against a Server's tokens, one seed."""
    from quant_gemm_tpu_torch.models import llama, serve, speculative

    k, b = SPEC_K, SPEC_B
    rng = np.random.default_rng(17)
    t0_len = int(rng.integers(128, 513))
    max_seq = -(-(t0_len + SPEC_NEW + k + 1) // 128) * 128
    cfg_t = mistral_cfg(ring=False, max_seq=max_seq)
    cfg_d = tinyllama_cfg()._replace(max_seq=max_seq)
    t0 = time.perf_counter()
    qp_t = llama.init_qparams(cfg_t, seed=0, device=dev)
    qp_d = llama.init_qparams(cfg_d, seed=1, device=dev)
    torch.cuda.synchronize()
    prompt = torch.as_tensor(rng.integers(0, VOCAB, (b, t0_len)), device=dev)
    ref, _ = llama.greedy_decode(qp_t, cfg_t, prompt, SPEC_NEW)
    ref = ref.tolist()
    print(f"speculative: target Mistral-7B-v0.1 width, draft TinyLlama-1.1B "
          f"width (q4_0, built on the card), B {b} prompts of {t0_len} "
          f"tokens, k {k}, {SPEC_NEW} new, max_seq {max_seq}; target greedy "
          f"reference in {time.perf_counter() - t0:.1f} s", flush=True)

    def near_tie(toks):
        """Teacher-force ``toks`` through the target's T = 1 steps: each
        token is the argmax or within 4e-2 x max|logits| of it."""
        cache = llama.KVCache.init(cfg_t, b, device=dev)
        logits, _ = llama.forward(qp_t, cfg_t, prompt, cache)
        worst, ties = 0.0, 0
        for s in range(SPEC_NEW):
            last = logits[:, -1]
            pick = torch.as_tensor([r[s] for r in toks], device=dev)
            slack = last.amax(-1) - last.gather(-1, pick[:, None])[:, 0]
            rel = slack / last.abs().amax(-1)
            worst = max(worst, float(rel.max()))
            ties += int((slack > 0).sum())
            if s + 1 < SPEC_NEW:
                logits, _ = llama.forward(qp_t, cfg_t, pick[:, None], cache)
        return worst, ties

    by_run = {}
    rates = {}
    for name, qd, cd in ((RUN_SPEC_D, qp_d, cfg_d), (RUN_SPEC_S, qp_t,
                                                     cfg_t)):
        gr = serve.Graphs(dev)
        zero(counters)
        t1 = time.perf_counter()
        toks, rate = speculative.speculative_greedy_decode(
            qp_t, cfg_t, qd, cd, prompt, SPEC_NEW, k=k, graphs=gr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = launches_now(counters, gr)
        toks = toks.tolist()
        rounds = next(g.replays + 1 for key, g in gr.graphs.items()
                      if key[0] == "verify")
        ld, lt = cd.n_layers, cfg_t.n_layers
        steps = (k + 1) * rounds
        check_launches(name, launches, {
            "gemm_exact": steps * (3 * ld + 1), "norm_qkv": steps * ld,
            "flash_decode": steps * ld,
            "gemm_dequant": (rounds + 1) * (4 * lt + 1) + 4 * ld + 1,
            "flash_prefill": lt + ld, "gemm_exact_fused": 0,
            "attn_tail": 0, "gemm_exact_k16": 0, "k16_dequant_gemm": 0})
        same = sum(a == r for a, r in zip(toks, ref))
        worst, ties = (0.0, 0) if same == b else near_tie(toks)
        if worst > 4e-2:
            fail(f"{name}: a token is {worst:.3e} x max|logits| below the "
                 "target's argmax along its transcript")
        rates[name] = rate
        print(f"  {name}: {rate:.3f} tokens per target call ({rounds} "
              f"rounds, {steps} draft steps, {len(gr.graphs)} graphs), "
              f"{wall:.2f} s; {same} of {b} transcripts equal the target's "
              f"greedy decode, the rest within the near-tie rule (worst "
              f"{worst:.3e} x max|logits|, {ties} steps off the argmax)",
              flush=True)
        print(f"    launches: {json.dumps(launches)}", flush=True)
        by_run[name] = launches
    # every round the verify block's argmax leaves the draft's at a
    # near-tie ends early (K4 on the bf16 fold at M = B (k + 1) = 20, K1
    # in the draft's steps), so the self draft is held to 0.9 of the rate
    # a run of this length allows when every proposal is accepted
    best = speculative.best_rate(SPEC_NEW, k)
    print(f"  self draft: {rates[RUN_SPEC_S]:.3f} tokens per target call, "
          f"{rates[RUN_SPEC_S] / best:.3f} of the {best:.3f} that accepting "
          f"every proposal gives ({rates[RUN_SPEC_S] / (k + 1):.3f} of k + "
          "1)", flush=True)
    if rates[RUN_SPEC_S] < 0.9 * best:
        fail(f"self draft: {rates[RUN_SPEC_S]:.3f} tokens per target call "
             f"< 0.9 x {best:.3f}")
    del qp_t
    torch.cuda.empty_cache()
    # sample_decode against a one-slot Server, one seed (the Server's
    # chunk is the 128-token prompt itself)
    ids = rng.integers(0, VOCAB, 128).tolist()
    srv = serve.Server(qp_d, cfg_d, n_slots=1, device=dev)
    rid = srv.submit(ids, max_new=32, temperature=0.8, top_k=40, seed=7)
    want = srv.run_until_done()[rid]
    got, _ = llama.sample_decode(qp_d, cfg_d, [ids], 32, seed=[7],
                                 temperature=0.8, top_k=40)
    got = got[0].tolist()
    first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
    print(f"  sample_decode against a one-slot Server, seed 7, temperature "
          f"0.8, top-k 40: {'equal' if first is None else f'first differ at step {first}'}"
          f" ({got[:8]} ...)", flush=True)
    return by_run


def ppl_path(dev, counters, qp, cfg):
    """Perplexity at TinyLlama width through ``scripts/perplexity.py``'s
    ``report``: a seeded 4096-token stream, ctx 512, stride 256, q8_1 and
    bf16, the kernels against the plain versions to a relative 1e-3."""
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.scripts.perplexity import report

    stream = np.random.default_rng(18).integers(0, VOCAB, 4096)
    windows = 15  # starts 0, 256, ..., 3584
    by_run = {}
    for mode in ("q8_1", "bf16"):
        name = RUN_PPL.format(mode)
        zero(counters)
        t0 = time.perf_counter()
        got = report(qp, cfg, stream, ctx=512, stride=256, act_mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now(counters)
        plain = report(qp, cfg, stream, ctx=512, stride=256, act_mode=mode,
                       ops=registry.PLAIN)
        rel = abs(got["ppl"] - plain["ppl"]) / plain["ppl"]
        check_launches(name, launches, {
            "gemm_dequant": windows * (4 * LAYERS + 1),
            "flash_prefill": windows * LAYERS, "gemm_exact": 0,
            "norm_qkv": 0, "flash_decode": 0, "gemm_exact_k16": 0,
            "quantize_q8_1": 0, "quantize_fold_q8_1": (
                windows * (4 * LAYERS + 1) if mode == "q8_1" else 0)})
        print(f"  {name}: ppl {got['ppl']:.6f} over {got['tokens']} tokens "
              f"(plain versions {plain['ppl']:.6f}, relative {rel:.3e}, "
              f"limit 1e-3), {windows} windows of 512 in {wall:.2f} s",
              flush=True)
        if not rel <= 1e-3:
            fail(f"{name}: kernels and plain versions disagree")
        by_run[name] = launches
    return by_run


def hf_path(dev, counters, prompts):
    """A Llama-3.2-1B-width checkpoint (4 of its 16 layers, bf16, two
    shards) written with ``write_safetensors`` from a seed, loaded with
    ``load_hf_llama(dir, "q4_0")``: weights bit-equal to
    ``quantize_params`` on the same floats, the llama3 RoPE table, load
    seconds and device bytes; then 8 requests at max_seq 4096, eager and
    captured, and the layer-by-layer check."""
    from quant_gemm_tpu_torch.models import hf_loader, llama
    from quant_gemm_tpu_torch.ops.rope import llama3_inv_freq, rope_cache

    c = HF_CONFIG
    dim, dff, nl = c["hidden_size"], c["intermediate_size"], \
        c["num_hidden_layers"]
    hd = c["head_dim"]
    nq, nkv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    g = torch.Generator(device=dev).manual_seed(19)

    def w(n, k, std=None):
        return (torch.randn(n, k, generator=g, device=dev)
                * (std or k ** -0.5)).to(torch.bfloat16)

    ones = torch.ones(dim, device=dev, dtype=torch.bfloat16)
    shard = [{"model.embed_tokens.weight": w(c["vocab_size"], dim, 0.02),
              "model.norm.weight": ones}, {}]
    for i in range(nl):
        p = f"model.layers.{i}."
        shard[1].update({
            p + "input_layernorm.weight": ones,
            p + "post_attention_layernorm.weight": ones,
            p + "self_attn.q_proj.weight": w(nq, dim),
            p + "self_attn.k_proj.weight": w(nkv, dim),
            p + "self_attn.v_proj.weight": w(nkv, dim),
            p + "self_attn.o_proj.weight": w(dim, nq),
            p + "mlp.gate_proj.weight": w(dff, dim),
            p + "mlp.up_proj.weight": w(dff, dim),
            p + "mlp.down_proj.weight": w(dim, dff)})
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        for i, tensors in enumerate(shard):
            hf_loader.write_safetensors(
                d / f"model-{i + 1:05d}-of-00002.safetensors", tensors,
                {"format": "pt"})
        (d / "config.json").write_text(json.dumps(c))
        size = sum(f.stat().st_size for f in d.glob("*.safetensors"))
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp, cfg = hf_loader.load_hf_llama(d, "q4_0", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    print(f"HF path: Llama-3.2-1B width ({nl} of 16 layers), bf16, 2 shards,"
          f" {size} bytes written in {write_s:.1f} s; load_hf_llama(dir, "
          f"'q4_0') in {load_s:.2f} s, {device_bytes(qp)} bytes on the card;"
          f" {cfg}", flush=True)
    want = dict(vocab=c["vocab_size"], dim=dim, n_layers=nl,
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"], d_ff=dff,
                max_seq=c["max_position_embeddings"],
                rope_base=c["rope_theta"], eps=c["rms_norm_eps"],
                head_dim_override=hd, rope_scale=1.0)
    if any(getattr(cfg, k) != v for k, v in want.items()):
        fail(f"HF config {cfg} != {want}")
    # the same floats through quantize_params: bit for bit
    f32 = {n: t.float().cpu().numpy() for sh in shard for n, t in sh.items()}
    params = {"embed": f32["model.embed_tokens.weight"],
              "lm_head": f32["model.embed_tokens.weight"],
              "final_norm": f32["model.norm.weight"], "layers": [
                  {k: f32[f"model.layers.{i}.{v}"] for k, v in (
                      ("attn_norm", "input_layernorm.weight"),
                      ("mlp_norm", "post_attention_layernorm.weight"),
                      ("wq", "self_attn.q_proj.weight"),
                      ("wk", "self_attn.k_proj.weight"),
                      ("wv", "self_attn.v_proj.weight"),
                      ("wo", "self_attn.o_proj.weight"),
                      ("w_gate", "mlp.gate_proj.weight"),
                      ("w_up", "mlp.up_proj.weight"),
                      ("w_down", "mlp.down_proj.weight"))}
                  for i in range(nl)]}
    del shard, f32
    native = llama.quantize_params(params, "q4_0", device=dev)
    del params

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a[3:], b[3:]))

    pairs = [(qp[k], native[k]) for k in ("embed", "final_norm", "lm_head")]
    pairs += [(a[k], b[k]) for a, b in zip(qp["layers"], native["layers"])
              for k in b]
    if not all(same(a, b) for a, b in pairs):
        fail("load_hf_llama's weights differ from quantize_params'")
    if not same(qp["lm_head"], native["lm_head"]):
        fail("the tied head is not the embedding's q4_0")
    del native
    rs = c["rope_scaling"]
    inv = torch.as_tensor(llama3_inv_freq(
        hd, c["rope_theta"], rs["factor"], rs["low_freq_factor"],
        rs["high_freq_factor"], rs["original_max_position_embeddings"]),
        device=dev)
    cfg = cfg._replace(max_seq=HF_MAX_SEQ)
    table = llama.rope_for(cfg, qp, dev)
    ref = rope_cache(HF_MAX_SEQ, hd, c["rope_theta"], device=dev,
                     inv_freq=inv)
    if not (torch.equal(qp["rope_inv_freq"], inv)
            and all(torch.equal(x, y) for x, y in zip(table, ref))):
        fail("the llama3 RoPE table differs from llama3_inv_freq's")
    print(f"  {len(pairs)} weights bit-equal to quantize_params on the same "
          f"floats (the tied head the embedding's q4_0); rope_inv_freq and "
          f"the RoPE table equal llama3_inv_freq's", flush=True)
    prompts = prompts[:8]
    n_chunks = chunks(prompts, [0] * 8)
    launches, st, _ = serve_traffic(
        f"{RUN_HF}: Server(qp, cfg, n_slots=8), max_seq {HF_MAX_SEQ}", qp,
        cfg, dev, prompts, [0] * 8, counters, vocab=cfg.vocab)
    steps = st["decode_steps"]
    check_launches(RUN_HF, launches, {
        "gemm_exact": steps * (3 * nl + 1), "norm_qkv": steps * nl,
        "flash_decode": steps * nl,
        "gemm_dequant": len(n_chunks) * 4 * nl + 8,
        "flash_prefill": nl * sum(t >= 64 for t in n_chunks),
        "gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0})
    rng = np.random.default_rng(20)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 128)), device=dev)
    report_cases([
        ("HF chunk 128 at pos0 0", check(
            qp, cfg, toks, llama.KVCache.init(cfg, 1, device=dev))),
        ("HF decode step", decode_case(qp, cfg, rng, dev))])
    return {RUN_HF: launches}


def api_compat_path(dev):
    """``api.gemm_q4_0_q8_1`` on CUDA tensors at the survey's llama shape
    (4 tokens, 4096 out-features, K 4096): K1, bit-equal to K1's order of
    the golden's block terms and within 1e-5 x max|C| of the float64
    golden (``ref/gemm.py``); ``compat.gemm_from_ggml`` on a view of a
    GGUF written here, bit-equal to the api's; each ``ggml_op_*`` on the
    card against the port's ops."""
    from quant_gemm_tpu_torch import api, compat
    from quant_gemm_tpu_torch.formats.gguf_file import (GGUFFile,
                                                        from_block_bytes,
                                                        write_gguf)
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_exact import (block_terms,
                                                         gemm_exact,
                                                         k1_order)
    from quant_gemm_tpu_torch.ops import activations, rope
    from quant_gemm_tpu_torch.ops.rms_norm import rms_norm_pallas
    from quant_gemm_tpu_torch.ops.softmax import softmax_pallas
    from quant_gemm_tpu_torch.ref.gemm import gemm_wxa8

    g = torch.Generator(device=dev).manual_seed(21)
    m, n, k = 4096, 4, 4096  # weight rows (out-features), tokens, K
    w = torch.randn(m, k, generator=g, device=dev) * k ** -0.5
    a = torch.randn(n, k, generator=g, device=dev)
    wq, aq = api.quantize_q4_0(w), api.quantize_q8_1(a)
    if not (torch.equal(wq.cpu(), api.quantize_q4_0(w.cpu()))
            and torch.equal(aq.cpu(), api.quantize_q8_1(a.cpu()))):
        fail("api: the card's block bytes differ from the CPU's")
    before = gemm_exact.launches
    out = api.gemm_q4_0_q8_1(wq, aq, m, n, k)
    torch.cuda.synchronize()
    if out.shape != (m, n) or out.device != dev or \
            gemm_exact.launches != before + 1:
        fail("api.gemm_q4_0_q8_1: not one K1 launch of a [M, N] result")
    wt = from_block_bytes(wq.reshape(m, k // 32, 18), "q4_0")
    at = from_block_bytes(aq.reshape(n, k // 32, 36), "q8_1")
    order = k1_order(block_terms(layout.prepare(wt), at)).T
    gold = torch.from_numpy(gemm_wxa8(
        type(wt)(*(x.cpu().numpy() for x in wt)),
        type(at)(*(x.cpu().numpy() for x in at))).T).to(dev)
    err = float((out - gold).abs().max())
    if not torch.equal(out, order) or err > 1e-5 * float(gold.abs().max()):
        fail(f"api.gemm_q4_0_q8_1: K1 order equal {torch.equal(out, order)},"
             f" max|C - golden| {err}")
    print(f"api/compat: gemm_q4_0_q8_1 M {m} N {n} K {k} on the card: one K1"
          f" launch, bit-equal to k1_order of the block terms, max|C - "
          f"float64 golden| {err:.3e} ({err / float(gold.abs().max()):.3e}"
          f" x max|C|)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "w.gguf"
        write_gguf(path, {"blk.0.attn_q.weight": wt}, {
            "general.architecture": "llama"})
        with GGUFFile(path) as gf:
            view = compat.tensor_view_from_gguf(gf, "blk.0.attn_q.weight")
            if (view.k, view.rows) != (k, m):
                fail(f"compat view ne {view.ne}")
            got = compat.gemm_from_ggml(view, at)
    if not torch.equal(got, out.T):
        fail("compat.gemm_from_ggml differs from api.gemm_q4_0_q8_1")
    x = torch.randn(8, 4096, generator=g, device=dev)
    pos = torch.arange(8, device=dev)[:, None].expand(8, 2)
    xr = torch.randn(8, 2, 32, 128, generator=g, device=dev)
    checks = {
        "silu": (compat.ggml_op_silu(x), activations.silu(x), 0.0),
        "gelu": (compat.ggml_op_gelu(x), activations.gelu_quick(x), 0.0),
        "rms_norm (K9)": (compat.ggml_op_rms_norm(x, 1e-5), rms_norm_pallas(
            x, torch.ones(4096, device=dev), 1e-5), 1e-5),
        "soft_max (K10)": (compat.ggml_op_soft_max(x, 0.5),
                           softmax_pallas(x * 0.5), 1e-5),
        "rope neox": (compat.ggml_op_rope(xr, pos, {"mode": 2}),
                      rope.rope(xr, pos), 0.0),
        "rope interleaved": (compat.ggml_op_rope(xr, pos, {"mode": 0}),
                             rope.rope(xr, pos, interleaved=True), 0.0),
        "add": (compat.ggml_op_add(x, x), x + x, 0.0),
        "mul": (compat.ggml_op_mul(x, x), x * x, 0.0)}
    worst = {}
    for name, (got, ref, tol) in checks.items():
        e = float((got - ref).abs().max())
        worst[name] = e
        if got.device != dev or e > tol * float(ref.abs().max()):
            fail(f"compat ggml_op {name}: max|err| {e}")
    print(f"  gemm_from_ggml on a GGUF view: equal to the api's bit for "
          f"bit; ggml ops against the port's ops on the card, max|err|: "
          f"{json.dumps(worst)}", flush=True)


def slice15_path(dev, counters, prompts, reuse):
    """Slice 15: W4A16, LoRA, speculative decoding, perplexity, the
    safetensors loader and the api/compat drop-ins.  Returns each run's
    launches."""
    from quant_gemm_tpu_torch.models import llama

    t_start = time.perf_counter()
    cfg = tinyllama_cfg()
    qp = llama.init_qparams(cfg, seed=0, device=dev)
    by_run = a16_path(dev, counters, prompts, reuse, qp, cfg)
    print(f"[slice 15] W4A16: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    by_run.update(ppl_path(dev, counters, qp, cfg))
    print(f"[slice 15] + perplexity: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    del qp
    torch.cuda.empty_cache()
    by_run.update(lora_path(dev, counters, prompts, cfg))
    print(f"[slice 15] + LoRA: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    by_run.update(spec_path(dev, counters))
    print(f"[slice 15] + speculative: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    by_run.update(hf_path(dev, counters, prompts))
    print(f"[slice 15] + HF loader: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    api_compat_path(dev)
    print(f"[slice 15] + api/compat: {time.perf_counter() - t_start:.1f} s "
          "(budget 120 s)", flush=True)
    return by_run


# ---------------------------------------------------------------------------
# slice 16: quantization-aware training and tensor parallelism
# ---------------------------------------------------------------------------

RUN_QAT = "QAT q4_0 Server"
RUN_TP = "TP rank {} {}"
QAT_BATCH = (4, 256)  # (q1): 4 sequences of 256 tokens, 255 predicted each
QAT_STEPS = {True: 5, False: 3}  # steps of the remat and no-remat runs
PARITY_BATCH = (4, 64)  # (q2)
TP_PROMPT = (2, 128)  # (t1): 2 slots x 128 tokens, then TP_STEPS decode
TP_STEPS = 8
TP_TIMEOUT_S = 420


def launch_counters() -> dict:
    """Every launch counter of the serving path by name: (object,
    attribute)."""
    from quant_gemm_tpu_torch.kernels import act_quant, registry
    from quant_gemm_tpu_torch.ops.rms_norm import rms_norm_pallas
    from quant_gemm_tpu_torch.ops.softmax import softmax_pallas

    counters = {name: (fn, "launches")
                for name, fn in registry.KERNELS._asdict().items()}
    counters["k16_dequant_gemm"] = (registry.k16_dequant_gemm, "calls")
    counters["rms_norm_pallas"] = (rms_norm_pallas, "launches")
    counters["quantize_q8_1"] = (act_quant.quantize_q8_1, "launches")
    counters["quantize_fold_q8_1"] = (act_quant.quantize_fold_q8_1,
                                      "launches")
    counters["softmax_pallas"] = (softmax_pallas, "launches")
    return counters


def read(counters) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def first_layers(params, n):
    return {**params, "layers": params["layers"][:n]}


def on(params, dev):
    from quant_gemm_tpu_torch.models import train

    return train.unflatten(params, [torch.tensor(np.asarray(p), device=dev)
                                    for p in train.leaves(params)])


def qat_runs(dev, params, cfg, card):
    """(q1): AdamW QAT steps with and without remat at full width, and
    accum_steps=2 against the whole batch.  Returns the remat run's
    trained parameters (numpy)."""
    from quant_gemm_tpu_torch.models import train

    toks = np.random.default_rng(160).integers(0, VOCAB, QAT_BATCH)
    n_tok = QAT_BATCH[0] * (QAT_BATCH[1] - 1)
    first = trained = None
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        p, opt, step = train.make_state_step(params, cfg, optimizer="adamw",
                                             remat=remat, device=dev)
        losses, secs = [], []
        for _ in range(QAT_STEPS[remat]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, loss = step(p, opt, toks)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ms = statistics.median(secs[1:]) * 1e3
        print(f"  (q1) QAT AdamW (optax defaults) q4_0 remat={remat}: "
              f"{QAT_STEPS[remat]} steps of {QAT_BATCH[0]} x {QAT_BATCH[1]} "
              f"tokens, losses {[round(x, 5) for x in losses]}; "
              f"{ms:.1f} ms a step (median after the first, "
              f"{secs[0] * 1e3:.1f} ms), {n_tok / ms * 1e3:.0f} tokens/s, "
              f"max_memory_allocated {peak:.2f} GiB [{card}]", flush=True)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"QAT remat={remat}: the loss did not fall: {losses}")
        if remat:
            first = losses[0]
            trained = train.unflatten(params, [x.detach().cpu().numpy()
                                               for x in train.leaves(p)])
        del p, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    p, opt, step = train.make_state_step(params, cfg, optimizer="adamw",
                                         remat=True, accum_steps=2,
                                         device=dev)
    _, _, loss = step(p, opt, toks)
    rel = abs(float(loss) - first) / abs(first)
    print(f"  (q1) accum_steps=2 on the same batch: loss {float(loss):.7f} "
          f"vs {first:.7f} (relative {rel:.2e}, limit 1e-5)", flush=True)
    if not rel <= 1e-5:
        fail("QAT accum_steps=2 differs from the whole batch")
    del p, opt, step
    return trained


def qat_parity(dev, params, cfg):
    """(q2): one step's loss and gradients at full width, 2 layers, on the
    card (TF32 off) against the port on the CPU."""
    from quant_gemm_tpu_torch.models import train

    cfg2 = cfg._replace(n_layers=2)
    p2 = first_layers(params, 2)
    toks = np.random.default_rng(161).integers(0, VOCAB, PARITY_BATCH)
    out, secs = [], []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        out.append(train.value_and_grad(
            on(p2, where), cfg2, torch.tensor(toks, device=where), "q4_0"))
        secs.append(time.perf_counter() - t0)
    (lg, gg), (lc, gc_) = out
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(train.leaves(gg), train.leaves(gc_)))
    print(f"  (q2) QAT parity at full width, 2 layers, {PARITY_BATCH[0]} x "
          f"{PARITY_BATCH[1]} tokens, allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}: loss {float(lg):.7f} "
          f"card vs {float(lc):.7f} CPU (relative {rel:.2e}, limit 1e-5); "
          f"worst gradient max|delta| / max|CPU| {worst:.2e} over "
          f"{len(train.leaves(gg))} tensors (limit 1e-4); card "
          f"{secs[0]:.1f} s, CPU {secs[1]:.1f} s", flush=True)
    if not (rel <= 1e-5 and worst <= 1e-4):
        fail("QAT on the card disagrees with the CPU")


def qat_serving(dev, trained, cfg, counters, prompts, reuse):
    """(q3): the trained floats quantized with quantize_params dequantize
    to the training forward's weights bit for bit; then 4 greedy requests
    through the Server and the layer-by-layer check."""
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.models import llama, train

    qp = llama.quantize_params(trained, "q4_0", device=dev)

    def fq(*names, lyr):
        return torch.cat([train.fake_quant_ste(torch.tensor(
            lyr[n], device=dev)) for n in names])

    pairs = [(qp["lm_head"], fq("lm_head", lyr=trained))]
    for ql, tl in zip(qp["layers"], trained["layers"]):
        pairs += [(ql["wqkv"], fq("wq", "wk", "wv", lyr=tl)),
                  (ql["wo"], fq("wo", lyr=tl)),
                  (ql["wgu"], fq("w_gate", "w_up", lyr=tl)),
                  (ql["w_down"], fq("w_down", lyr=tl))]
    bad = sum(not torch.equal(layout.dequantize(w), f) for w, f in pairs)
    print(f"  (q3) dequantize(quantize_params(trained)) == fake_quant_ste("
          f"trained) bit for bit on {len(pairs) - bad} of {len(pairs)} "
          "linears", flush=True)
    if bad:
        fail("the served grid differs from the trained one")
    launches, st, _ = serve_traffic(f"{RUN_QAT}(qp, cfg, n_slots=8)", qp,
                                    cfg, dev, prompts, reuse, counters)
    n_chunks = chunks(prompts, reuse)
    steps = st["decode_steps"]
    check_launches(RUN_QAT, launches, {
        "gemm_exact": steps * (3 * LAYERS + 1),
        "norm_qkv": steps * LAYERS, "flash_decode": steps * LAYERS,
        "gemm_exact_fused": 0, "attn_tail": 0,
        "gemm_dequant": len(n_chunks) * 4 * LAYERS + heads(prompts, reuse),
        "flash_prefill": LAYERS * sum(t >= 64 for t in n_chunks),
        "gemm_exact_k16": 0})
    rng = np.random.default_rng(162)
    toks = torch.as_tensor(rng.integers(0, VOCAB, (1, 128)), device=dev)
    report_cases([
        ("QAT q4_0 chunk 128", check(qp, cfg, toks, llama.KVCache.init(
            cfg, 1, device=dev))),
        ("QAT q4_0 decode step", decode_case(qp, cfg, rng, dev))])
    return launches


def tp_worker(rank, store, dev, q):
    """One rank of (t1)/(t2): gloo on ``dev`` (both ranks share the
    card), the file rendezvous ``store``; puts (rank, ok, result or
    traceback) on ``q``."""
    import traceback

    try:
        q.put((rank, True, tp_rank(rank, store, dev)))
    except BaseException:  # noqa: BLE001 - fail() exits; sent to the parent
        q.put((rank, False, traceback.format_exc()))
    q.close()
    q.join_thread()
    os._exit(0)  # no wait on the peer's teardown


def close(a, b, tol=1e-3):
    """assert_allclose(a, b, atol=tol, rtol=tol)'s verdict and the largest
    |a - b|."""
    d = (a - b).abs()
    return bool((d <= tol + tol * b.abs()).all()), float(d.max())


def tp_params(cfg, dev, seed=16):
    """``init_params``-structured floats drawn on ``dev`` from a
    ``torch.Generator`` (``init_params``' scales; numpy takes 20 s at this
    width), returned on the CPU."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def lin(n, k):
        return (torch.randn(n, k, generator=g, device=dev) * k ** -0.5).cpu()

    hd = cfg.head_dim
    ones = torch.ones(cfg.dim)
    return {"embed": (torch.randn(cfg.vocab, cfg.dim, generator=g,
                                  device=dev) * 0.02).cpu(),
            "layers": [{"attn_norm": ones, "mlp_norm": ones,
                        "wq": lin(cfg.n_heads * hd, cfg.dim),
                        "wk": lin(cfg.n_kv_heads * hd, cfg.dim),
                        "wv": lin(cfg.n_kv_heads * hd, cfg.dim),
                        "wo": lin(cfg.dim, cfg.n_heads * hd),
                        "w_gate": lin(cfg.d_ff, cfg.dim),
                        "w_up": lin(cfg.d_ff, cfg.dim),
                        "w_down": lin(cfg.dim, cfg.d_ff)}
                       for _ in range(cfg.n_layers)],
            "final_norm": ones, "lm_head": lin(cfg.vocab, cfg.dim)}


def tp_rank(rank, store, dev):
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama, llama_tp, train
    from quant_gemm_tpu_torch.parallel import health, multihost, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(f"file://{store}", 2, rank, backend="gloo",
                         timeout_s=300)
    mesh = sharding.make_mesh({"tp": 2}, device=dev)
    out = {"health": health.check(60.0, mesh)}
    if not out["health"].ok:
        raise RuntimeError(out["health"].row())
    cfg = tinyllama_cfg()
    params = tp_params(cfg, dev)
    qtp = llama_tp.shard_params_tp(params, cfg, mesh, "q4_0")
    q1 = llama.quantize_params(params, "q4_0", device=dev) if rank == 0 \
        else None
    rng = np.random.default_rng(163)
    prompt = torch.as_tensor(rng.integers(0, VOCAB, TP_PROMPT), device=dev)
    steps = torch.as_tensor(rng.integers(0, VOCAB, (TP_STEPS,
                                                    TP_PROMPT[0], 1)),
                            device=dev)
    counters = launch_counters()

    def run(fwd, cache):
        """The prefill and TP_STEPS teacher-forced decode steps: logits of
        each call, prefill ms and decode step ms."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = [fwd(prompt, cache)[0]]
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        for tok in steps:
            t0 = time.perf_counter()
            logits.append(fwd(tok, cache)[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return logits, times[0] * 1e3, statistics.median(times[1:]) * 1e3

    def tp_fwd(qp, c, mode="q8_1"):
        return lambda tok, cache: llama_tp.forward_tp(qp, c, tok, cache, mesh,
                                                      act_mode=mode)

    def one_fwd(qp, c, mode="q8_1", ops=registry.KERNELS):
        return lambda tok, cache: llama.forward(qp, c, tok, cache,
                                                act_mode=mode, ops=ops)

    b = TP_PROMPT[0]
    run(tp_fwd(qtp, cfg), llama_tp.init_cache_tp(cfg, b, mesh))  # warm-up
    want = {"gemm_exact": TP_STEPS * (3 * LAYERS + 1),
            "norm_qkv": TP_STEPS * LAYERS, "flash_decode": TP_STEPS * LAYERS,
            "gemm_dequant": 4 * LAYERS + 1, "flash_prefill": LAYERS,
            "gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0}
    # the float witness: 2 layers of float32 weights, the rank's Megatron
    # chunks against the whole (no activation rounding but the cache's)
    cfg2 = cfg._replace(n_layers=2)
    p2 = first_layers(params, 2)
    ftp = llama.float_params({**p2, "layers": [
        {k: sharding.megatron_chunk(v, r[k], mesh) for k, v in ly.items()}
        for ly, r in zip(p2["layers"],
                         train.param_shardings(p2)["layers"])]}, dev)
    f1 = llama.float_params(p2, dev) if rank == 0 else None
    for cq in ("bf16", "q8"):
        zero(counters)
        lt, pre_ms, dec_ms = run(tp_fwd(qtp, cfg), llama_tp.init_cache_tp(
            cfg, b, mesh, qtype=cq))
        launches = read(counters)
        check_launches(RUN_TP.format(rank, cq), launches, want)
        row = {"launches": launches, "prefill_ms": pre_ms,
               "decode_ms": dec_ms}
        # the ranks' logits are the same bits
        last = sharding.all_gather(lt[-1][None], mesh, "tp", dim=0)
        row["ranks_equal"] = bool(torch.equal(last[0], last[1]))
        lt2 = run(tp_fwd(ftp, cfg2, "float"), llama_tp.init_cache_tp(
            cfg2, b, mesh, qtype=cq))[0]
        if rank == 0:
            run(one_fwd(q1, cfg), llama.KVCache.init(cfg, b, cq, device=dev))
            l1, row["one_prefill_ms"], row["one_decode_ms"] = run(
                one_fwd(q1, cfg), llama.KVCache.init(cfg, b, cq, device=dev))
            row["free"] = (max(close(a, c)[1] for a, c in zip(lt, l1)),
                           max(nmse(a, c) for a, c in zip(lt, l1)))
            ln = run(one_fwd(q1, cfg, ops=noisy_ops(dev)),
                     llama.KVCache.init(cfg, b, cq, device=dev))[0]
            row["noise"] = (max(close(a, c)[1] for a, c in zip(ln, l1)),
                            max(nmse(a, c) for a, c in zip(ln, l1)))
            l12 = run(one_fwd(f1, cfg2, "float"), llama.KVCache.init(
                cfg2, b, cq, device=dev))[0]
            row["float"] = (max(close(a, c)[1] for a, c in zip(lt2, l12)),
                            max(nmse(a, c) for a, c in zip(lt2, l12)),
                            all(close(a, c)[0] for a, c in zip(lt2, l12)))
        row["layerwise"] = tp_layerwise(rank, cfg, qtp, q1, cq, prompt, steps,
                                        mesh, dev)
        out[cq] = row
    for shape in ((TP_PROMPT[0] * TP_PROMPT[1], DIM), (TP_PROMPT[0], DIM)):
        x = torch.randn(shape, device=dev)
        for _ in range(3):
            sharding.all_reduce(x, mesh, "tp")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sharding.all_reduce(x, mesh, "tp")
        torch.cuda.synchronize()
        out[f"all_reduce_{shape[0]}x{shape[1]}_ms"] = (
            time.perf_counter() - t0) / 20 * 1e3
    out["gemms"] = tp_gemms(dev, mesh)
    del qtp, q1
    torch.cuda.empty_cache()

    # (t2) one sharded AdamW QAT step on a dp 1 x tp 2 mesh, 2 layers
    cfg2 = cfg._replace(n_layers=2)
    p2 = first_layers(params, 2)
    toks = np.random.default_rng(164).integers(0, VOCAB, PARITY_BATCH)
    mesh2 = sharding.make_mesh({"dp": 1, "tp": 2}, device=dev)
    p, opt, step = train.make_state_step(p2, cfg2, mesh=mesh2,
                                         optimizer="adamw")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, opt, loss = step(p, opt, toks)
    out["train_step_ms"] = (time.perf_counter() - t0) * 1e3
    full = train.leaves(train.gather_params(p, mesh2))
    # AdamW's first moment after one step is (1 - b1) g: the step's own
    # gradients, gathered
    moments = train.leaves(train.gather_params(train.unflatten(p, [
        opt.state[q]["exp_avg"] for q in train.leaves(p)]), mesh2))
    del p, opt
    if rank == 0:
        p1, o1, step1 = train.make_state_step(p2, cfg2, optimizer="adamw",
                                              device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p1, o1, loss1 = step1(p1, o1, toks)
        out["one_train_step_ms"] = (time.perf_counter() - t0) * 1e3
        _, g1 = train.value_and_grad(on(p2, dev), cfg2,
                                     torch.tensor(toks, device=dev))
        firm_d = loose_d = grad_d = 0.0
        loose = 0
        for a, b, g, m in zip(full, train.leaves(p1), train.leaves(g1),
                              moments):
            d = (a - b.detach()).abs()
            firm = g.abs() >= 1e-6
            firm_d = max(firm_d, float(d[firm].max()) if firm.any() else 0)
            loose_d = max(loose_d, float(d.max()))
            loose += int((~firm).sum())
            m1 = o1.state[b]["exp_avg"]
            grad_d = max(grad_d, float((m - m1).abs().max()
                                       / m1.abs().max()))
        out["train"] = (float(loss), float(loss1), firm_d, loose_d, loose,
                        sum(x.numel() for x in full), grad_d)
    out["host_copies"] = dict(sharding.HOST_COPIES)
    return out


def noisy_ops(dev, eps=1e-7, seed=166):
    """The kernels with every GEMM output (K1, K2, K4) times (1 + eps *
    N(0, 1)): float-order noise of the size a row-parallel sum or K4's
    N-dependent split leaves (at most 3.6e-7 of the output's max, op by
    op, on the card), for the single-device witness of what the Q8_1 and
    bf16 roundings downstream make of it."""
    from quant_gemm_tpu_torch.kernels import registry

    g = torch.Generator(device=dev).manual_seed(seed)

    def noisy(f):
        def h(*a, **kw):
            y = f(*a, **kw)
            return y * (1 + eps * torch.randn(y.shape, device=dev,
                                                generator=g))
        return h

    k = registry.KERNELS
    return k._replace(gemm_dequant=noisy(k.gemm_dequant),
                      gemm_exact=noisy(k.gemm_exact),
                      norm_qkv=noisy(k.norm_qkv))


def tp_op_witness(dev, card):
    """Layer 0 of the TinyLlama-width q4_0 model, op by op: the single
    device's prefill (2 x 128) and one decode step with each cache, every
    kernel call recorded, then repeated with both ranks' shards
    (``shard_params_tp``) on that call's own inputs (the rank's heads or
    K columns) and held to the single-device output (its columns, or the
    two K partials summed) within 1e-6 of its max: each op alone leaves
    at most float-order differences.  Prints which ops are bit-equal."""
    from quant_gemm_tpu_torch.formats.blocks import QK, Q8_1Tensor
    from quant_gemm_tpu_torch.kernels import registry
    from quant_gemm_tpu_torch.models import llama, llama_tp
    from quant_gemm_tpu_torch.parallel import sharding

    cfg = tinyllama_cfg()._replace(n_layers=1)
    params = tp_params(cfg, dev, seed=167)
    q1 = llama.quantize_params(params, "q4_0", device=dev)
    qr = [llama_tp.shard_params_tp(params, cfg, sharding.Mesh(
        {"tp": 2}, {"tp": r}, {"tp": None}, dev))["layers"][0]
        for r in (0, 1)]
    nq, nkv = HEADS * cfg.head_dim, KV_HEADS * cfg.head_dim

    def rows(r, *spans):  # rank r's half of each [start, start + n)
        return torch.cat([torch.arange(a + r * n // 2, a + (r + 1) * n // 2)
                          for a, n in spans]).to(dev)

    cols = {"wqkv": [rows(r, (0, nq), (nq, nkv), (nq + nkv, nkv))
                     for r in (0, 1)],
            "wgu": [rows(r, (0, D_FF), (D_FF, D_FF)) for r in (0, 1)]}

    def half(t, dim, r):
        n = t.shape[dim] // 2
        return t.narrow(dim, r * n, n).contiguous()

    def k_half(act, r):
        if isinstance(act, Q8_1Tensor):
            return Q8_1Tensor(half(act.qs, 1, r), half(act.d, 1, r),
                              half(act.s, 1, r))
        return half(act, 1, r)

    def keep(v):
        if isinstance(v, Q8_1Tensor):
            return Q8_1Tensor(*(f.clone() for f in v))
        return v.clone() if isinstance(v, torch.Tensor) else v

    log = []

    def recorded(name, f):
        def g(*a, **kw):
            call = (name, [keep(x) for x in a],
                    {k: keep(v) for k, v in kw.items()})
            out = f(*a, **kw)
            log.append(call + (out.clone(),))
            return out
        return g

    rops = registry.Ops(**{k: recorded(k, f)
                           for k, f in registry.KERNELS._asdict().items()})
    k = registry.KERNELS
    rng = np.random.default_rng(167)
    prompt = torch.as_tensor(rng.integers(0, VOCAB, TP_PROMPT), device=dev)
    step = torch.as_tensor(rng.integers(0, VOCAB, (TP_PROMPT[0], 1)),
                           device=dev)
    worst, equal = 0.0, {}
    for cq in ("bf16", "q8"):
        cache = llama.KVCache.init(cfg, TP_PROMPT[0], cq, device=dev)
        for tok in (prompt, step):
            log.clear()
            x, st = llama.begin(q1, cfg, tok, cache)
            _, kv = llama.layer(q1["layers"][0], 0, cfg, x, cache, st, rops)
            llama.end(cache, st, [kv] if kv is not None else [])
            gemms = iter(("wqkv", "wo", "wgu", "w_down"))
            for name, a, kw, ref in log:
                fn = getattr(k, name)
                if name in ("flash_prefill", "flash_decode"):
                    label = name
                    got = []
                    for r in (0, 1):  # q [B, KV, ...], cache [L, B, KV, ...]
                        kr = {key: (half(v, 1 if key.endswith("current")
                                         else 2, r)
                                    if isinstance(v, torch.Tensor) else v)
                              for key, v in kw.items()}
                        got.append(fn(half(a[0], 1, r), half(a[1], 2, r),
                                      half(a[2], 2, r), *a[3:], **kr))
                    got, want = torch.cat(got, dim=1), ref
                else:
                    w = next(gemms)
                    label = f"{name}({w})"
                    if w in cols:
                        got = torch.cat([fn(qr[r][w], *a[1:], **kw)
                                         for r in (0, 1)], dim=1)
                        want = ref[:, torch.cat(cols[w])]
                    else:
                        got = sum(fn(qr[r][w], k_half(a[1], r), **kw)
                                  for r in (0, 1))
                        want = ref
                rel = float((got.float() - want.float()).abs().max()
                            / want.float().abs().max())
                worst = max(worst, rel)
                key = f"{cq} {'prefill' if tok is prompt else 'decode'} " \
                    f"{label}"
                equal[key] = (bool(torch.equal(got, want)), rel)
    print(f"  (t1) TP op by op at layer 0 on the single device's inputs "
          f"(bit-equal, max|delta| / max|single|): {json.dumps(equal)}; "
          f"worst {worst:.2e} (limit 1e-6) [{card}]", flush=True)
    if worst > 1e-6:
        fail("a TP op differs from the single-device op beyond float order")


def tp_layerwise(rank, cfg, qtp, q1, cq, prompt, steps, mesh, dev):
    """The prefill and decode steps of ``run``, every TP layer fed the
    single-device hidden state (rank 0's, broadcast): on rank 0 the
    largest NMSE of a layer's update against the single-device layer's
    (the repo's layer-by-layer method: a Q8_1 code or a bf16 cache value
    that a row-parallel sum's order moves across a rounding tie shows in
    its own layer only)."""
    import torch.distributed as dist

    from quant_gemm_tpu_torch.models import llama, llama_tp

    local, ctx = llama_tp.tp_context(cfg, mesh)
    ct = llama_tp.init_cache_tp(cfg, TP_PROMPT[0], mesh, qtype=cq)
    c1 = llama.KVCache.init(cfg, TP_PROMPT[0], cq, device=dev) \
        if rank == 0 else None
    worst = 0.0
    for tok in [prompt, *steps]:
        x, st = llama.begin(qtp, local, tok, ct, tp_ctx=ctx)
        if rank == 0:
            x, s1 = llama.begin(q1, cfg, tok, c1)
        dist.broadcast(x, 0)
        cur_t, cur_1 = [], []
        for li in range(cfg.n_layers):
            yt, kv = llama.layer(qtp["layers"][li], li, local, x, ct, st)
            cur_t += [kv] if kv is not None else []
            if rank == 0:
                y1, kv1 = llama.layer(q1["layers"][li], li, cfg, x, c1, s1)
                cur_1 += [kv1] if kv1 is not None else []
                worst = max(worst, nmse(yt - x, y1 - x))
                x = y1
            dist.broadcast(x, 0)
        llama.end(ct, st, cur_t)
        if rank == 0:
            llama.end(c1, s1, cur_1)
    return worst


def tp_gemms(dev, mesh):
    """The sharded GEMMs at TinyLlama's wo (M 8, q4_0) against the
    unsharded kernels: K1 on the rank's rows (the TP decode route's
    column-parallel GEMM) bit for bit; ``gemm_col_parallel`` (K4, whose
    split over K follows N: ``gemm_dequant.k4_grid``), the reduce-scatter
    and both rings (K1 on Q8_1 chunks) to float order.  Returns {name:
    (max|delta| / max|reference|, bit-equal)}."""
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0
    from quant_gemm_tpu_torch.kernels import layout, registry
    from quant_gemm_tpu_torch.parallel import sharding as sh

    g = torch.Generator(device=dev).manual_seed(165)
    a = torch.randn(8, DIM, device=dev, generator=g)
    w_q = quantize_q4_0(torch.randn(DIM, DIM, device=dev, generator=g)
                        * DIM ** -0.5)
    whole = layout.prepare(w_q)
    ref8 = registry.KERNELS.gemm_exact(whole, registry.quantize(a))
    ref4 = registry.KERNELS.gemm_dequant(whole, a)
    cols = slice(mesh.index("tp") * DIM // 2, (mesh.index("tp") + 1)
                 * DIM // 2)
    f32 = dict(a_dtype=torch.float32)
    col = sh.shard_weight(w_q, mesh)
    got = {
        "col_k1": (registry.KERNELS.gemm_exact(col.local,
                                               registry.quantize(a)),
                   ref8[:, cols]),
        "col": (sh.gemm_col_parallel(col, a, mesh, **f32), ref4[:, cols]),
        "row_reduce_scatter": (sh.gemm_row_parallel(
            sh.shard_weight(w_q, mesh, mode="row"), a, mesh,
            scatter_output=True, **f32), ref4[:, cols]),
        "col_ring": (sh.gemm_col_parallel_ring(
            sh.shard_weight_ring(w_q, mesh), a, mesh), ref8[:, cols]),
        "row_ring": (sh.gemm_row_parallel_ring(
            sh.shard_weight_ring(w_q, mesh, mode="row"), a, mesh),
            ref8[:, cols])}
    return {k: (float((x - y).abs().max() / y.abs().max()),
                bool(torch.equal(x, y))) for k, (x, y) in got.items()}


def tp_path(dev, card):
    """(t1) and (t2): the ops of a TP layer one by one, two ranks on the
    one card (gloo), then scripts/multihost.py --nproc 2.  Returns each
    rank's launches."""
    tp_op_witness(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=tp_worker,
                             args=(r, f"{tmp}/store", dev, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        res, deadline = {}, time.monotonic() + TP_TIMEOUT_S
        try:
            while len(res) < 2 and time.monotonic() < deadline:
                try:
                    rank, ok, val = q.get(timeout=5)
                except Exception:  # queue.Empty
                    if any(p.exitcode is not None and r not in res
                           for r, p in enumerate(procs)):
                        fail("a TP rank died without a result")
                    continue
                if not ok:
                    fail(f"TP rank {rank}:\n{val}")
                res[rank] = val
        finally:
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    if len(res) < 2:
        fail(f"the TP ranks did not finish in {TP_TIMEOUT_S} s")
    by_run = {}
    for rank in (0, 1):
        r = res[rank]
        print(f"  (t2) rank {rank}: {r['health'].row()}", flush=True)
        for cq in ("bf16", "q8"):
            row = r[cq]
            by_run[RUN_TP.format(rank, cq)] = row["launches"]
            print(f"  (t1) TP rank {rank}, {cq} cache, {LAYERS} layers: "
                  f"prefill {TP_PROMPT[0]} x {TP_PROMPT[1]} {row['prefill_ms']:.2f}"
                  f" ms, decode step (2 slots) {row['decode_ms']:.3f} ms "
                  f"(median of {TP_STEPS}); ranks' logits equal: "
                  f"{row['ranks_equal']}; launches {json.dumps(row['launches'])}"
                  f" [{card}]", flush=True)
            if not row["ranks_equal"]:
                fail("the TP ranks' logits differ")
            if rank == 0:
                worst = row["layerwise"]
                fl = row["float"]
                print(f"  (t1) single device {cq}: prefill "
                      f"{row['one_prefill_ms']:.2f} ms, decode step "
                      f"{row['one_decode_ms']:.3f} ms [{card}]; TP vs single "
                      f"device, q8_1, {LAYERS} layers: each layer fed the "
                      f"single-device state, worst layer update NMSE "
                      f"{worst:.3e} (limit 1e-4); free runs max|delta| "
                      f"{row['free'][0]:.4f}, worst logits NMSE "
                      f"{row['free'][1]:.3e} (limit 4 x the single device's "
                      f"own under 1e-7 relative noise on every GEMM output: "
                      f"max|delta| {row['noise'][0]:.4f}, NMSE "
                      f"{row['noise'][1]:.3e}); float witness (2 layers, "
                      f"float32 weights and activations): max|delta| "
                      f"{fl[0]:.2e}, NMSE {fl[1]:.2e}, within atol/rtol "
                      f"1e-3: {fl[2]}", flush=True)
                if not (worst <= 1e-4 and fl[2]
                        and row["free"][1] <= 4 * row["noise"][1]):
                    fail(f"TP logits differ from single device ({cq})")
        for k, v in r.items():
            if k.startswith("all_reduce_"):
                print(f"  (t1) rank {rank} gloo {k} (CUDA tensor): "
                      f"{v:.3f} ms [{card}]", flush=True)
        gm = r["gemms"]
        print(f"  (t1) rank {rank} sharded GEMMs at {DIM} x {DIM}, M 8, q4_0,"
              f" max|delta| / max|unsharded|: "
              f"{json.dumps({k: v[0] for k, v in gm.items()})} (limit 1e-5;"
              f" K1 on the rank's rows bit-equal: {gm['col_k1'][1]})",
              flush=True)
        if not (gm["col_k1"][1] and all(v[0] <= 1e-5
                                        for v in gm.values())):
            fail("a sharded GEMM differs from the unsharded kernel")
        print(f"  (t2) rank {rank} sharded AdamW QAT step (dp 1 x tp 2, "
              f"2 layers, {PARITY_BATCH[0]} x {PARITY_BATCH[1]}): "
              f"{r['train_step_ms']:.1f} ms; host-copied collectives "
              f"{json.dumps(r['host_copies'])}", flush=True)
    loss, loss1, firm_d, loose_d, loose, n, grad_d = res[0]["train"]
    rel = abs(loss - loss1) / abs(loss1)
    print(f"  (t2) sharded step vs single process ("
          f"{res[0]['one_train_step_ms']:.1f} ms): loss {loss:.7f} vs "
          f"{loss1:.7f} (relative {rel:.2e}, limit 1e-5); gradients (AdamW's "
          f"first moment) max|delta| / the leaf's max|gradient| "
          f"{grad_d:.2e} (limit 1e-5); params max|delta| {firm_d:.2e} where "
          f"|grad| >= 1e-6 (limit 1e-5), {loose_d:.2e} over all ({loose} of "
          f"{n} elements have |grad| < 1e-6, where AdamW's first step lr g "
          f"/ (|g| + 1e-8) follows float-order noise: not held)",
          flush=True)
    if not (rel <= 1e-5 and grad_d <= 1e-5 and firm_d <= 1e-5):
        fail("the sharded QAT step differs from the single-process step")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "quant_gemm_tpu_torch.scripts.multihost",
         "--nproc", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    for line in out.stdout.strip().splitlines()[-3:]:
        print(f"  (t2) multihost: {line}", flush=True)
    if out.returncode != 0 or "multihost OK" not in out.stdout:
        fail(f"scripts/multihost.py --nproc 2 failed:\n{out.stdout}\n"
             f"{out.stderr[-2000:]}")
    print(f"  (t2) scripts/multihost.py --nproc 2: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_run


def slice16_path(dev, counters, prompts, reuse):
    """Slice 16: QAT at TinyLlama width (q1-q3) and tensor parallelism
    over two ranks on the card (t1, t2).  Returns each run's launches."""
    from quant_gemm_tpu_torch.models import llama

    card = card_line()
    torch.empty(1, device=dev)  # the allocator's statistics exist
    t_start = time.perf_counter()
    cfg = tinyllama_cfg()
    params = llama.init_params(cfg, seed=0)
    print(f"[slice 16] init_params at TinyLlama width: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    trained = qat_runs(dev, params, cfg, card)
    print(f"[slice 16] + (q1): {time.perf_counter() - t_start:.1f} s",
          flush=True)
    qat_parity(dev, params, cfg)
    print(f"[slice 16] + (q2): {time.perf_counter() - t_start:.1f} s",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    by_run = {RUN_QAT: qat_serving(dev, trained, cfg, counters,
                                   prompts[:4], reuse[:4])}
    print(f"[slice 16] + (q3): {time.perf_counter() - t_start:.1f} s",
          flush=True)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    by_run.update(tp_path(dev, card))
    print(f"[slice 16] + (t1, t2): {time.perf_counter() - t_start:.1f} s "
          "(budget 120 s)", flush=True)
    return by_run


RUN_S17 = "slice 17 q4_0 Server"
RING_TIMEOUT_S = 240
# (h4): the ring GEMMs at TinyLlama's wqkv (column ring, the all-gather
# of the Q8_1 activation) and w_down (row ring, the reduce-scatter of the
# partial sums), M 8, two ranks
RING_CASES = (("col_ring wqkv", "col", HEADS * HD + 2 * KV_HEADS * HD, DIM),
              ("row_ring w_down", "row", DIM, D_FF))
RING_REPS = 10


def gate(card):
    """(h1) The deviceless compile gate: every source compiled again for
    sm_90a in processes that see no GPU, its ptxas table printed; every
    entry function's registers, stack and spills must equal the start-up
    build's (same flags).  Returns the rows."""
    from quant_gemm_tpu_torch.harness import aot
    from quant_gemm_tpu_torch.kernels import _build

    try:
        res = aot.aot_compile()
    except RuntimeError as e:
        fail(f"(h1) the deviceless compile gate failed:\n{e}")
    rows = aot.resource_report(res["logs"])
    print(f"  (h1) deviceless gate: {len(res['logs'])} sources compiled for "
          f"sm_90a with CUDA_VISIBLE_DEVICES='' in {res['seconds']:.1f} s, "
          f"{len(rows)} entry functions [{card}]:", flush=True)
    for line in aot.format_report(rows).splitlines():
        print(f"    {line}", flush=True)
    built = {(r.source, r.mangled): r
             for r in aot.resource_report(dict(_build.BUILD_LOG))}

    def key(r):
        return r.registers, r.stack, r.spill_stores, r.spill_loads, r.smem

    compared = [r for r in rows if r.source in _build.BUILD_LOG]
    differ = [r.name for r in compared
              if key(built.get((r.source, r.mangled), r)) != key(r)
              or (r.source, r.mangled) not in built]
    print(f"  (h1) {len(compared)} entries of {len(_build.BUILD_LOG)} "
          "sources built at start-up compared with the start-up build's "
          f"ptxas report: {len(compared) - len(differ)} equal", flush=True)
    if not rows or differ:
        fail(f"(h1) the gate's resources differ from the start-up build's: "
             f"{differ[:5]}")
    return rows


def harness_rows(dev, card, kernel_rows):
    """(h2) ``harness.benchmark.interleaved_medians`` over the main path's
    kernels at TinyLlama width: K1 on the five decode GEMMs (M 8), K2,
    K3 (bf16, B 8, ctx 512), K4 on the five GEMMs (M 128, bf16 A) and K5
    (T 128, pos0 0), with the library calls the kernel phase times beside
    K3, K4 and K5 in the same rounds; each row beside its roofline and the
    kernel phase's time for the same call (K1 and K4 within 1.3x of it)."""
    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0, quantize_q8_1
    from quant_gemm_tpu_torch.harness import benchmark as bm
    from quant_gemm_tpu_torch.harness import profiling as pf
    from quant_gemm_tpu_torch.kernels import layout
    from quant_gemm_tpu_torch.kernels.gemm_dequant import gemm_dequant
    from quant_gemm_tpu_torch.kernels.gemm_exact import gemm_exact
    from quant_gemm_tpu_torch.kernels.gemm_megalayer import norm_qkv
    from quant_gemm_tpu_torch.kernels.registry import fold_q8_1
    from quant_gemm_tpu_torch.ops.attention import flash_decode, flash_prefill

    g = torch.Generator(device=dev).manual_seed(1717)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    shapes = {"wqkv": (HEADS * HD + 2 * KV_HEADS * HD, DIM), "wo": (DIM, DIM),
              "wgu": (2 * D_FF, DIM), "w_down": (DIM, D_FF),
              "lm_head": (VOCAB, DIM)}
    weights = {name: layout.prepare(quantize_q4_0(
        randn(n, k, scale=k ** -0.5))) for name, (n, k) in shapes.items()}
    cases, floors = [], {}

    def case(kernel, shape, fn, args, floor):
        """A kernel's case, named "<kernel> <shape>" (K1 and K2 share the
        wqkv shape)."""
        cases.append((f"{kernel} {shape}", fn, args, floor[2]))
        floors[f"{kernel} {shape}"] = (kernel, shape, floor)

    def gemm_floor(m, w, act, peak):
        rf = pf.roofline("q4_0", m, w.n, w.k, act, peak)
        return (rf.time_us / 1e3,
                "bytes" if rf.bound == "memory" else "operations", rf.bytes)

    def floor_of(nbytes, ops, kind):
        return (*pf.bound(nbytes, ops, kind), nbytes)

    for name, w in weights.items():
        a = quantize_q8_1(randn(8, w.k))
        case("gemm_exact", f"{name} M=8 N={w.n} K={w.k}", gemm_exact, (w, a),
             gemm_floor(8, w, 1.125, "int8"))
    w = weights["wqkv"]
    x, nw = randn(8, DIM, scale=3.0), 1.0 + 0.1 * randn(DIM)
    case("norm_qkv", f"wqkv M=8 N={w.n} K={w.k}", norm_qkv,
         (w, x, nw, 1e-5), floor_of(bm.weight_bytes("q4_0", w.n, w.k)
                                    + 8 * DIM * 4 + DIM * 4 + 8 * w.n * 4,
                                    2 * 8 * w.n * w.k, "int8"))
    # K3 and K5 on the kernel phase's main inputs: the bf16 cache at
    # layer 5 of [22, 8, 4, 2048, 64], decode at ctx 512 and a 128-token
    # chunk of slot 3 at pos0 0, SDPA beside each
    b, s, ctx, layer, t5, slot = 8, 2048, 512, 5, 128, 3
    kc = randn(LAYERS, b, KV_HEADS, s, HD).to(torch.bfloat16)
    vc = randn(LAYERS, b, KV_HEADS, s, HD).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    span = torch.arange(s, device=dev)
    q = randn(b, KV_HEADS, REP, HD)
    kcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    vcur = randn(b, KV_HEADS, 1, HD).to(torch.bfloat16)
    pos = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    kw3 = dict(k_current=kcur, v_current=vcur, layer=layer)
    flash_decode(q, kc, vc, pos, **kw3)
    ns = flash_decode.last_pieces
    nbytes = 2 * b * KV_HEADS * ctx * HD * 2 + 2 * b * KV_HEADS * HD * 2 \
        + 2 * b * HEADS * HD * 4 + b * 4
    name3 = (f"bf16 B={b} KV={KV_HEADS} rep={REP} hd={HD} S={s} ctx={ctx} "
             f"ns={ns}")
    case("flash_decode", name3,
         lambda: flash_decode(q, kc, vc, pos, **kw3), (),
         floor_of(nbytes, 4 * b * HEADS * (ctx + 1) * HD, "bf16"))
    kl, vl = kc[layer].clone(), vc[layer].clone()
    kl[:, :, ctx], vl[:, :, ctx] = kcur[:, :, 0], vcur[:, :, 0]
    qh = q.reshape(b, HEADS, 1, HD).to(torch.bfloat16)
    mask = (span <= ctx).expand(b, 1, 1, s)
    cases.append((f"SDPA flash_decode {name3}", lambda: sdpa(
        qh, kl, vl, attn_mask=mask, enable_gqa=True), (), 0))
    q5 = randn(1, KV_HEADS, t5 * REP, HD)
    k5, v5 = kc[:, slot:slot + 1], vc[:, slot:slot + 1]
    pos0 = torch.zeros(1, dtype=torch.int32, device=dev)
    kw5 = dict(rep=REP, layer=layer)
    nbytes = 2 * q5.numel() * 4 + 4 + 2 * KV_HEADS * t5 * HD * 2
    name5 = f"bf16 B=1 KV={KV_HEADS} rep={REP} hd={HD} S={s} T={t5} pos0=0"
    case("flash_prefill", name5,
         lambda: flash_prefill(q5, k5, v5, pos0, **kw5), (),
         floor_of(nbytes, 4 * HEADS * HD * (t5 * (t5 + 1) // 2), "bf16"))
    qh5 = (q5.reshape(1, KV_HEADS, t5, REP, HD).transpose(2, 3)
           .reshape(1, HEADS, t5, HD).to(torch.bfloat16))
    keep5 = span[None, :] <= torch.arange(t5, device=dev)[:, None]
    kl5, vl5 = k5[layer], v5[layer]
    cases.append((f"SDPA flash_prefill {name5}", lambda: sdpa(
        qh5, kl5, vl5, attn_mask=keep5, enable_gqa=True), (), 0))
    for name, w in weights.items():
        a = fold_q8_1(quantize_q8_1(randn(128, w.k)))
        wb = layout.dequantize(w, torch.bfloat16)
        shape = f"{name} M=128 N={w.n} K={w.k}"
        case("gemm_dequant", shape, gemm_dequant, (w, a),
             gemm_floor(128, w, 2.0, "bf16"))
        cases.append((f"torch.matmul gemm_dequant {shape}", torch.matmul,
                      (a, wb.T), 0))
    t0 = time.perf_counter()
    med = bm.interleaved_medians(cases, reps=5, verbose=False)
    print(f"  (h2) harness.benchmark.interleaved_medians: {len(cases)} cases "
          f"x 5 rounds in {time.perf_counter() - t0:.1f} s (each rep the "
          f"median of 25 launches, L2 flushed) [{card}]", flush=True)
    phase_ms = {(r["kernel"], r["shape"]): r for r in kernel_rows
                if r["main"]}
    out = []
    for name, *_ in cases:
        if name not in floors:
            continue
        kernel, shape, (fl_ms, fl_by, _) = floors[name]
        ms = med[name] * 1e3
        lib = med.get(f"SDPA {name}", med.get(f"torch.matmul {name}"))
        row = phase_ms.get((kernel, shape))
        ratio = None if row is None else ms / row["ms"]
        out.append({"kernel": kernel, "shape": shape, "ms": ms,
                    "bound_ms": fl_ms, "bound_by": fl_by,
                    "library_ms": None if lib is None else lib * 1e3,
                    "phase_ms": None if row is None else row["ms"]})
        print(f"    {kernel:13s} {shape:48s} {ms:.5f} ms, roofline "
              f"{fl_ms:.5f} ms ({fl_by}, {fl_ms / ms:.1%})"
              + ("" if lib is None else f", library {lib * 1e3:.5f} ms")
              + ("" if row is None else f", kernel phase {row['ms']:.5f} ms"
                 f" (x{ratio:.3f})"), flush=True)
        if kernel in ("gemm_exact", "gemm_dequant") and ratio is not None \
                and not 1 / 1.3 <= ratio <= 1.3:
            fail(f"(h2) {kernel} {shape}: the harness's {ms:.5f} ms is not "
                 f"within 1.3x of the kernel phase's {row['ms']:.5f} ms")
    return out


def traced_replay(dev, card, counters, prompts, reuse):
    """(h3) The q4_0 Server at TinyLlama width with its CUDA graphs serves
    8 requests (launches counted from 0 and checked), then one replay of
    its most-replayed decode graph runs under ``profiling.trace``; the
    Chrome trace it wrote must hold each of the replay's K1, K2 and K3
    launches (3 x 22 + 1, 22, 22).  Returns the run's launches."""
    import tempfile

    from quant_gemm_tpu_torch.harness import profiling
    from quant_gemm_tpu_torch.models import llama, serve

    cfg = tinyllama_cfg()
    qp = llama.init_qparams(cfg, seed=17, device=dev)
    with graphs(True):
        srv = serve.Server(qp, cfg, n_slots=8, device=dev)
        results, launches, wall = drive(srv, prompts[:8], 16, counters)
    steps = srv.stats()["decode_steps"]
    n_chunks = chunks(prompts[:8], reuse[:8])
    check_launches(RUN_S17, launches, {
        "gemm_exact": steps * (3 * LAYERS + 1), "norm_qkv": steps * LAYERS,
        "flash_decode": steps * LAYERS,
        "gemm_dequant": (len(n_chunks) * 4 * LAYERS
                         + heads(prompts[:8], reuse[:8])),
        "flash_prefill": LAYERS * sum(t >= 64 for t in n_chunks),
        "gemm_exact_fused": 0, "attn_tail": 0, "gemm_exact_k16": 0})
    dec = max((g for k, g in srv.graphs.items() if k[0] == "decode"),
              key=lambda g: g.replays)
    info = {}
    for attempt in range(profiling.LEAD_TRIES):
        try:
            with tempfile.TemporaryDirectory() as tmp:
                with profiling.trace(tmp, info=info) as path:
                    dec.graph.replay()
                size = os.path.getsize(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            break
        except profiling.ProfileError as e:  # the window kept no lead
            print(f"  (h3) window {attempt + 1}: {e}; traced again",
                  flush=True)
    else:
        fail(f"(h3) {profiling.LEAD_TRIES} windows kept none of the lead")
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    keys = (("K1", "gemm_exact", "gemm_exact_kernel"),
            ("K2", "norm_qkv", "norm_qkv"),
            ("K3", "flash_decode", "flash_decode"))
    seen = {k: sum(key in n for n in kernels) for k, _, key in keys}
    # one replay's launches, as its capture counted them
    want = {k: dec.launches.get(c, 0) for k, c, _ in keys}
    print(f"  (h3) {RUN_S17}: 8 requests, {steps} decode steps in "
          f"{wall:.2f} s; profiling.trace of one replay of its most-replayed "
          f"decode graph ({dec.replays} replays): a Chrome trace of {size} "
          f"bytes, {len(events)} events, {len(kernels)} kernels, by kernel "
          f"{json.dumps(seen)} of the replay's {json.dumps(want)}; the "
          f"profiler dropped {info['lead_dropped']} kernels of the lead graph "
          f"at {time.perf_counter() - T_START:.0f} s of the process (deleted)"
          f" [{card}]", flush=True)
    if want != {"K1": 3 * LAYERS + 1, "K2": LAYERS, "K3": LAYERS}:
        fail(f"(h3) the decode graph does not launch a step's K1, K2, K3: "
             f"{want}")
    if seen != want:
        fail(f"(h3) the trace lost kernels of the replay: {seen} of {want}")
    return launches


def ring_worker(rank, store, dev, q):
    """One rank of (h4) (gloo, both ranks on the card); puts (rank, ok,
    result or traceback) on ``q``."""
    import traceback

    try:
        q.put((rank, True, ring_rank(rank, store, dev)))
    except BaseException:  # noqa: BLE001 - fail() exits; sent to the parent
        q.put((rank, False, traceback.format_exc()))
    q.close()
    q.join_thread()
    os._exit(0)


def ring_rank(rank, store, dev):
    from torch.profiler import ProfilerActivity, profile

    from quant_gemm_tpu_torch.formats.quant import quantize_q4_0
    from quant_gemm_tpu_torch.harness.aot import overlap_report
    from quant_gemm_tpu_torch.parallel import multihost
    from quant_gemm_tpu_torch.parallel import sharding as sh

    torch.cuda.set_device(dev)
    multihost.initialize(f"file://{store}", 2, rank, backend="gloo",
                         timeout_s=120)
    mesh = sh.make_mesh({"tp": 2}, device=dev)
    g = torch.Generator(device=dev).manual_seed(174)
    out = {}
    for name, mode, n, k in RING_CASES:
        w_q = quantize_q4_0(torch.randn(n, k, generator=g, device=dev)
                            * k ** -0.5)
        a = torch.randn(8, k, generator=g, device=dev)
        sw = sh.shard_weight_ring(w_q, mesh, mode=mode)
        ring = (sh.gemm_col_parallel_ring if mode == "col"
                else sh.gemm_row_parallel_ring)
        ring(sw, a, mesh)
        ring(sw, a, mesh, overlap=False)  # warm both
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            y = ring(sw, a, mesh)
            torch.cuda.synchronize()
        rep = overlap_report(prof)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yb = ring(sw, a, mesh, overlap=False)
            torch.cuda.synchronize()
        rep_b = overlap_report(prof)
        times = {"ring": [], "blocking": []}
        for i in range(2 * RING_REPS):  # turns: ring, blocking, ...
            which = ("ring", "blocking")[i % 2]
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring(sw, a, mesh, overlap=which == "ring")
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) * 1e3)
        out[name] = {"report": {k: v for k, v in rep.items()
                                if k != "hidden_by"},
                     "hidden_by": sorted(set(rep["hidden_by"])),
                     "blocking_report": {k: v for k, v in rep_b.items()
                                         if k != "hidden_by"},
                     "equal": bool(torch.equal(y, yb)),
                     "ms": statistics.median(times["ring"]),
                     "blocking_ms": statistics.median(times["blocking"])}
    out["host_copies"] = dict(sh.HOST_COPIES)
    return out


def ring_path(dev, card):
    """(h4) The ring GEMMs on two gloo ranks sharing the card: each call's
    ``overlap_report`` must show tp - 1 = 1 overlapped ppermute and none
    blocking, its output equal the blocking schedule's bit for bit; ms a
    call of both schedules (host clock, synchronized, median of
    ``RING_REPS`` in turns)."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=ring_worker,
                             args=(r, f"{tmp}/store", dev, q))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RING_TIMEOUT_S
        try:
            while len(res) < 2 and time.monotonic() < deadline:
                try:
                    rank, ok, val = q.get(timeout=5)
                except Exception:  # queue.Empty
                    if any(p.exitcode is not None and r not in res
                           for r, p in enumerate(procs)):
                        fail("(h4) a ring rank died without a result")
                    continue
                if not ok:
                    fail(f"(h4) ring rank {rank}:\n{val}")
                res[rank] = val
        finally:
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    if len(res) < 2:
        fail(f"(h4) the ring ranks did not finish in {RING_TIMEOUT_S} s")
    for rank in (0, 1):
        for name, *_ in RING_CASES:
            r = res[rank][name]
            print(f"  (h4) rank {rank} {name} M=8 tp=2 (gloo, host-copied "
                  f"ppermute): overlap_report {json.dumps(r['report'])} "
                  f"hidden by {r['hidden_by']}; {r['ms']:.3f} ms a call "
                  f"against the blocking schedule's {r['blocking_ms']:.3f} ms "
                  f"({json.dumps(r['blocking_report'])}); outputs bit-equal: "
                  f"{r['equal']} [{card}]", flush=True)
            rep, rep_b = r["report"], r["blocking_report"]
            if not (rep["overlapped"] == 1 and rep["blocking"] == 0
                    and r["equal"]):
                fail(f"(h4) rank {rank} {name}: not overlapped, or not the "
                     "blocking schedule's bits")
            if not (rep_b["blocking"] == 1 and rep_b["overlapped"] == 0):
                fail(f"(h4) rank {rank} {name}: overlap_report does not read "
                     "the blocking schedule as blocking")
        print(f"  (h4) rank {rank} host-copied collectives "
              f"{json.dumps(res[rank]['host_copies'])}", flush=True)
    return res


def codec_path(dev, card):
    """(h5) The host codec: every K-quant tensor of the Q4_K_M file at
    TinyLlama width decoded from its CPU bytes by ``native.py`` and by the
    port's torch decode, and from CUDA bytes by the torch decode, bit for
    bit; the three times (the file's bytes already read)."""
    from quant_gemm_tpu_torch import native
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats.gguf_file import GGUFFile

    t0 = time.perf_counter()
    if not native.k16_available():  # built here, outside the timed decodes
        fail("(h5) the host codec is not available (no C++ compiler)")
    t_build = time.perf_counter() - t0
    secs = {"codec": 0.0, "torch_cpu": 0.0, "torch_card": 0.0}
    n = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tinyllama-1.1b-q4_k_m-random.gguf"
        write_gguf_mix(path, "Q4_K_M", dev)
        with GGUFFile(path) as f:
            for name, info in f.tensors.items():
                qt = info["qtype"]
                if qt not in kquants.CODECS:
                    continue
                nbytes, decode, _ = kquants.CODECS[qt]
                rows, k = info["shape"]
                raw = torch.from_numpy(np.array(f.raw(name))).reshape(
                    rows, k // kquants.QK_K, nbytes)
                on_card = raw.to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                codec = getattr(native, f"{qt.lower()}_from_aos")(raw)
                t1 = time.perf_counter()
                cpu = decode(raw)
                t2 = time.perf_counter()
                card_out = decode(on_card)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                secs["codec"] += t1 - t0
                secs["torch_cpu"] += t2 - t1
                secs["torch_card"] += t3 - t2
                n += 1
                for a, b, c in zip(codec, cpu, card_out):
                    if not (torch.equal(a, b) and torch.equal(a, c.cpu())):
                        fail(f"(h5) {name} ({qt}): the host codec and the "
                             "torch decode differ")
    flags = " ".join(native.library()[1])
    print(f"  (h5) host codec ({flags}; ready in {t_build:.1f} s, built "
          f"at its first use in this process): {n} K-quant tensors of the "
          f"Q4_K_M file decoded from CPU bytes by the codec in "
          f"{secs['codec']:.3f} s and by the torch decode in "
          f"{secs['torch_cpu']:.3f} s ({torch.get_num_threads()} threads), "
          f"from CUDA bytes by the torch decode in {secs['torch_card']:.3f}"
          f" s; bit-equal [{card}]", flush=True)
    return {"tensors": n, **secs}


def specs_resolve():
    """(h6) Every solution's entry point resolves to a callable."""
    import json as js

    from quant_gemm_tpu_torch.specs import build_specs

    sols = sorted((build_specs.HERE / "solutions").glob("*.json"))
    for p in sols:
        s = js.loads(p.read_text())
        if not callable(build_specs.resolve(s["entry_point"])):
            fail(f"(h6) {p.name}: {s['entry_point']} is not callable")
    print(f"  (h6) {len(sols)} solutions, every entry point callable",
          flush=True)


def slice17_path(dev, counters, prompts, reuse, kernel_rows):
    """Slice 17: the gate, the harness, the trace, the overlapped rings,
    the host codec and the specs.  Returns the traced Server's
    launches."""
    card = card_line()
    t_start = time.perf_counter()

    def mark(what):
        print(f"[slice 17] + {what}: {time.perf_counter() - t_start:.1f} s",
              flush=True)

    gate(card)
    mark("(h1)")
    harness_rows(dev, card, kernel_rows)
    mark("(h2)")
    by_run = {RUN_S17: traced_replay(dev, card, counters, prompts, reuse)}
    mark("(h3)")
    gc.collect()
    torch.cuda.empty_cache()
    ring_path(dev, card)
    mark("(h4)")
    codec_path(dev, card)
    mark("(h5)")
    specs_resolve()
    mark("(h6) (budget 60 s)")
    return by_run


KERNEL_INFO = {
    "gemm_exact": ("quant_gemm_tpu_torch/csrc/gemm_exact.cu",
                   "quant_gemm_tpu/kernels/gemm_exact.py:775"),
    "norm_qkv": ("quant_gemm_tpu_torch/csrc/norm_qkv.cu",
                 "quant_gemm_tpu/kernels/gemm_megalayer.py:309"),
    "flash_decode": ("quant_gemm_tpu_torch/csrc/flash_decode.cu",
                     "quant_gemm_tpu/ops/attention.py:339"),
    "gemm_dequant": ("quant_gemm_tpu_torch/csrc/gemm_dequant.cu",
                     "quant_gemm_tpu/kernels/gemm_pallas.py:660"),
    "flash_prefill": ("quant_gemm_tpu_torch/csrc/flash_prefill.cu",
                      "quant_gemm_tpu/ops/attention.py:548"),
    "gemm_exact_k16": ("quant_gemm_tpu_torch/csrc/gemm_exact_k16.cu",
                       "quant_gemm_tpu/kernels/gemm_exact.py:1187"),
    "gemm_exact_fused": ("quant_gemm_tpu_torch/csrc/gemm_exact_fused.cu",
                         "quant_gemm_tpu/kernels/gemm_exact.py:995"),
    "attn_tail": ("quant_gemm_tpu_torch/csrc/attn_tail.cu",
                  "quant_gemm_tpu/kernels/gemm_megalayer.py:494"),
    "rms_norm_pallas": ("quant_gemm_tpu_torch/csrc/rms_norm.cu",
                        "quant_gemm_tpu/ops/rms_norm.py:56"),
    "softmax_pallas": ("quant_gemm_tpu_torch/csrc/softmax.cu",
                       "quant_gemm_tpu/ops/softmax.py:68"),
    # not TPU kernels: the one XLA fusion of JAX's standalone quantize
    "quantize_q8_1": ("quant_gemm_tpu_torch/csrc/act_quant.cu",
                      "none (not a TPU kernel; the XLA fusion of "
                      "quant_gemm_tpu/kernels/registry.py:148)"),
    "quantize_fold_q8_1": ("quant_gemm_tpu_torch/csrc/act_quant.cu",
                           "none (not a TPU kernel; the XLA fusion of "
                           "quant_gemm_tpu/kernels/registry.py:148)"),
}
# the run whose launches the kernels line reports: the default q4_0
# server's, or the first run that takes the kernel
LAUNCH_RUN = {"gemm_exact_k16": "Q4_K_M bf16", "gemm_exact_fused": RUN_A,
              "attn_tail": RUN_B, "rms_norm_pallas": RUN_SPEC,
              "softmax_pallas": RUN_SPEC}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from quant_gemm_tpu_torch.harness.profiling import ProfileError

    try:
        return run()
    except ProfileError as e:
        fail(str(e))


def run() -> int:
    from quant_gemm_tpu_torch.harness import aot
    from quant_gemm_tpu_torch.harness.benchmark import DeviceTimer
    from quant_gemm_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    built = _build.build()
    print(f"kernel build: {built['seconds']:.1f} s "
          f"({', '.join(_build.source_names())})", flush=True)
    for line in aot.format_report(aot.resource_report(
            dict(_build.BUILD_LOG))).splitlines():
        if not line.startswith(" "):  # a source's line; (h1) lists entries
            print(f"  ptxas {line}", flush=True)

    timer = DeviceTimer(dev)
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[phase] {name}: {now - t_phase:.1f} s", flush=True)
        t_phase = now

    print("kernel phase:", flush=True)
    rows = kernel_phase(dev, timer)
    phase_done("kernel phase")
    counters = launch_counters()
    prompts, reuse = traffic(np.random.default_rng(0))
    by_run = main_path(dev, counters, prompts, reuse)
    phase_done("main path (TinyLlama q4_0)")
    by_run.update(q4_k_m_path(dev, counters, prompts, reuse))
    phase_done("Q4_K_M path")
    torch.cuda.empty_cache()
    by_run.update(formats_path(dev, counters, prompts, reuse))
    phase_done("formats path (slice 7)")
    foreign_bytes(dev)
    phase_done("foreign bytes")
    torch.cuda.empty_cache()
    by_run[RUN_M1] = mistral_path(dev, counters)
    phase_done("Mistral path")
    torch.cuda.empty_cache()
    print("spec phase:", flush=True)
    by_run[RUN_SPEC] = spec_phase(dev, counters)
    phase_done("spec phase")
    torch.cuda.empty_cache()
    by_run.update(qwen_path(dev, counters))
    phase_done("GGUF user path (slice 14, Qwen2.5-1.5B width)")
    torch.cuda.empty_cache()
    by_run.update(slice15_path(dev, counters, prompts, reuse))
    phase_done("slice 15 (W4A16, LoRA, speculative, perplexity, HF loader,"
               " api/compat)")
    torch.cuda.empty_cache()
    by_run.update(slice16_path(dev, counters, prompts, reuse))
    phase_done("slice 16 (QAT, tensor parallelism)")
    torch.cuda.empty_cache()
    by_run.update(slice17_path(dev, counters, prompts, reuse, rows))
    phase_done("slice 17 (gate, harness, trace, rings, host codec, specs)")

    kernels = []
    for name, (src, rep) in KERNEL_INFO.items():
        every = [r for r in rows if r["kernel"] == name]
        mine = [r for r in every if r["main"]]
        lib = [r["library_ms"] for r in mine]
        run = LAUNCH_RUN.get(name, "q4_0 bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": by_run[run][name],
            "launches_by_run": {r: n[name] for r, n in by_run.items()},
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            "library_ms": None if None in lib else sum(lib),
            "variants": [{k: r.get(k) for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "layout_bound_ms", "library_ms", "max_abs_err",
                "unfused_ms", "k1_ms", "k6_ms", "k1_q8_0_ms")}
                for r in every if not r["main"]]})
        for key in ("unfused_ms", "k1_ms", "k6_ms", "k1_q8_0_ms"):
            if any(key in r for r in mine):
                kernels[-1][key] = sum(r[key] for r in mine)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
