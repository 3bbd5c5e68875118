"""The plain reference against the program at a tiny width on the CPU
(the test imports the program; the reference does not): its block
decoders against the program's, its forward against the program's own
float32 forward on the same weights, and against the W4A8 path the
benchmark serves."""

import ast
from pathlib import Path

import numpy as np
import torch

from port_bench import weights
from port_bench.reference import blocks, model as ref

from . import tiny

REF = Path(__file__).resolve().parents[1] / "reference"


def test_reference_imports_neither_jax_nor_the_program():
    for path in REF.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "quant_gemm_tpu",
                                   "quant_gemm_tpu_torch", "port_bench"), \
                    (path.name, n)


def test_block_decoders_match_the_programs():
    from quant_gemm_tpu_torch.formats import kquants
    from quant_gemm_tpu_torch.formats import quant as tq
    from quant_gemm_tpu_torch.formats.gguf_file import from_block_bytes

    g = torch.Generator().manual_seed(3)
    raw = weights.draw("q4_0", 48, 512, 1.0, g, "cpu")
    assert torch.equal(blocks.q4_0(raw),
                       tq.dequantize(from_block_bytes(raw, "q4_0")))
    raw = weights.draw("q6_K", 40, 768, 1.0, g, "cpu")
    assert torch.equal(blocks.q6_K(raw),
                       kquants.dequantize_q6_k(kquants.from_bytes_q6_k(raw)))


def _setup(tmp_path, seed=5):
    cell = tiny.cell(tmp_path)
    model = weights.Model(cell.config, seed, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 512, 300).tolist()
    return cell, model, seq


def test_reference_matches_the_programs_float32_forward(tmp_path):
    from quant_gemm_tpu_torch.models import llama

    cell, model, seq = _setup(tmp_path)
    rw = weights.ReferenceWeights(model)
    arch = cell.arch.reference_arch(cell.config)
    want = ref.logits(arch, rw, [seq], [list(range(len(seq)))])[0]
    layers = []
    for i in range(arch.n_layers):
        w = rw.layer(i)
        layers.append({k: w[k] for k in ("attn_norm", "wq", "wk", "wv",
                                          "wo", "mlp_norm", "bq", "bk",
                                          "bv", "w_down")}
                      | {"w_gate": w["w_gate"], "w_up": w["w_up"]})
    params = {"embed": rw.embed(torch.arange(512)), "layers": layers,
              "final_norm": rw.final_norm(), "lm_head": rw.head()}
    cfg = cell.arch.llama_config(cell.config)
    cache = llama.KVCache.init(cfg, 1, device="cpu")
    got = llama.forward_float(params, cfg, torch.tensor([seq]), cache)[0][0]
    # the same float32 model but for the program's bf16 cache (k and v
    # rounded to 8 bits of mantissa): within 1% of the logits' scale
    # (0.27% seen); a wrong rotary pair, head map or bias would read
    # tens of percent
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-2, float(err)
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) > 0.98


def test_reference_against_the_served_w4a8_path(tmp_path):
    from quant_gemm_tpu_torch.models import llama

    cell, model, seq = _setup(tmp_path, seed=9)
    arch = cell.arch.reference_arch(cell.config)
    want = ref.logits(arch, weights.ReferenceWeights(model), [seq],
                      [list(range(len(seq)))])[0]
    qp = weights.program_params(model)
    cfg = cell.arch.llama_config(cell.config)
    cache = llama.KVCache.init(cfg, 1, device="cpu")
    got = llama.forward(qp, cfg, torch.tensor([seq]), cache)[0][0]
    # Q8_1 activations round each linear map's input by about 0.5% of its
    # scale and the cache is bf16: a few percent of the logits' norm
    rel = float((got - want).norm() / want.norm())
    assert rel < 0.05, rel
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert agree > 0.9, agree
    # and the control's 4-bit activations are far worse
    ctl = ref.logits(arch, weights.ReferenceWeights(model), [seq],
                     [list(range(len(seq)))], bits=4)[0]
    assert float((ctl - want).norm() / want.norm()) > 4 * rel
