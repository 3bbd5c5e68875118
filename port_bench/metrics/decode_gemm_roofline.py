"""The decode steps' linear maps and head against their roofline (%): the
least time of the traced stretch's decode steps' W4A8 GEMMs (the
architecture's ``decode_gemms``: weights at llama.cpp block bytes, Q8_1
inputs, float32 outputs, int8 operations) over the device time of the
GEMM kernels (the hand ones, the Q8_1 quantize that feeds them, library
matmuls) launched in the stretch's decode replays."""

#: parts of the names of the kernels that run linear maps
GEMM_NAMES = ("gemm", "gemv", "norm_qkv", "attn_tail", "act_quant", "xmma",
              "cutlass")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_seconds("port_bench.decode", GEMM_NAMES)
    b = sum(run.shapes.decode_gemms(len(s.contexts)).bound_s()
            for s in run.trace_steps if s.contexts)
    return 100.0 * b / t if t > 0 and b > 0 else None
