"""The prefill chunks' linear maps against their roofline (%): the least
time of the traced stretch's chunks' W4A8 GEMMs (the architecture's
``chunk_gemms``: real tokens only, the head over the one row whose logits
are used) over the device time of the GEMM kernels (the hand ones, the
Q8_1 quantize, library matmuls) launched in the stretch's chunk
replays."""

GEMM_NAMES = ("gemm", "gemv", "norm_qkv", "attn_tail", "act_quant", "xmma",
              "cutlass")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_seconds("port_bench.chunk", GEMM_NAMES)
    b = sum(run.shapes.chunk_gemms(n, last).bound_s()
            for s in run.trace_steps
            for r in s.admitted for _, n, last in run.chunks(r))
    return 100.0 * b / t if t > 0 and b > 0 else None
