"""PyTorch/CUDA port of quant_gemm_tpu for NVIDIA Hopper (H100, sm_90a).

The W4A8 q4_0 continuous-batching server of the JAX package
(``quant_gemm_tpu``, the reference) on hand-written CUDA kernels:

* ``formats``  — llama.cpp block containers, the numpy golden, and torch
  quantizers bit-equal to it;
* ``kernels``  — the q4_0 device layout, the CUDA kernels' wrappers (each
  with its plain PyTorch version and a launch count) and GEMM dispatch;
* ``ops``      — RMSNorm, RoPE, SiLU (plain torch) and flash-decode;
* ``models``   — the quantized Llama forward, sampling, the serving loop,
  and conversion of the JAX package's prepared weights.

The package imports neither ``jax`` nor ``quant_gemm_tpu``.  Entry points
run on ``device="cuda"`` unless the caller asks for the CPU, where every
kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
