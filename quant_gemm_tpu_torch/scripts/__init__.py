"""Entry points: ``python -m quant_gemm_tpu_torch.scripts.generate`` (text
from one GGUF file) and ``python -m quant_gemm_tpu_torch.scripts.server``
(the llama-server-style HTTP front end)."""
