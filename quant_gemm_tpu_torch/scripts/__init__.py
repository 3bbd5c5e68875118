"""Entry points: ``python -m quant_gemm_tpu_torch.scripts.generate`` (text
from one GGUF file), ``python -m quant_gemm_tpu_torch.scripts.server``
(the llama-server-style HTTP front end) and ``python -m
quant_gemm_tpu_torch.scripts.perplexity`` (perplexity of a text file)."""
