"""Quantized Llama forward, sampling, serving, weight conversion."""
