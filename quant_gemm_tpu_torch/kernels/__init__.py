"""Device layout, CUDA kernel wrappers, build, and GEMM dispatch."""
