"""FE and EM step math, their plain PyTorch goldens, the plain sweeps and
the CUDA kernel wrappers."""
