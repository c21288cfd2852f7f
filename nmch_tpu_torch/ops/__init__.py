"""FE step math, its plain PyTorch golden and the CUDA kernel wrapper."""
