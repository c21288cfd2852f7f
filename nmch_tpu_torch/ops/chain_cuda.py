"""The issue-rate probe's chain through the hand-written CUDA kernel
``csrc/chain_probe.cu``.

The counterpart of ``benchmarks/bf16_probe.py::chain`` (kernel K8): K
iterations of the probe's 8-op chain and a tail on a (rows, 128) float32
or bf16 tile.  float32 runs one element per thread; bf16 runs one packed
bf16x2 word, two elements, per thread: the card's counterpart of the
probe's question, whether packed bf16 doubles the elementwise rate.  The
tile stays in registers for all K iterations.  On a CUDA tensor the
wrapper launches the kernel or raises (``CapabilityError`` on a card
below compute capability 9.0, for which the library holds no code); on a
CPU tensor it runs the plain version, ``ops/chain.py::chain_plain``.
"""

from __future__ import annotations

import torch

from .chain import K, TAILS, chain_plain, check_chain, tail_name
from .launch import call_kernel, check_device, count_launch

_DTYPE_CODE = {"f32": 0, "bf16": 1}


class CapabilityError(RuntimeError):
    """The card lacks what the kernel was built for (sm_90a)."""


def chain_cuda(x: torch.Tensor, *, K: int = K, with_sqrt: bool,
               rsqrt: bool = False) -> torch.Tensor:
    """K chain iterations on x; a new tensor of x's shape, dtype and
    device.

    x: float32 or bfloat16 (rows, 128) contiguous; ``rsqrt`` is read only
    with ``with_sqrt``, as in the probe.  Each launch adds one to
    ``chain_cuda.launches`` and to ``variant_launches["chain_<dtype>_
    <alu|sqrt|rsqrt>"]``."""
    dtype = check_chain(x, K)
    if check_device(x.device).type == "cpu":
        return chain_plain(x, K=K, with_sqrt=with_sqrt, rsqrt=rsqrt)
    cap = torch.cuda.get_device_capability(x.device)
    if cap < (9, 0):
        raise CapabilityError(f"compute capability {cap[0]}.{cap[1]}: the "
                              f"chain kernels are built for sm_90a only")
    tail = tail_name(with_sqrt, rsqrt)
    name = f"chain_{dtype}_{tail}"
    out = torch.empty_like(x)
    call_kernel("nmch_chain", name, x.device, x.data_ptr(), out.data_ptr(),
                x.numel(), _DTYPE_CODE[dtype], TAILS.index(tail), int(K))
    count_launch(chain_cuda, name)
    return out


chain_cuda.launches = 0
chain_cuda.variant_launches = {}
