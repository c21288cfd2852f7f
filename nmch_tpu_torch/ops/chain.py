"""The element-op chain of ``benchmarks/bf16_probe.py`` (TPU kernel K8), in
plain PyTorch.

``nmch_tpu``'s probe asks whether packed bf16 raises the elementwise
issue rate over float32: a kernel runs K iterations of an 8-op
mul/add/abs chain (the FE step's op mix without transcendentals) plus a
tail (abs, sqrt or rsqrt) on a resident (rows, 128) tile.  The card's
kernel (``csrc/chain_probe.cu``, ``ops/chain_cuda.py``) runs the same
body; this module is its plain version, op by op in the tensor's dtype
with the probe's two constants.  They are exactly representable in
float32 only: in bf16 both round to 1.0, as ``jnp.asarray(c, bfloat16)``
rounds them in the probe, so the bf16 chain runs the same ops on other
values.

The square root is rounded once to float32 (``sqrt_f32``; torch's CPU
float32 sqrt is not always correctly rounded), then to the dtype, as
XLA computes a bf16 sqrt; the reciprocal root is ``torch.rsqrt`` in
float32, then rounded to the dtype.
"""

from __future__ import annotations

import torch

from ..rng.normal import sqrt_f32

K = 4096          # iterations (bf16_probe.py:41)
OPS = 8           # chain ops per iteration and element (bf16_probe.py:42)
ELEMENT_OPS = OPS + 1   # with the tail, per element-iteration (:97-98)
C = 1.0009765625  # 1 + 2^-10 (bf16_probe.py:51-52; 1.0 in bf16)
D = 0.9990234375
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ROWS = {"f32": 128, "bf16": 256}   # the probe's tiles (bf16_probe.py:104)
TAILS = ("alu", "sqrt", "rsqrt")   # (with_sqrt, rsqrt) = (F, F), (T, F), (T, T)


def tail_name(with_sqrt: bool, rsqrt: bool) -> str:
    return "alu" if not with_sqrt else ("rsqrt" if rsqrt else "sqrt")


def check_chain(x, K: int) -> str:
    """Validate a chain input; returns its dtype's name ("f32"/"bf16")."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2 \
            or x.shape[1] != 128 or x.dtype not in DTYPES.values():
        raise ValueError("x must be a float32 or bfloat16 tensor of shape "
                         "(rows, 128)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (row-major (rows, 128))")
    if x.shape[0] == 0:
        raise ValueError("x must have at least one row")
    if not 0 <= int(K) < 2**31:
        raise ValueError(f"K={K} must be in [0, 2^31)")
    return "f32" if x.dtype == torch.float32 else "bf16"


def chain_plain(x: torch.Tensor, *, K: int = K, with_sqrt: bool,
                rsqrt: bool = False) -> torch.Tensor:
    """K iterations of ``_chain_kernel``'s body on x, op by op in x's
    dtype; ``rsqrt`` is read only with ``with_sqrt``, as in the probe."""
    check_chain(x, K)
    one, c, d = (torch.tensor(v, dtype=x.dtype, device=x.device)
                 for v in (1.0, C, D))
    for _ in range(int(K)):
        x = x * c
        x = x + d
        x = x * d
        x = torch.abs(x - one)
        x = x * c + d          # two roundings, as the kernel's two ops
        x = x * d
        x = x - one
        if with_sqrt:
            ax = (torch.abs(x) + one).float()
            x = (torch.rsqrt(ax) if rsqrt else sqrt_f32(ax)).to(x.dtype)
        else:
            x = torch.abs(x)
    return x
