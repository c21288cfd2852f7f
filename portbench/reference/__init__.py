"""The benchmark's plain reference: the same prices as the program, worked
out again in plain PyTorch from the seed and the inputs alone.

A frozen copy of the port's plain goldens (its Philox4x32-10 streams, the
half-circle and turns Box-Muller normals, the Euler step, the Broadie-Kaya
samplers and step, the exploration grid, the semi-analytic oracle), written
so that it imports neither ``jax`` nor ``nmch_tpu`` nor anything of
``nmch_tpu_torch``.  Every float operation is the plain version's float32
operation in the same order, so on the card each path's payoff is the
kernel's; only the order of the float64 sums differs.  What differs from
the plain versions is how the work is laid out, never what is computed:
Philox blocks are made in bulk (``rng.BlockWindow``) and the rejection
samplers try several rounds at once, taking for each lane the first round
it accepts (``em.py``), which leaves each lane's draws, result and final
counter as they were.

``dtype`` (``torch.bfloat16``) runs the path state and its step arithmetic
one precision lower: the benchmark's control, which its comparison has to
refuse.
"""
