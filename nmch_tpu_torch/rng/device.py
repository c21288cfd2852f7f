"""The card's own generator, ``rng="device"``: a tagged Philox stream.

The counterpart of the TPU kernels' hardware generator
(``pltpu.prng_seed``/``prng_random_bits`` in ``nmch_tpu/ops/
fe_pallas.py`` and ``sweep_pallas.py``, ``rng="tpu"``).  The TPU's
bitstream is defined by its hardware and cannot be reproduced, so the
card draws its own deterministic stream instead: Philox4x32-10 under the
run's key (k0, k1) at counter (i, epoch, path, "DPRG").  The ASCII tag in
the path_hi word keeps it apart from every other Philox plane of the
port: the path streams use path_hi = 0, the Sobol' randomizations "SOBL",
"LMS\\0"+k and "OWEN" (``rng/sobol.py``).

Words are consumed in order, 4 per Philox call: a counter block of the
FE scheme takes 4 words (box hc or turns: block j is call j,
``device_call``) or 3 (the packed-phase boxes hc16/hc16f: block j takes
words 3j, 3j+1, 3j+2, so 3 calls feed 4 blocks, ``packed_blocks``).
``csrc/counter_rng.cuh`` (``kDevice``) and ``csrc/fe_path.cuh`` draw the
same words in the same order.
"""

from __future__ import annotations

from .philox import philox4x32

TAG = 0x44505247          # "DPRG", the path_hi word of every device call


def device_call(i, epoch, path, k0, k1):
    """The 4 words of Philox call i of each path's device stream."""
    return philox4x32(i, epoch, path, TAG, k0, k1)


def packed_blocks(epoch, path, k0, k1):
    """Block index -> the 3 words of counter block j of each path's device
    stream, for the packed boxes hc16/hc16f: stream words 3j, 3j+1, 3j+2,
    4 words a call.  Calls for j = 0, 1, ... in order reuse the last
    Philox call, so each call runs once."""
    last = {}

    def call(i):
        if i not in last:
            last.clear()
            last[i] = device_call(i, epoch, path, k0, k1)
        return last[i]

    def block(j: int):
        return tuple(call(w // 4)[w % 4] for w in range(3 * j, 3 * j + 3))
    return block
