"""The CUDA kernel of the PyTorch port on a card (marker ``cuda``).

These tests skip without a CUDA card.  They import neither jax nor
nmch_tpu, so they run on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from nmch_tpu_torch import HestonParams, NMCH_FE, SimConfig
from nmch_tpu_torch.ops.fe import fe_moments_scan, path_index_grid
from nmch_tpu_torch.ops.fe_cuda import fe_moments_cuda
from nmch_tpu_torch.oracle import heston_call_undiscounted

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("N,epoch,base", [(11, 0, 0), (12, 3, 1 << 14)])
def test_kernel_matches_plain_and_is_deterministic(dev, N, epoch, base):
    pv = HestonParams().as_tensor("cpu")
    key = (1234, 0)
    before = fe_moments_cuda.launches
    k1 = torch.stack(fe_moments_cuda(pv, key, epoch, base, N=N,
                                     n_paths=1 << 14, device=dev))
    k2 = torch.stack(fe_moments_cuda(pv, key, epoch, base, N=N,
                                     n_paths=1 << 14, device=dev))
    assert fe_moments_cuda.launches == before + 2
    assert torch.equal(k1, k2)
    p = torch.stack(fe_moments_scan(pv.to(dev), N,
                                    path_index_grid(1 << 14, base, dev),
                                    epoch, *key))
    torch.testing.assert_close(k1, p, rtol=1e-6, atol=0)


def test_main_path_prices_within_oracle_bar(dev):
    m = NMCH_FE(SimConfig(NB=128, N=200), HestonParams(), device=dev)
    m.init(1234)
    res = m.compute()
    bar = 3 * res.ci_error + 2e-3
    assert abs(res.price - heston_call_undiscounted(m.params)) <= bar
