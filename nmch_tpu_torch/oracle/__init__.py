from .black_scholes import norm_cdf_as, norm_cdf, reference_true_price, bs_call
from .heston import heston_call, heston_call_undiscounted

__all__ = ["norm_cdf_as", "norm_cdf", "reference_true_price", "bs_call",
           "heston_call", "heston_call_undiscounted"]
