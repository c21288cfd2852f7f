"""Forward-Euler Heston payoffs, the plain reference of the FE pricers.

Per step, with normals (g1, g2) (edo01/NMCH ``NMCH_FE.cu:41-48``):

    S <- S (1 + r dt + sqrt(v) (rho sqrt(dt) g1 + sqrt(1 - rho^2) sqrt(dt) g2))
    v <- | (1 - k dt) v + k theta dt + sqrt(v) sigma sqrt(dt) g1 |

Counter block j of a path's stream gives four half-circle normals: (0, 1)
drive step 2j, (2, 3) step 2j + 1.  The payoff is (S_T - K)^+ with K =
S_0.  The loop constants are float32 values rounded as the kernel rounds
them (``fe_constants``); each step is the plain version's float32
operations in its order.

Points ride the leading axis: P parameter rows, each at its own epoch,
over paths 0..n_paths-1.  The normals of ``chunk`` blocks are made at
once, then the steps run one by one.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import BlockWindow, normal_pair_hc, sqrt_f32

PARAM_KEYS = ("T", "S_0", "v_0", "r", "k", "rho", "theta", "sigma")


def param_rows(points: list[dict]) -> np.ndarray:
    """float32 (P, 8) rows (T, S_0, v_0, r, k, rho, theta, sigma)."""
    return np.array([[p[k] for k in PARAM_KEYS] for p in points],
                    dtype=np.float32)


def fe_constants(rows: np.ndarray, N: int) -> dict:
    """Each point's S_0, v_0 and step constants as float32 (P,) arrays:
    dt = T / N and sqrt(dt) in IEEE float32, as the kernel takes them."""
    T, S_0, v_0, r, k, rho, theta, sigma = rows.T
    dt = T / np.float32(N)
    sqrt_dt = np.sqrt(dt)
    sqrt_rho_c = np.sqrt(np.float32(1.0) - rho * rho)
    return {"S_0": S_0, "v_0": v_0,
            "A": k * theta * dt, "B": np.float32(1.0) - k * dt,
            "C": sigma * sqrt_dt, "rho_sd": rho * sqrt_dt,
            "rhoc_sd": sqrt_rho_c * sqrt_dt,
            "one_rdt": np.float32(1.0) + r * dt}


def fe_payoffs(rows: np.ndarray, key: tuple[int, int], epochs, N: int,
               n_paths: int, device, dtype=torch.float32,
               chunk: int = 16):
    """float32 (P, n_paths) payoffs of P points, point p at epochs[p]."""
    P = rows.shape[0]
    cst = {name: torch.from_numpy(v.copy()).to(device).reshape(P, 1)
           .to(dtype) for name, v in fe_constants(rows, N).items()}
    ep = torch.tensor([int(e) for e in epochs], dtype=torch.int64,
                      device=device).reshape(P, 1)
    path = torch.arange(n_paths, dtype=torch.int64,
                        device=device).reshape(1, n_paths)
    ones = torch.ones(P, n_paths, device=device, dtype=dtype)
    S, v = ones * cst["S_0"], ones * cst["v_0"]
    n_blocks = (N + 1) // 2
    window = BlockWindow(ep, path, key, width=chunk)
    ctr = torch.zeros(P, n_paths, dtype=torch.int64, device=device)
    for j0 in range(0, n_blocks, chunk):
        c = min(chunk, n_blocks - j0)
        w0, w1, w2, w3 = window.words(ctr + j0, c)
        g0, g1 = normal_pair_hc(w0, w1)
        g2, g3 = normal_pair_hc(w2, w3)
        g = [x.to(dtype) for x in (g0, g1, g2, g3)]
        for i in range(c):
            S, v = _step(S, v, g[0][i], g[1][i], cst)
            if 2 * (j0 + i) + 1 < N:
                S, v = _step(S, v, g[2][i], g[3][i], cst)
    return torch.clamp_min(S - cst["S_0"], 0.0).float()


def _step(S, v, g1, g2, c):
    sqv = sqrt_f32(v.float()).to(v.dtype)
    zc = c["rho_sd"] * g1 + c["rhoc_sd"] * g2
    S = S * (c["one_rdt"] + sqv * zc)
    v = torch.abs(c["B"] * v + c["A"] + sqv * (c["C"] * g1))
    return S, v


def moments(payoff):
    """Each row's (E[X], E[X^2]): X and X^2 in float32, summed in float64."""
    n = payoff.shape[-1]
    return (payoff.double().sum(-1) / n,
            (payoff * payoff).double().sum(-1) / n)


def payoffs(config: dict, rows: np.ndarray, key: tuple[int, int], epochs,
            n_paths: int, device, dtype=torch.float32):
    """(payoffs, counts) of the configuration, as every method's reference
    gives them; FE counts nothing data-dependent."""
    return fe_payoffs(rows, key, epochs, config["N"], n_paths, device,
                      dtype), {}
