"""Conditioning analysis (paper §4, Theorems 1-2).

FedSubAvg is a static diagonal preconditioner ``D = diag(N / n_m)``:
optimizing ``f`` with FedSubAvg approximates gradient descent on ``f_hat(Xh)
= f(D^{1/2} Xh)``, whose Hessian is ``D^{1/2} H D^{1/2}``. These helpers
measure both condition numbers on small problems, so that the theorems can
be checked.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def condition_number(h: torch.Tensor, eps: float = 0.0) -> float:
    """kappa(H) = sigma_max / sigma_min by SVD (H need not be PSD); a host
    float, so it reads the result back."""
    s = torch.linalg.svdvals(h)
    return float(s[0] / torch.clamp(s[-1], min=eps))


def preconditioned_hessian(h: torch.Tensor, counts, total: float) -> torch.Tensor:
    """``D^{1/2} H D^{1/2}`` with ``D = diag(total / counts)``; rows no
    client involves get 0."""
    counts = torch.as_tensor(counts, dtype=torch.float32, device=h.device)
    total_t = torch.tensor(total, dtype=torch.float32, device=h.device)
    d_half = torch.where(counts > 0, torch.sqrt(total_t / torch.clamp(counts, min=1.0)),
                         0.0)
    return h * d_half[:, None] * d_half[None, :]


def hessian_of(loss: Callable, x: torch.Tensor) -> torch.Tensor:
    """The Hessian of a scalar ``loss`` at ``x`` (``torch.func.hessian``)."""
    return torch.func.hessian(loss)(x)


def measured_dispersion_bound(h: torch.Tensor, counts, rho2: float) -> float:
    """Theorem 1's floor, kappa(H) >= n_max (rho1 - alpha (rho1 + rho2)) /
    (n_min rho2): returns n_max / n_min, the Theta() driver of the bound,
    to compare with the measured condition number."""
    c = np.asarray(counts, dtype=np.float64)
    nz = c[c > 0]
    return float(nz.max() / nz.min()) if nz.size else float("inf")
