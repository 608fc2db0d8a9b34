"""Numerical helpers shared across the port (`vidu4d_tpu/ops/numerics.py`)."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a zero subgradient at x = 0.

    ``torch.linalg.norm`` backpropagates NaN at exactly zero (0/0).
    sqrt(max(sum(x^2), eps^2)) is the JAX package's form: the clamp's
    gradient is 0 below eps^2, so the chain through sqrt never sees 0.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-12) -> torch.Tensor:
    """x / ||x|| with NaN-free gradients at 0 (returns ~0 there)."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)
