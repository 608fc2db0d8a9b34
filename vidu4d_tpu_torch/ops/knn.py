"""K-nearest-neighbour distances (`vidu4d_tpu/ops/knn.py`).

Used once at surfel init to set initial scales: mean *squared* distance to
the k nearest neighbours (the reference's ``distCUDA2``). A chunked
distance matrix plus ``topk`` is enough at that call frequency.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk_size: int = 512) -> torch.Tensor:
    """(N, 3) points -> (N,) mean squared distance to the k nearest
    neighbours (excluding the point itself). N must be > k.

    Distances use the JAX package's |q|^2 + |p|^2 - 2 q.p form (clamped at
    0), one (chunk_size, N) block of query rows at a time."""
    n = points.shape[0]
    c_sq = torch.sum(points * points, dim=-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, chunk_size):
        q = points[s:s + chunk_size]
        d2 = (torch.sum(q * q, dim=-1, keepdim=True) + c_sq[None, :]
              - 2.0 * (q @ points.T))
        d2 = torch.clamp(d2, min=0.0)
        best = torch.topk(d2, k + 1, dim=-1, largest=False, sorted=True).values
        # k+1 keeps the self-distance (the smallest entry); drop it
        out[s:s + chunk_size] = best[:, 1:].mean(dim=-1)
    return out
