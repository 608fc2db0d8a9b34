"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test makes its inputs with numpy from a seed, runs them through
the JAX reference (on the CPU, as the JAX tests run it) and through the
port, and compares the results as numpy arrays.
"""

import numpy as np
import torch

# pytest-xdist runs several workers at once: keep each one's torch CPU pool
# small so they do not oversubscribe the cores
torch.set_num_threads(2)


def t(x, requires_grad: bool = False, device="cpu") -> torch.Tensor:
    """numpy / JAX array -> a fresh float32 (or int/bool) torch tensor."""
    arr = np.array(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    out = torch.tensor(arr, device=device)
    return out.requires_grad_(True) if requires_grad else out


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(ref, got, atol, rtol=0.0, name=""):
    np.testing.assert_allclose(n(got), n(ref), atol=atol, rtol=rtol, err_msg=name)


def assert_close_to_max(ref, got, rel, name=""):
    """max |got - ref| <= rel * max |ref|: for gradients whose entries span
    many magnitudes and whose sums run in another order."""
    ref, got = n(ref), n(got)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= rel * scale + 1e-30, f"{name}: max|diff| {err} > {rel} * {scale}"


def assert_close_per_column(ref, got, rel, floor_rel, name=""):
    """In each column c of (E, K) arrays: max |got_c - ref_c| <= rel *
    max |ref_c| + floor_rel * max |ref|. For grad slabs whose columns
    differ by orders of magnitude, so that a small column cannot hide
    under a large one's bound."""
    ref, got = n(ref), n(got)
    err = np.abs(got - ref).max(axis=0)
    scale = np.abs(ref).max(axis=0)
    bound = rel * scale + floor_rel * scale.max()
    bad = np.flatnonzero(err > bound)
    assert bad.size == 0, f"{name}: columns {bad}: max|diff| {err[bad]} > {bound[bad]}"


def make_scene(rng, n=200, spread=0.8, res=64, frames=1):
    """Random surfel cloud in front of a pinhole camera (numpy, float32):
    means (F, P, 3), quats (F, P, 4), scales (P, 2), opacity (P,),
    colours (F, P, 3), intrinsics (F, 4)."""
    means = rng.normal(size=(n, 3)) * spread + np.array([0.0, 0.0, 3.0])
    means = np.stack([means + f * np.array([0.1, -0.05, 0.2]) for f in range(frames)])
    quats = rng.normal(size=(frames, n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.normal(size=(n, 2)) * 0.5) * 0.05
    opac = 1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))
    colors = rng.uniform(size=(frames, n, 3))
    intrins = np.tile([res * 60.0 / 64, res * 60.0 / 64, res / 2.0, res / 2.0], (frames, 1))
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(map(f32, (means, quats, scales, opac, colors, intrins)))
