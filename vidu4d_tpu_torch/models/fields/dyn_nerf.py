"""Dynamic-field helpers (`vidu4d_tpu/models/fields/dyn_nerf.py`).

Only `flip_pair` is ported so far: the Stage-3 flow loss uses it. The
deformable VolSDF field of Stage 2 is later work.
"""

from __future__ import annotations


def flip_pair(x):
    """Swap consecutive frame pairs along the leading axis
    (`dyn_nerf.py:71`). Works on tensors, (nested) tuples such as dual
    quaternions, and dicts of them."""
    if isinstance(x, tuple):
        return tuple(flip_pair(t) for t in x)
    if isinstance(x, dict):
        return {k: flip_pair(v) for k, v in x.items()}
    if x.shape[0] < 2:
        return x
    y = x.reshape((x.shape[0] // 2, 2) + tuple(x.shape[1:]))
    return y.flip(1).reshape(x.shape)
