"""Invertible dense warp of RealNVP affine couplings
(`vidu4d_tpu/models/fields/nvp.py`): ``fg_motion`` "nvp".

A stack of couplings over the 3 coordinates, conditioned on a time code:
exactly invertible, so the forward and the backward warp share one set of
parameters. The layers keep flax's names (``couplings_<i>``, each with
``Dense_0`` .. ``Dense_2``), so that `vidu4d_tpu_torch.convert` maps them
one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.models.fields.embeddings import TimeEmbedding


class _Coupling(nn.Module):
    """Affine coupling (`nvp.py:22`): coordinate ``active_dim`` scaled by
    exp(log_s) and shifted by t, both read from the other two coordinates
    and the code. The output layer starts at zero (the identity warp);
    log_s = 0.5 tanh(.) and t = 0.1 (.) keep the steps bounded."""

    def __init__(self, active_dim: int, code_channels: int, hidden: int = 32, device=None):
        super().__init__()
        self.active_dim = active_dim
        self.Dense_0 = nn.Linear(2 + code_channels, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, hidden, device=device)
        self.Dense_2 = nn.Linear(hidden, 2, device=device)
        # `flax_default_init_` leaves it at zero as well
        self.Dense_2.zero_init = True
        with torch.no_grad():
            self.Dense_2.weight.zero_()
            self.Dense_2.bias.zero_()

    def forward(self, xyz: torch.Tensor, code: torch.Tensor, inverse: bool = False):
        a0 = self.active_dim
        passive = torch.cat([xyz[..., :a0], xyz[..., a0 + 1:]], dim=-1)
        h = torch.relu(self.Dense_0(torch.cat([passive, code], dim=-1)))
        out = self.Dense_2(torch.relu(self.Dense_1(h)))
        log_s = torch.tanh(out[..., 0:1]) * 0.5
        t = out[..., 1:2] * 0.1
        a = xyz[..., a0:a0 + 1]
        a = (a - t) * torch.exp(-log_s) if inverse else a * torch.exp(log_s) + t
        return torch.cat([xyz[..., :a0], a, xyz[..., a0 + 1:]], dim=-1)


class NVPWarp(nn.Module):
    """Invertible time-conditioned warp (`nvp.py:51`): a 32-channel time
    code, 3 x ``depth`` couplings cycling over x, y, z, run in reverse and
    inverted for the backward warp. It has no SE(3) form."""

    def __init__(self, frame_info: FrameInfo, num_freq_t: int = 6, depth: int = 2,
                 hidden: int = 32, device=None):
        super().__init__()
        self.num_layers = 3 * depth
        self.time_embedding = TimeEmbedding(num_freq_t, frame_info, out_channels=32,
                                            device=device)
        for d in range(self.num_layers):
            setattr(self, f"couplings_{d}", _Coupling(d % 3, 32, hidden, device=device))

    def forward(self, xyz: torch.Tensor, frame_id: torch.Tensor, inst_id=None,
                samples_dict=None, backward: bool = False, return_qt: bool = False):
        if return_qt:
            raise NotImplementedError("NVPWarp has no SE(3) form")
        code = self.time_embedding(frame_id)
        code = code.reshape((-1,) + (1,) * (xyz.dim() - 2) + (code.shape[-1],))
        code = code.expand(xyz.shape[:-1] + (code.shape[-1],))
        order = range(self.num_layers)
        out = xyz
        for d in (reversed(order) if backward else order):
            out = getattr(self, f"couplings_{d}")(out, code, inverse=backward)
        return out, {}
