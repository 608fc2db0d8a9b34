"""Skip-connected MLP backbones (`vidu4d_tpu/models/fields/mlp.py`)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vidu4d_tpu_torch.models.fields.embeddings import InstEmbedding


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear and InstEmbedding below ``module`` the way the
    JAX package's flax modules initialise: Dense kernels lecun-normal
    (truncated at 2 sigma), zero biases, instance codes N(0, 1). All draws
    come from ``generator``. A Linear marked ``zero_init`` (a flax Dense
    with zero kernel init) is zeroed instead."""
    for mod in module.modules():
        if getattr(mod, "zero_init", False):
            mod.weight.zero_()
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            # flax's variance_scaling(1, "fan_in", "truncated_normal")
            std = (1.0 / mod.in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, InstEmbedding):
            mod.mapping.normal_(generator=generator)


class BaseMLP(nn.Module):
    """``depth`` ReLU layers of ``width`` with input skip connections, then
    a linear output (optionally ReLU'd). Layer names follow the JAX
    package's (``linear_1`` .. ``linear_<depth>``, ``linear_final``)."""

    def __init__(self, in_channels: int, depth: int = 8, width: int = 256,
                 out_channels: int = 3, skips: Sequence[int] = (4,),
                 final_act: bool = False, device=None):
        super().__init__()
        self.depth = depth
        self.skips = tuple(skips)
        self.final_act = final_act
        ch = in_channels
        for i in range(depth):
            if i in self.skips:
                ch = ch + in_channels
            setattr(self, f"linear_{i + 1}", nn.Linear(ch, width, device=device))
            ch = width
        self.linear_final = nn.Linear(ch, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(self.depth):
            if i in self.skips:
                out = torch.cat([x, out], dim=-1)
            out = torch.relu(getattr(self, f"linear_{i + 1}")(out))
        out = self.linear_final(out)
        return torch.relu(out) if self.final_act else out


class CondMLP(nn.Module):
    """BaseMLP with an instance code appended to the input; single-instance
    models drop the code (`mlp.py:39`)."""

    def __init__(self, in_channels: int, num_inst: int, depth: int = 8,
                 width: int = 256, inst_channels: int = 32, out_channels: int = 3,
                 skips: Sequence[int] = (4,), final_act: bool = False, device=None):
        super().__init__()
        self.inst_ch = inst_channels if num_inst > 1 else 0
        if self.inst_ch > 0:
            self.inst_embedding = InstEmbedding(num_inst, self.inst_ch, device=device)
        self.mlp = BaseMLP(in_channels + self.inst_ch, depth, width, out_channels,
                           skips, final_act, device=device)

    def forward(self, feat: torch.Tensor, inst_id: Optional[torch.Tensor] = None,
                beta_prob: float = 0.0, swap=None) -> torch.Tensor:
        """feat (M, ..., C); inst_id (M,), or None for the mean instance's
        code (`mlp.py:72-80`); ``beta_prob`` / ``swap``: `InstEmbedding`'s
        instance swap."""
        if self.inst_ch > 0:
            if inst_id is None:
                code = self.inst_embedding.mean_embedding()
            else:
                code = self.inst_embedding(inst_id, beta_prob=beta_prob, swap=swap)
                code = code.reshape(code.shape[:1] + (1,) * (feat.dim() - 2) + (-1,))
            code = code.expand(feat.shape[:-1] + (self.inst_ch,))
            feat = torch.cat([feat, code], dim=-1)
        return self.mlp(feat)
