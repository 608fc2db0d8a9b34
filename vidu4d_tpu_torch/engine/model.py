"""The Stage-2 model: neural fields + intrinsics + loss assembly
(`vidu4d_tpu/engine/model.py`).

`DvrModel` owns the per-category `DynNeRF` fields and the `IntrinsicsMLP`:
``field_type`` "fg" has the deformable object field (``fields.fg``; flax
names the subtree ``fields_fg``), "bg" the rigid background field
(``fields.bg``), "comp" both, composited along each ray by depth. `loss`
renders the batch, assembles every reconstruction and regularisation term
and weights them.

The sampled regularisers draw points in the aabb (`reg_draws`). The draws
are an argument of `loss`, so that a caller can hold the port against the
JAX package with JAX's own draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.engine import losses as losses_mod
from vidu4d_tpu_torch.models.fields.dyn_nerf import DynNeRF, FieldState
from vidu4d_tpu_torch.models.fields.mlp import flax_default_init_
from vidu4d_tpu_torch.models.fields.skeleton import ArticulationSkelMLP
from vidu4d_tpu_torch.models.fields.time_mlp import IntrinsicsMLP
from vidu4d_tpu_torch.models.fields.warping import ComposedWarp, SkinningWarp
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_to_se3
from vidu4d_tpu_torch.ops.volume import render_pixel
from vidu4d_tpu_torch.utils.profiler import span

# points of the sampled regularisers (`model.py:169-201`)
N_VIS, N_GAUSS, N_SOFT = 512, 2048, 1024
# the categories of each field_type, in the JAX model's order
FIELD_CATEGORIES = {"fg": ("fg",), "bg": ("bg",), "comp": ("fg", "bg")}


class DvrModel(nn.Module):
    """Stage-2 composed model, volumetric path (`model.py:31`)."""

    def __init__(self, frame_info: FrameInfo, field_type: str = "fg", fg_motion: str = "bob",
                 num_inst: int = 1, rtmat_prior: Optional[np.ndarray] = None,
                 rgb_timefree: bool = False, rgb_dirfree: bool = False,
                 use_wide_near_far: bool = False, train_depth_samples: int = 64,
                 field_depth: int = 8, field_width: int = 256, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if field_type not in FIELD_CATEGORIES:
            raise ValueError(f"field_type {field_type!r}")
        self.frame_info = frame_info
        self.num_inst = num_inst
        self.use_wide_near_far = use_wide_near_far
        # the background field is rigid (`model.py:60-72`)
        self.fields = nn.ModuleDict({cate: DynNeRF(
            frame_info, category=cate, fg_motion=fg_motion if cate == "fg" else "rigid",
            num_inst=num_inst, depth=field_depth, width=field_width,
            rgb_timefree=rgb_timefree, rgb_dirfree=rgb_dirfree,
            train_depth_samples=train_depth_samples, device=device)
            for cate in FIELD_CATEGORIES[field_type]})
        self.intrinsics = IntrinsicsMLP(frame_info, device=device)
        # (N, 4, 4) camera priors, translations at the init scale
        self.register_buffer(
            "rtmat_prior",
            None if rtmat_prior is None else torch.as_tensor(
                np.asarray(rtmat_prior, np.float32).reshape(-1, 4, 4), device=device),
            persistent=False)
        self.register_buffer("frame_mapping", torch.as_tensor(
            np.asarray(frame_info.frame_mapping), dtype=torch.int64, device=device),
            persistent=False)
        if generator is not None:
            flax_default_init_(self, generator)

    def compute_kinv(self, batch: Dict) -> torch.Tensor:
        """K2inv(intrinsics(t)) @ K2mat(crop2raw), or the batch's "Kinv"."""
        if "Kinv" in batch:
            return batch["Kinv"]
        return geom.K2inv(self.intrinsics(batch["frameid"])) @ geom.K2mat(batch["crop2raw"])

    def render(self, batch: Dict, states: Dict[str, FieldState], train: bool = True,
               alpha=None, flow_thresh=None, no_warp: bool = False):
        """Render every field and compose (`model.py:108`). Returns
        (rendered (M, N, c) maps, aux_dict: per category its rendered maps
        and matching outputs)."""
        kinv = self.compute_kinv(batch)
        multifields, deltas_dict, aux_dict = {}, {}, {}
        for cate, field in self.fields.items():
            samples = field.get_samples(kinv, batch, states[cate],
                                        use_wide_near_far=self.use_wide_near_far)
            feat, deltas, aux = field.query_field(samples, states[cate], train=train,
                                                  alpha=alpha, flow_thresh=flow_thresh,
                                                  no_warp=no_warp)
            multifields[cate], deltas_dict[cate], aux_dict[cate] = feat, deltas, aux
        field_dict, deltas = self.compose_fields(multifields, deltas_dict)
        rendered = render_pixel(field_dict, deltas)
        for cate in multifields:
            aux_dict[cate].update(render_pixel(multifields[cate], deltas_dict[cate]))
        return rendered, aux_dict

    @staticmethod
    def compose_fields(multifields: Dict, deltas_dict: Dict):
        """Join the fields' samples along each ray (`model.py:132`): every
        key of any field, zeros where a field lacks it, concatenated over
        the sample axis in category order; with several fields, sorted by
        depth (a stable sort: samples of equal depth keep that order)."""
        cates = list(multifields)
        keys = sorted({k for f in multifields.values() for k in f})
        field_dict = {}
        for k in keys:
            template = next(f[k] for f in multifields.values() if k in f)
            field_dict[k] = torch.cat([multifields[c].get(k, torch.zeros_like(template))
                                       for c in cates], dim=2)
        deltas = torch.cat([deltas_dict[c] for c in cates], dim=2)
        if len(cates) > 1:
            z_idx = torch.argsort(field_dict["depth"], dim=2, stable=True)[..., :1]
            for k, v in field_dict.items():
                field_dict[k] = torch.gather(v, 2, z_idx.expand(v.shape))
            deltas = torch.gather(deltas, 2, z_idx.expand(deltas.shape))
        return field_dict, deltas

    # ------------------------------------------------------------------
    # sampled regularisers (`model.py:164`)
    # ------------------------------------------------------------------

    def reg_draws(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The random inputs of `reg_losses`: uniform (N_VIS, 3) and
        (N_GAUSS, 3) positions in [0, 1)^3 and N_VIS instance ids; with a
        composed fg warp also (N_SOFT, 3) positions and N_SOFT raw frame
        ids (the JAX model draws both of these from one key)."""
        dev = self.frame_mapping.device
        draws = {
            "vis": torch.rand((N_VIS, 3), generator=generator, device=dev),
            "inst": torch.randint(0, max(self.num_inst, 1), (N_VIS,), generator=generator,
                                  device=dev),
            "gauss": torch.rand((N_GAUSS, 3), generator=generator, device=dev),
        }
        if "fg" in self.fields and isinstance(self.fields["fg"].warp, ComposedWarp):
            draws["soft"] = torch.rand((N_SOFT, 3), generator=generator, device=dev)
            draws["soft_fid"] = torch.randint(0, self.frame_info.num_frames_raw, (N_SOFT,),
                                              generator=generator, device=dev)
        return draws

    @span("s2.reg")
    def reg_losses(self, states: Dict[str, FieldState], draws: Dict[str, torch.Tensor],
                   alpha=None) -> Dict[str, torch.Tensor]:
        """Visibility decay (every field), gauss-skin consistency (a
        skinning fg warp), soft deform (a composed fg warp), the skeleton
        prior (a skeleton fg warp) and the camera prior averaged over the
        fields (`model.py:164`); the uniform draws are mapped into each
        field's extended aabb."""
        def in_aabb(u, state, factor):
            aabb = geom.extend_aabb(state.aabb, factor=factor)
            return aabb[0] + u * (aabb[1] - aabb[0])

        out = {}
        vis_losses = []
        for cate, field in self.fields.items():
            vis = field.visibility(in_aabb(draws["vis"], states[cate], 1.0), draws["inst"])
            vis_losses.append(-torch.mean(F.logsigmoid(-vis)))
        out["reg_visibility"] = sum(vis_losses) / len(vis_losses)

        field = self.fields["fg"] if "fg" in self.fields else None
        warp = getattr(field, "warp", None)
        if isinstance(warp, SkinningWarp):
            pts = in_aabb(draws["gauss"], states["fg"], 0.25)
            density_gauss, density = field.gauss_skin_consistency_density(pts, alpha=alpha)
            # balanced BCE (`model.py:185-193`)
            wp = 0.5 / (1e-6 + torch.mean(density))
            wn = 0.5 / (1e-6 + torch.mean(1 - density))
            weight = (density * wp + (1 - density) * wn).detach()
            dg = torch.clamp(density_gauss, 1e-7, 1 - 1e-7)
            bce = -(density * torch.log(dg) + (1 - density) * torch.log(1 - dg))
            out["reg_gauss_skin"] = torch.mean(bce * weight)
        if isinstance(warp, ComposedWarp):
            pts = in_aabb(draws["soft"], states["fg"], 1.0)
            iid = torch.zeros_like(draws["soft_fid"])
            out["reg_soft_deform"] = torch.mean(
                warp.compute_post_warp_dist2(pts[:, None, None], draws["soft_fid"], iid))
        if isinstance(warp, SkinningWarp) and isinstance(warp.articulation,
                                                         ArticulationSkelMLP):
            out["reg_skel_prior"] = warp.articulation.skel_prior_loss()

        if self.rtmat_prior is not None:
            cam_losses = []
            for field in self.fields.values():
                pred = quaternion_translation_to_se3(*field.camera_vals())
                trans = torch.zeros((4, 4), dtype=torch.bool, device=pred.device)
                trans[:3, 3] = True
                prior = self.rtmat_prior * torch.where(trans, torch.exp(field.logscale), 1.0)
                cam_losses.append(torch.mean((pred - prior[self.frame_mapping]) ** 2))
            out["reg_cam_prior"] = sum(cam_losses) / len(cam_losses)
        return out

    @span("s2.forward")
    def loss(self, batch: Dict, states: Dict[str, FieldState], config: Dict,
             weights: Dict, draws: Dict[str, torch.Tensor], train: bool = True):
        """Forward + loss assembly (`model.py:226`). batch: the flattened
        (M, N, ...) pixel batch (pairs merged); config: the loss options;
        weights: the step's annealed overrides (`progress_schedule`);
        draws: `reg_draws`. When data-parallel ranks split the batch
        (`ops.global_batch.over`), every dense term is this rank's part of
        the global batch's (normalised by global counts) and the sampled
        regularisers, which do not depend on the batch, count on rank 0
        only (`global_batch.once`). The loss draws nothing per ray.
        Returns (weighted loss terms, (rendered, aux_dict))."""
        alpha = weights.get("alpha")
        rendered, aux_dict = self.render(batch, states, train=train, alpha=alpha,
                                         flow_thresh=config.get("train_res"))
        loss_dict = losses_mod.compute_recon_loss(rendered, aux_dict, batch, config)
        loss_dict = losses_mod.mask_losses(loss_dict, batch, config)
        loss_dict["reg_eikonal"] = rendered["eikonal"]
        fg = aux_dict.get("fg", {})
        for src, dst in (("cyc_dist", "reg_deform_cyc"), ("delta_skin", "reg_delta_skin"),
                         ("skin_entropy", "reg_skin_entropy")):
            if src in fg:
                loss_dict[dst] = fg[src]
        reg = self.reg_losses(states, draws, alpha=alpha)
        loss_dict.update({k: global_batch.once(v) for k, v in reg.items()})
        loss_dict = losses_mod.apply_loss_weights(loss_dict, config, weights)
        return loss_dict, (rendered, aux_dict)
