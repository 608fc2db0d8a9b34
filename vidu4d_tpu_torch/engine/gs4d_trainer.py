"""Stage-3 trainer: dynamic Gaussian surfels on a frozen warp
(`vidu4d_tpu/engine/gs4d_trainer.py`).

The port has the step of one configuration so far: ``--fg_motion gs-bob
--nogs_optim_warp --rgb_loss_only --flow_wt 0`` (README "flow_wt 0"). One
step is

  camera/intrinsics MLPs + articulation -> DQ-skinning warp of all P
  surfels -> SH colour + projection + binning -> the tile kernels over every
  batch frame -> rgb L1, depth and balanced-mask losses -> backward (the
  frozen warp is still differentiated, and its gradients count in gnorm)
  -> densify statistics -> surfel Adam.

Options the port does not have yet raise NotImplementedError; none is
ignored. The round loop, densify/prune hooks, checkpoints and CLIs are
later work.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vidu4d_tpu.data import data_utils
from vidu4d_tpu_torch.engine import losses as losses_mod
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.models.gaussian.deformable import (
    GaussianDeformer,
    prepare_surfels_batch,
)
from vidu4d_tpu_torch.models.gaussian.optimizer import (
    GsLearningRates,
    gs_adam_init,
    gs_adam_update,
)
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops.numerics import safe_norm
from vidu4d_tpu_torch.ops.rasterize import RasterizeConfig
from vidu4d_tpu_torch.ops.rasterize.common import compute_tile_rects, project_splats
from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch
from vidu4d_tpu_torch.ops.rasterize.tile_forward import TILE


def check_supported(opts: Dict) -> None:
    """Raise NotImplementedError for every option value whose code path the
    port does not have yet."""
    o = opts
    unsupported = [
        (o.get("gs_optim_warp", True), "gs_optim_warp=True (AdamW warp refinement)"),
        (o.get("flow_wt", 0.5) > 0, "flow_wt>0 (flow supervision)"),
        (not o.get("rgb_loss_only", False),
         "rgb_loss_only=False (cycle/skin/feature-reprojection losses)"),
        (o.get("lambda_dssim", 0.0) > 0, "lambda_dssim>0 (DSSIM)"),
        ((o.get("ngpu", 1) or 1) > 1, "ngpu>1 (multi-GPU)"),
        (o.get("raster_impl") not in (None, "", "pallas_grad"),
         f"raster_impl={o.get('raster_impl')!r} (the port has the kernel path only)"),
        (o.get("raster_tile", 16) != 16, "raster_tile != 16"),
        (o.get("pixels_per_image", -1) != -1, "pixels_per_image != -1"),
        (bool(o.get("gs_init_mesh")), "gs_init_mesh (mesh surfel init)"),
        (not o.get("single_inst", True), "single_inst=False"),
        (not o.get("fg_motion", "gs-bob").startswith("gs-"), "non-gs fg_motion"),
    ]
    missing = [what for bad, what in unsupported if bad]
    if missing:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(missing)
            + " (supported: --fg_motion gs-bob --nogs_optim_warp "
            "--rgb_loss_only --flow_wt 0)"
        )


class PairSampler:
    """Random (video, frame) pair batches: the JAX package's PairBatcher
    with one host (same draws for the same seed)."""

    def __init__(self, datasets, imgs_per_batch: int, seed: int = 0):
        self.datasets = datasets
        self.imgs_per_batch = imgs_per_batch
        self.index = [(vid, t) for vid, ds in enumerate(datasets) for t in range(len(ds))]
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> Dict[str, np.ndarray]:
        picks = self.rng.integers(0, len(self.index), size=self.imgs_per_batch)
        items = [self.datasets[self.index[p][0]][self.index[p][1]] for p in picks]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


class Stage3Trainer:
    """Stage-3 trainer state + one training step, on ``device``.

    opts: the JAX trainer's option dict (`bench.py:78-96` builds one).
    Parameters are drawn from a ``torch.Generator`` seeded with
    ``opts["seed"]``; tests replace them with converted JAX parameters
    (`vidu4d_tpu_torch.convert`)."""

    def __init__(self, opts: Dict, device, datasets=None, data_info=None):
        check_supported(opts)
        self.opts = dict(opts)
        opts = self.opts
        self.device = torch.device(device)
        seed = max(opts.get("seed", 0), 0)
        if datasets is None:
            # the JAX trainer's single-host dataset rng (data_utils.py:38-42)
            datasets = data_utils.build_datasets(
                {**opts, "pixels_per_image": -1},
                rng=np.random.default_rng(seed + 1))
        self.datasets = datasets
        self.data_info = data_info or data_utils.get_data_info(datasets)
        self.frame_info = self.data_info["frame_info"]
        self.res = opts.get("train_res", 256)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.deformer = GaussianDeformer(
            self.frame_info, fg_motion=opts.get("fg_motion", "gs-bob")[3:],
            learnable_bg=opts.get("gs_learnable_bg", True), device=self.device,
            generator=gen,
        )
        # random init cloud, as the JAX trainer without a Stage-2 mesh
        rng = np.random.default_rng(0)
        n = opts.get("gs_init_samples", 100_000)
        pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
        cols = rng.uniform(size=(n, 3)).astype(np.float32)
        self.surfels = sf.init_from_points(
            torch.as_tensor(pts, device=self.device),
            torch.as_tensor(cols, device=self.device),
            opts.get("gs_capacity", 400_000), sh_degree=opts.get("sh_degree", 3),
            generator=gen,
        )
        self.batcher = PairSampler(datasets, opts.get("imgs_per_gpu", 1), seed=seed)
        self.gs_lrs = GsLearningRates(
            xyz_init=opts.get("position_lr_init", 5e-5),
            xyz_final=opts.get("position_lr_final", 1.6e-6),
            xyz_delay_mult=opts.get("position_lr_delay_mult", 0.01),
            xyz_max_steps=opts.get("position_lr_max_steps", 30_000),
            features_dc=opts.get("feature_lr", 2.5e-3),
            features_rest=opts.get("feature_lr", 2.5e-3) / 20.0,
            opacity=opts.get("opacity_lr", 0.05),
            scaling=opts.get("scaling_lr", 5e-3),
            rotation=opts.get("rotation_lr", 1e-3),
            regist_feat=opts.get("regist_feat_lr", 2.5e-3),
        )
        self.gs_adam = gs_adam_init(self.surfels.params)
        self.raster_cfg = RasterizeConfig(
            span_cap=opts.get("raster_span_cap", 4),
            entry_cap=int(opts.get("raster_entry_cap", 2 ** 19) or 0),
        )

    def set_surfels(self, state: sf.SurfelState) -> None:
        """Replace the surfel store and reset its Adam moments."""
        self.surfels = state
        self.gs_adam = gs_adam_init(state.params)

    def _next_batch(self) -> Dict[str, torch.Tensor]:
        batch = data_utils.flatten_pairs(self.batcher.next_batch())
        batch = data_utils.compute_frameid(batch, self.frame_info)
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def _loss_config(self) -> Dict:
        o = self.opts
        return {
            "mask_wt": o.get("mask_wt", 0.1),
            "rgb_wt": o.get("rgb_wt", 0.1),
            "depth_wt": o.get("depth_wt", 1e-4),
        }

    def render_inputs(self, batch: Dict[str, torch.Tensor],
                      dummy: Optional[torch.Tensor] = None):
        """Warp the surfels to every batch frame and prepare the tile
        kernels' inputs. Returns (`prepare_surfels_batch` dict,
        (xyz_cam, rot_cam, intrins))."""
        d = self.deformer
        sp = self.surfels.params
        samples = d.get_samples(batch)
        xyz_cam, rot_cam, _ = d.warp_surfels(sp.xyz, sf.get_rotation(sp), samples)
        intrins = geom.mat2K(geom.Kmatinv(samples["Kinv"]))
        prepared = prepare_surfels_batch(
            sp, self.surfels.alive, xyz_cam, rot_cam, intrins, self.res, self.res,
            self.opts.get("sh_degree", 3), d.background(), self.raster_cfg,
            densify_dummy=dummy,
        )
        return prepared, (xyz_cam, rot_cam, intrins)

    def loss(self, batch: Dict[str, torch.Tensor], dummy: torch.Tensor):
        """The step's loss (`gs4d_trainer.py:378-617` for this configuration).

        Returns (total, loss_dict, render output, (xyz_cam, rot_cam,
        intrins) detached for the densify statistics)."""
        cfg = self._loss_config()
        res = self.res
        prepared, (xyz_cam, rot_cam, intrins) = self.render_inputs(batch, dummy)
        out = composite_batch(prepared, res, res)
        m = xyz_cam.shape[0]
        img = lambda x: x.reshape(m, res, res, -1)
        gt_rgb, gt_mask, vis2d = img(batch["rgb"]), img(batch["mask"]), img(batch["vis2d"])

        loss_dict = {}
        loss_dict["rgb"] = torch.mean(torch.abs(out.color[..., :3] - gt_rgb) * vis2d)
        maskfg_vis = gt_mask * vis2d
        if cfg["depth_wt"] > 0 and "depth" in batch:
            depth_img = (out.depth / torch.clamp(out.alpha, min=1e-6))[..., None]
            depth_l = torch.abs(depth_img - img(batch["depth"]))
            loss_dict["depth"] = losses_mod.nonzero_mean(depth_l * maskfg_vis) \
                * cfg["depth_wt"]
        balance = losses_mod.get_mask_balance_wt(gt_mask, vis2d, batch["is_detected"])
        mask_loss = ((out.alpha[..., None] - gt_mask) ** 2) * balance * vis2d
        is_det = batch["is_detected"].reshape(-1, 1, 1, 1)
        loss_dict["mask"] = losses_mod.nonzero_mean(mask_loss * is_det)
        loss_dict["rgb"] = loss_dict["rgb"] * cfg["rgb_wt"]
        loss_dict["mask"] = loss_dict["mask"] * cfg["mask_wt"]
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        warped = (xyz_cam.detach(), rot_cam.detach(), intrins.detach())
        return total, loss_dict, out, warped

    def train_step(self, batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """One training step (`gs4d_trainer.py:621-707`); updates the surfel
        store and its Adam state in place. Returns a dict of 0-d tensors."""
        if batch is None:
            batch = self._next_batch()
        surf = self.surfels
        sp = surf.params
        res = self.res
        cfg = self.raster_cfg
        dparams = list(self.deformer.parameters())
        for p in (*dparams, *sp):
            p.grad = None
        dummy = torch.zeros((batch["frameid"].shape[0], surf.capacity, 2),
                            device=self.device, requires_grad=True)
        total, loss_dict, _, warped = self.loss(batch, dummy)
        total.backward()

        with torch.no_grad():
            sgrads = sf.SurfelParams(*[
                p.grad if p.grad is not None else torch.zeros_like(p) for p in sp])
            sq = [torch.sum(g * g) for g in sgrads]
            sq += [torch.sum(p.grad * p.grad) for p in dparams if p.grad is not None]
            gnorm = torch.sqrt(torch.stack(sq).sum())

            # densification stats from the pre-update params and the loss
            # forward's warp outputs (`gs4d_trainer.py:634-684`)
            xyz_cam, rot_cam, intrins = warped
            eye = torch.eye(4, device=self.device)
            proj = project_splats(xyz_cam, rot_cam, sf.get_scaling(sp), eye, intrins,
                                  mask=surf.alive)
            rects = compute_tile_rects(proj, res, res, TILE, cfg.span_cap)
            vs = dummy.grad * proj.depth[..., None] * float(res)
            norms = safe_norm(vs, dim=-1)
            vis = rects.valid
            overflow = torch.sum((rects.overflow & rects.valid).to(torch.int32))
            if cfg.entry_cap:
                entries = torch.sum(torch.where(vis, rects.span_x * rects.span_y, 0), -1)
                truncated = torch.sum(torch.clamp(entries - cfg.entry_cap, min=0))
            else:
                truncated = torch.zeros((), dtype=torch.int64, device=self.device)
            self.surfels = surf._replace(
                grad_accum=surf.grad_accum + torch.sum(torch.where(vis, norms, 0.0), 0),
                denom=surf.denom + torch.sum(vis.to(surf.denom.dtype), 0),
                max_radii2d=torch.maximum(
                    surf.max_radii2d, torch.amax(torch.where(vis, proj.radius, 0.0), 0)),
            )
            self.gs_adam = gs_adam_update(sgrads, self.gs_adam, sp, self.gs_lrs)

        return {
            "total": total.detach(),
            **{k: v.detach() for k, v in loss_dict.items()},
            "alive": self.surfels.num_alive(),
            "gnorm": gnorm,
            "overflow_splats": overflow,
            "truncated_entries": truncated,
        }
