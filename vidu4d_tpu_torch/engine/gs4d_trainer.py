"""Stage-3 trainer: dynamic Gaussian surfels on a refined warp
(`vidu4d_tpu/engine/gs4d_trainer.py`).

One step (`train_step`) of the JAX trainer's default configuration
(``--fg_motion gs-bob``, the JAX defaults of every loss option; the other
motions with an SE(3) form run the same step, see `check_supported`):

  camera/intrinsics MLPs + articulation -> DQ-skinning warp of all P
  surfels -> per-surfel pair flow through the pair-flipped frames (2 extra
  channels) -> SH colour + projection + binning -> the tile kernels over
  every batch frame -> rgb L1 (+ DSSIM), flow, depth, balanced mask,
  feature reprojection, cycle/skin regularisers, 2DGS normal + distortion
  (after 8k steps) -> backward -> densify statistics -> surfel Adam and
  the warp AdamW.

The round loop around it (`rounds.RoundTrainer`'s `train` and
`train_one_round`): an eval render per round (`render_batch`, the forward
kernel only), the densify / prune / opacity-reset / radius-outlier hooks at
the JAX cadence (`_densify_hooks`), the opt-in gradient-spike rollback, and
per-round checkpoints (pickled numpy payloads) with a 3DGS ``.ply`` of the
alive surfels.

The surfels start on the Stage-2 mesh (``gs_init_mesh``,
`init_surfels_from_mesh`) or as a random cloud; `load_stage2` takes the
warp, camera and intrinsics over from a JAX Stage-2 checkpoint, and
`load_checkpoint` reads the port's checkpoints and the JAX trainer's.

``--nogs_optim_warp``, ``--rgb_loss_only`` and ``--flow_wt 0`` switch the
corresponding parts off. Options the port does not have yet raise
NotImplementedError; none is ignored.

``--ngpu N`` (``group``, a `parallel.sharding.Mesh` of N ranks) is data
parallelism over frame pairs that gives the one-process step's numbers:
every rank draws the global batch and keeps its share of the pairs, each
loss term is this rank's part of the global batch's (normalised by global
counts; the batch-independent volume term on rank 0, ARAP on the rank
holding the global first pair), the gradients are summed over the ranks in
one buffer before gnorm, the rollback test and both optimisers read them,
and the densify statistics are summed (max for the radii). The initial
state is rank 0's; checkpoints, logs and eval renders are rank 0's only.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine import losses as losses_mod
from vidu4d_tpu_torch.engine.optim import WarpAdamW
from vidu4d_tpu_torch.engine.rounds import RoundTrainer
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.models.fields.skinning import arap_bone_loss
from vidu4d_tpu_torch.models.gaussian import densify as densify_mod
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.models.gaussian.deformable import (
    GaussianDeformer,
    prepare_surfels_batch,
    render_surfels_batch,
)
from vidu4d_tpu_torch.models.gaussian.optimizer import (
    GsLearningRates,
    gs_adam_init,
    gs_adam_update,
)
from vidu4d_tpu_torch.models.gaussian.ply_io import save_ply
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.depth_normal import surf_depth_and_normal
from vidu4d_tpu_torch.ops.image_losses import ssim
from vidu4d_tpu_torch.ops.marching import load_obj, sample_mesh_surface
from vidu4d_tpu_torch.ops.numerics import safe_norm
from vidu4d_tpu_torch.ops.quaternion import dual_quaternion_to_quaternion_translation
from vidu4d_tpu_torch.ops.rasterize import RasterizeConfig
from vidu4d_tpu_torch.ops.rasterize.common import compute_tile_rects, project_splats
from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch
from vidu4d_tpu_torch.ops.rasterize.tile_forward import check_tile
from vidu4d_tpu_torch.parallel import sharding
from vidu4d_tpu_torch.utils.camera_trajectories import construct_batch
from vidu4d_tpu_torch.utils import profiler


# the warps without an SE(3) form, which Stage 3 cannot drive surfels with:
# the JAX trainer raises their NotImplementedError when it is built
NO_SE3_FORM = {"dense": "DenseWarp", "nvp": "NVPWarp", "comp": "ComposedWarp"}


def check_supported(opts: Dict) -> None:
    """Raise NotImplementedError for a motion the JAX trainer rejects too
    (gs-dense, gs-nvp, gs-comp*: their warps have no SE(3) form, with the
    JAX package's message) and for every option value whose code path the
    port does not have yet. Stage 3 takes gs-bob, gs-bob-nosoft,
    gs-bob-sc, gs-skel-human, gs-skel-quad, gs-denseSE3 and gs-rigid."""
    o = opts
    motion = o.get("fg_motion", "gs-bob")
    if not motion.startswith("gs-"):
        raise ValueError(f"fg_motion {motion!r} is not a Stage-3 motion (gs-*)")
    warp = NO_SE3_FORM.get("comp" if motion[3:].startswith("comp") else motion[3:])
    if warp is not None:
        raise NotImplementedError(f"{warp} has no SE(3) form")
    unsupported = [
        (o.get("raster_impl") not in (None, "", "pallas_grad"),
         f"raster_impl={o.get('raster_impl')!r} (the port has the kernel path only)"),
        (o.get("pixels_per_image", -1) != -1, "pixels_per_image != -1"),
        (bool(o.get("gs_init_ply")), "gs_init_ply (the JAX trainer ignores it)"),
    ]
    missing = [what for bad, what in unsupported if bad]
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def init_surfels_from_mesh(mesh_path: str, feat_path: Optional[str], capacity: int,
                           n_samples: int, sh_degree: int, generator: torch.Generator,
                           device) -> sf.SurfelState:
    """Surfels on the Stage-2 mesh (`gs4d_trainer.py:83-118`): ``n_samples``
    area-weighted surface points drawn from ``np.random.default_rng(0)``,
    as the JAX trainer draws them, colours blended from the mesh's
    ``-colors.npy`` vertex colours (else 0.5 grey) and registration features
    from ``feat_path``'s vertex features (when the file exists; L2-normalised)
    by the same barycentric weights, then `surfels.init_from_points` with
    rotations from ``generator``."""
    verts, faces = load_obj(mesh_path)
    pts, fid, bary = sample_mesh_surface(verts, faces, n_samples,
                                         rng=np.random.default_rng(0))
    colors_path = mesh_path.replace(".obj", "-colors.npy")
    if os.path.exists(colors_path):
        vcolors = np.load(colors_path)
        colors = np.einsum("nk,nkc->nc", bary, vcolors[faces[fid]]).astype(np.float32)
    else:
        colors = np.full((n_samples, 3), 0.5, np.float32)
    regist_feat = None
    if feat_path and os.path.exists(feat_path):
        vfeat = np.load(feat_path)
        feat = np.einsum("nk,nkc->nc", bary, vfeat[faces[fid]])
        feat /= np.maximum(np.linalg.norm(feat, axis=-1, keepdims=True), 1e-12)
        regist_feat = torch.as_tensor(feat.astype(np.float32), device=device)
    t = lambda a: torch.as_tensor(a, device=device)
    return sf.init_from_points(t(pts), t(colors), capacity, sh_degree=sh_degree,
                               generator=generator, regist_feat=regist_feat)


# the Stage-2 subtrees a Stage-3 deformer takes over (`gs4d_trainer.py:121-134`):
# (path in the Stage-2 flax params, the deformer's submodule)
STAGE2_TRANSFER = ((("fields_fg", "warp"), "warp"), (("fields_fg", "camera_mlp"), "camera_mlp"),
                   (("fields_fg", "logscale"), "logscale"), (("intrinsics",), "intrinsics"))


def transfer_stage2_params(stage2_params: Dict, deformer: torch.nn.Module) -> list:
    """Copy the warp, camera MLP, logscale and intrinsics of a Stage-2 flax
    tree (``{"params": {"fields_fg": {...}, "intrinsics": {...}}}``, numpy)
    into ``deformer`` in place (`gs4d_trainer.py:121`): its parameter
    tensors stay the ones the optimiser holds. Every parameter under those
    four names must be matched, with its shape. Returns the keys copied."""
    src = stage2_params["params"]
    tree = {}
    for path, name in STAGE2_TRANSFER:
        node = src
        for p in path:
            if p not in node:
                raise KeyError(f"the Stage-2 parameters have no {'.'.join(path)}")
            node = node[p]
        tree[name] = node
    sd = convert.flax_to_state_dict({"params": tree})
    own = deformer.state_dict()
    want = {k for k in own if k.split(".")[0] in tree}
    if set(sd) != want:
        raise ValueError(f"Stage-2 parameters do not match the deformer's: "
                         f"{sorted(set(sd) ^ want)}")
    bad = [k for k in sd if sd[k].shape != own[k].shape]
    if bad:
        raise ValueError(f"Stage-2 parameter shapes differ: "
                         f"{[(k, tuple(sd[k].shape), tuple(own[k].shape)) for k in bad]}")
    deformer.load_state_dict({k: v.to(own[k].device) for k, v in sd.items()}, strict=False)
    return sorted(sd)


def cadence_due(it: int, span: int, interval: int) -> Optional[int]:
    """Largest positive multiple of ``interval`` inside the window of the
    steps just taken, (it - span, it], or None (`gs4d_trainer.py:137`): a
    chunk of several steps, or a short final chunk, never skips a hook."""
    m = (it // interval) * interval
    return m if m > it - span and m > 0 else None


def uniform_pixel_subsample(n_total: int, n_px: int, train_res: int,
                            device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pick n_px of n_total raster-order pixels (dim 1) with uniform 2D
    coverage (`gs4d_trainer.py:56`): a strided slice when the stride
    divides the image width evenly and trims nothing, else a 2D grid of
    rows and columns."""
    h = w = train_res
    st = n_total // n_px
    if n_total == h * w and n_total % n_px == 0 and 0 < st < w and w % st == 0:
        return lambda x: x[:, ::st][:, :n_px]
    nc = min(w, int(math.ceil(math.sqrt(n_px))))
    nr = min(h, -(-n_px // nc))
    rows = np.round(np.linspace(0, h - 1, nr)).astype(np.int64)
    cols = np.round(np.linspace(0, w - 1, nc)).astype(np.int64)
    idx = (rows[:, None] * w + cols[None, :]).reshape(-1)[:n_px]
    idx = torch.as_tensor(np.clip(idx, 0, n_total - 1), device=device)
    return lambda x: x.index_select(1, idx)


class Stage3Trainer(RoundTrainer):
    """Stage-3 trainer state, its step and its round loop
    (`rounds.RoundTrainer`), on ``device`` (the card by default; the CPU,
    where the kernels' plain versions run, only when asked for with
    ``device="cpu"``).

    opts: the JAX trainer's option dict (`bench.py:78-96` builds one).
    Parameters are drawn from a ``torch.Generator`` seeded with
    ``opts["seed"]``; tests replace them with converted JAX parameters
    (`vidu4d_tpu_torch.convert`). ``current_steps`` counts the steps
    taken; it switches the 2DGS regularisers on after 8k."""

    def __init__(self, opts: Dict, device="cuda", datasets=None, data_info=None,
                 group: Optional[sharding.Mesh] = None):
        check_supported(opts)
        opts = dict(opts)
        opts.setdefault("pixels_per_image", -1)  # full images (`gs4d_trainer.py:150`)
        # the tile side, in opts.json too: render / export / reanimate
        # --logdir render at the trained side
        opts.setdefault("raster_tile", 16)
        check_tile(opts["raster_tile"])
        super().__init__(opts, device, datasets, data_info, group, imgs_per_gpu=1)
        opts = self.opts
        seed = max(opts.get("seed", 0), 0)
        self.res = opts.get("train_res", 256)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.deformer = GaussianDeformer(
            self.frame_info, fg_motion=opts.get("fg_motion", "gs-bob")[3:],
            num_inst=1 if opts.get("single_inst", True) else self.frame_info.num_vids,
            learnable_bg=opts.get("gs_learnable_bg", True), device=self.device,
            generator=gen,
        )
        # surfels on the Stage-2 mesh, else a random cloud (`gs4d_trainer.py:176`);
        # a named mesh that does not exist raises (the JAX trainer falls back
        # to the random cloud)
        cap, sh_degree = opts.get("gs_capacity", 400_000), opts.get("sh_degree", 3)
        mesh = opts.get("gs_init_mesh", "")
        if mesh:
            if not os.path.exists(mesh):
                raise FileNotFoundError(f"gs_init_mesh {mesh!r} does not exist")
            self.surfels = init_surfels_from_mesh(
                mesh, mesh.replace("-geo.obj", "-feat.npy"), cap,
                opts.get("gs_init_samples", 200_000), sh_degree, gen, self.device)
        else:
            rng = np.random.default_rng(0)
            n = opts.get("gs_init_samples", 100_000)
            pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
            cols = rng.uniform(size=(n, 3)).astype(np.float32)
            self.surfels = sf.init_from_points(
                torch.as_tensor(pts, device=self.device),
                torch.as_tensor(cols, device=self.device), cap, sh_degree=sh_degree,
                generator=gen,
            )
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
        # the reference's warp schedule: OneCycle warm-up from lr / 25 over
        # 2 rounds, x10 for the explicit parameters
        self.warp_opt = None
        if opts.get("gs_optim_warp", True):
            self.warp_opt = WarpAdamW(
                self.deformer.named_parameters(),
                learning_rate=opts.get("learning_rate", 5e-4),
                total_steps=opts.get("num_rounds", 60) * opts.get("iters_per_round", 200),
                num_rounds=opts.get("num_rounds", 60),
                intrinsics_lr_mult=opts.get("intrinsics_lr_mult", 1.0),
            )
        # the hooks that fired: {"hook", "step", and its counts (0-d tensors)}
        self.hook_log = []
        self.raster_cfg = RasterizeConfig(
            tile=opts["raster_tile"],
            span_cap=opts.get("raster_span_cap", 4),
            entry_cap=int(opts.get("raster_entry_cap", 2 ** 19) or 0),
        )
        self.broadcast_state()

    def state_tensors(self) -> list:
        """Every tensor of the trainable state: the deformer's parameters
        and buffers, the surfel store, both optimisers' moments."""
        out = [*self.deformer.state_dict().values(), *self.surfels.params, *self.surfels[1:],
               *self.gs_adam.mu, *self.gs_adam.nu]
        if self.warp_opt is not None:
            out += [*self.warp_opt.mu.values(), *self.warp_opt.nu.values()]
        return out

    def set_surfels(self, state: sf.SurfelState) -> None:
        """Replace the surfel store and reset its Adam moments."""
        self.surfels = state
        self.gs_adam = gs_adam_init(state.params)

    def _loss_config(self) -> Dict:
        """The loss options and their JAX defaults (`gs4d_trainer.py:304`)."""
        o = self.opts
        return {
            "arap_wt": o.get("arap_wt", 0.0),
            "train_res": self.res,
            "mask_wt": o.get("mask_wt", 0.1),
            "rgb_wt": o.get("rgb_wt", 0.1),
            "depth_wt": o.get("depth_wt", 1e-4),
            "flow_wt": o.get("flow_wt", 0.5),
            # GT-flow magnitudes below this (px) are inside the flow
            # estimator's noise band and not supervised; 0 disables the gate
            "flow_noise_px": o.get("flow_noise_px", 2.5),
            "feat_reproj_wt": o.get("feat_reproj_wt", 5e-2),
            # pixels per frame of the feature-matching loss (0 = all)
            "feat_reproj_px": o.get("feat_reproj_px", 8192),
            "reg_deform_cyc_wt": o.get("reg_deform_cyc_wt", 0.01),
            # strided surfel subset of the cycle/skin regularisers (1 = all)
            "cycle_subsample": o.get("cycle_subsample", 4),
            "reg_delta_skin_wt": o.get("reg_delta_skin_wt", 5e-3),
            "reg_skin_entropy_wt": o.get("reg_skin_entropy_wt", 5e-4),
            # read by progress_schedule only
            "reg_cam_prior_wt": o.get("reg_cam_prior_wt", 0.1),
            "reg_skel_prior_wt": o.get("reg_skel_prior_wt", 0.1),
            "reg_gauss_mask_wt": o.get("reg_gauss_mask_wt", 0.01),
            "reg_eikonal_wt": 0.0,
            "lambda_dssim": o.get("lambda_dssim", 0.0),
            "lambda_normal": o.get("lambda_normal", 0.05),
            "lambda_dist": o.get("lambda_dist", 0.0),
            "reg_volume_loss_wt": o.get("reg_volume_loss_wt", 0.0),
            "rgb_loss_only": o.get("rgb_loss_only", False),
        }

    def use_2dgs_reg(self, step: int) -> bool:
        """Whether the 2DGS normal / distortion terms are on at ``step``
        (after 8k steps, `gs4d_trainer.py:732-736`)."""
        w = progress_schedule(self._loss_config(), step)
        return w["lambda_normal"] > 0 or w["lambda_dist"] > 0

    def render_inputs(self, batch: Dict[str, torch.Tensor],
                      dummy: Optional[torch.Tensor] = None):
        """Warp the surfels to every batch frame, compute their pair flow
        (the 2 extra channels, when flow is supervised) and prepare the tile
        kernels' inputs (`gs4d_trainer.py:384-452`); the flow's scale is
        the global batch's (`global_batch.amax`). Returns
        (`prepare_surfels_batch` dict, context dict with "samples",
        "xyz_cam", "rot_cam", "intrins" and "flow_scale")."""
        d = self.deformer
        sp = self.surfels.params
        alive = self.surfels.alive
        cfg = self._loss_config()
        samples = d.get_samples(batch)
        xyz_cam, rot_cam, _ = d.warp_surfels(sp.xyz, sf.get_rotation(sp), samples)
        intrins = geom.mat2K(geom.Kmatinv(samples["Kinv"]))
        extra, flow_scale = None, 1.0
        if cfg["flow_wt"] > 0 and "flow" in batch:
            # canonical -> both pair frames, from the store's canonical xyz
            flow_pw = d.flow_surfels(xyz_cam, samples, sp.xyz[None].expand_as(xyz_cam))
            # normalise to ~[-1, 1] before compositing; the scale is data,
            # and dead slots (degenerate projections) do not set it
            flow_alive = torch.where(alive[None, :, None], flow_pw, 0.0)
            flow_max = global_batch.amax(torch.amax(torch.abs(flow_alive)).detach())
            flow_scale = flow_max + 1e-6
            extra = flow_pw / flow_scale
        with profiler.span("s3.raster_prep"):
            prepared = prepare_surfels_batch(
                sp, alive, xyz_cam, rot_cam, intrins, self.res, self.res,
                self.opts.get("sh_degree", 3), d.background(), self.raster_cfg,
                densify_dummy=dummy, extra_colors=extra,
            )
        ctx = {"samples": samples, "xyz_cam": xyz_cam, "rot_cam": rot_cam,
               "intrins": intrins, "flow_scale": flow_scale}
        return prepared, ctx

    @profiler.span("s3.forward")
    def loss(self, batch: Dict[str, torch.Tensor], dummy: torch.Tensor,
             use_2dgs_reg: bool = False):
        """The step's loss (`gs4d_trainer.py:378-617`). When data-parallel
        ranks split the batch (`ops.global_batch.over`), every term is this
        rank's part of the global batch's.

        Returns (total, loss_dict, render output, (xyz_cam, rot_cam,
        intrins) detached for the densify statistics)."""
        cfg = self._loss_config()
        res = self.res
        d = self.deformer
        sp = self.surfels.params
        mean, nz_mean = global_batch.mean, losses_mod.nonzero_mean
        prepared, ctx = self.render_inputs(batch, dummy)
        samples, xyz_cam, intrins = ctx["samples"], ctx["xyz_cam"], ctx["intrins"]
        with profiler.span("s3.composite"):
            out = composite_batch(prepared, res, res)
        m = xyz_cam.shape[0]
        img = lambda x: x.reshape(m, res, res, -1)
        gt_rgb, gt_mask, vis2d = img(batch["rgb"]), img(batch["mask"]), img(batch["vis2d"])
        rgb_out = out.color[..., :3]

        loss_dict = {}
        # rgb: L1 on vis2d pixels, + DSSIM against the masked GT
        loss_dict["rgb"] = (1.0 - cfg["lambda_dssim"]) * mean(
            torch.abs(rgb_out - gt_rgb) * vis2d)
        if cfg["lambda_dssim"] > 0:
            ssim_val = ssim(rgb_out.permute(0, 3, 1, 2),
                            (gt_rgb * gt_mask * vis2d).permute(0, 3, 1, 2))
            loss_dict["rgb_ssim"] = cfg["lambda_dssim"] * mean(1 - ssim_val)
        maskfg_vis = gt_mask * vis2d
        if prepared["n_extra"]:  # the 2 flow channels
            # composited surfel flow vs GT: uncertainty-gated, fg-masked,
            # SNR-gated, in units of the image width
            flow_img = out.color[..., 3:5] * ctx["flow_scale"]
            gt_flow = img(batch["flow"])
            uct_ok = (img(batch["flow_uct"]) > 0).to(flow_img.dtype)
            noise_px = cfg["flow_noise_px"]
            snr_w = 1.0
            if noise_px > 0:
                snr_w = torch.clamp(safe_norm(gt_flow, dim=-1, keepdim=True) / noise_px
                                    - 1.0, 0.0, 1.0)
            flow_l = safe_norm(flow_img - gt_flow, dim=-1, keepdim=True)
            loss_dict["flow"] = (nz_mean(flow_l * snr_w * uct_ok * maskfg_vis)
                                 / cfg["train_res"]) * cfg["flow_wt"]
        if cfg["depth_wt"] > 0 and "depth" in batch:
            depth_img = (out.depth / torch.clamp(out.alpha, min=1e-6))[..., None]
            depth_l = torch.abs(depth_img - img(batch["depth"]))
            loss_dict["depth"] = nz_mean(depth_l * maskfg_vis) * cfg["depth_wt"]
        balance = losses_mod.get_mask_balance_wt(gt_mask, vis2d, batch["is_detected"])
        mask_loss = ((out.alpha[..., None] - gt_mask) ** 2) * balance * vis2d
        is_det = batch["is_detected"].reshape(-1, 1, 1, 1)
        loss_dict["mask"] = nz_mean(mask_loss * is_det)

        if not cfg["rgb_loss_only"]:
            # feature reprojection on a uniform pixel subgrid of each frame
            if "feature" in samples and sp.regist_feat.shape[-1] > 0:
                feat_px = samples["feature"]
                hxy_px = batch["hxy"][..., :2]
                maskfg_px = batch["mask"]
                n_px = int(cfg["feat_reproj_px"] or 0)
                if 0 < n_px < feat_px.shape[1]:
                    sub = uniform_pixel_subsample(feat_px.shape[1], n_px,
                                                  int(cfg["train_res"]), feat_px.device)
                    feat_px, hxy_px, maskfg_px = sub(feat_px), sub(hxy_px), sub(maskfg_px)
                matches = d.global_match(feat_px, sp.regist_feat, sp.xyz)
                xy_reproj, _ = d.forward_project(matches, samples)
                reproj = safe_norm(xy_reproj - hxy_px, dim=-1, keepdim=True)
                loss_dict["feat_reproj"] = nz_mean(
                    reproj * maskfg_px.to(reproj.dtype)) / cfg["train_res"]

            # cycle + skin regularisers on a strided 1/cycle_subsample subset
            sub_c = max(int(cfg["cycle_subsample"] or 1), 1)
            cyc = d.cycle_loss(xyz_cam[:, ::sub_c], sp.xyz[::sub_c], samples)
            loss_dict["reg_deform_cyc"] = nz_mean(cyc["cyc_dist"])
            # a warp without bones returns neither skin term
            # (`gs4d_trainer.py:564-567`)
            if "delta_skin" in cyc:
                loss_dict["reg_delta_skin"] = nz_mean(cyc["delta_skin"])
            if "skin_entropy" in cyc:
                loss_dict["reg_skin_entropy"] = nz_mean(cyc["skin_entropy"])

            # 2DGS normal / distortion regularisers
            if use_2dgs_reg and cfg["lambda_normal"] > 0:
                _, surf_norm = surf_depth_and_normal(
                    out.depth / torch.clamp(out.alpha, min=1e-6), out.median_depth,
                    out.alpha, intrins)
                n_err = 1.0 - torch.sum(out.normal * surf_norm, dim=-1)
                loss_dict["normal_loss"] = cfg["lambda_normal"] * mean(n_err)
            if use_2dgs_reg and cfg["lambda_dist"] > 0:
                loss_dict["dist_loss"] = cfg["lambda_dist"] * mean(out.distortion)

            # the volume term does not depend on the batch: rank 0 adds it
            if cfg["reg_volume_loss_wt"] > 0:
                vol = cfg["reg_volume_loss_wt"] * torch.mean(
                    torch.prod(sf.get_scaling(sp), dim=1) * self.surfels.alive)
                loss_dict["reg_volume_loss"] = global_batch.once(vol)

            # ARAP rigidity of the bone centers between the global batch's
            # first pair (the rank holding it adds it)
            if cfg["arap_wt"] > 0 and "t_articulation" in samples:
                _, bones = dual_quaternion_to_quaternion_translation(
                    samples["t_articulation"])
                loss_dict["arap"] = global_batch.first_pair(
                    cfg["arap_wt"] * arap_bone_loss(bones[0], bones[1 % bones.shape[0]]))

        for k, wt_key in (("rgb", "rgb_wt"), ("mask", "mask_wt"),
                          ("rgb_ssim", "rgb_wt"),
                          ("feat_reproj", "feat_reproj_wt"),
                          ("reg_deform_cyc", "reg_deform_cyc_wt"),
                          ("reg_delta_skin", "reg_delta_skin_wt"),
                          ("reg_skin_entropy", "reg_skin_entropy_wt")):
            if k in loss_dict:
                loss_dict[k] = loss_dict[k] * cfg[wt_key]
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        warped = (xyz_cam.detach(), ctx["rot_cam"].detach(), intrins.detach())
        return total, loss_dict, out, warped

    @profiler.span("s3.step")
    def train_step(self, batch: Optional[Dict[str, torch.Tensor]] = None,
                   use_2dgs_reg: Optional[bool] = None) -> Dict:
        """One training step (`gs4d_trainer.py:621-707`): updates the surfel
        store and its Adam state, and the deformer with the warp AdamW
        (when ``gs_optim_warp``), in place. ``use_2dgs_reg`` None: from
        ``current_steps``. ``batch`` is the global batch; with a group each
        rank keeps its share. Returns a dict of 0-d tensors (the global
        batch's)."""
        if batch is None:
            batch = self._next_batch()
        share = None
        if self.group is not None:
            batch, share = sharding.shard_batch(batch, self.group)
        if use_2dgs_reg is None:
            use_2dgs_reg = self.use_2dgs_reg(self.current_steps)
        surf = self.surfels
        sp = surf.params
        res = self.res
        cfg = self.raster_cfg
        dparams = list(self.deformer.parameters())
        for p in (*dparams, *sp):
            p.grad = None
        dummy = torch.zeros((batch["frameid"].shape[0], surf.capacity, 2),
                            device=self.device, requires_grad=True)
        with global_batch.over(share):
            total, loss_dict, _, warped = self.loss(batch, dummy, use_2dgs_reg)
        with profiler.span("s3.backward"):
            total.backward()

        with torch.no_grad(), profiler.span("s3.stats"):
            sharding.all_reduce_grads_([*dparams, *sp], self.group)
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
            rects = compute_tile_rects(proj, res, res, cfg.tile, cfg.span_cap)
            vs = dummy.grad * proj.depth[..., None] * float(res)
            norms = safe_norm(vs, dim=-1)
            vis = rects.valid
            overflow = torch.sum((rects.overflow & rects.valid).to(torch.int32))
            if cfg.entry_cap:
                entries = torch.sum(torch.where(vis, rects.span_x * rects.span_y, 0), -1)
                truncated = torch.sum(torch.clamp(entries - cfg.entry_cap, min=0))
            else:
                truncated = torch.zeros((), dtype=torch.int64, device=self.device)
            grad_inc = torch.sum(torch.where(vis, norms, 0.0), 0)
            denom_inc = torch.sum(vis.to(surf.denom.dtype), 0)
            radii = torch.amax(torch.where(vis, proj.radius, 0.0), 0)
            if share is not None:
                # the dummy's gradient carries the share's weight already
                grad_inc = share.mesh.all_reduce_(grad_inc)
                denom_inc = share.mesh.all_reduce_(denom_inc * share.weight)
                radii = share.mesh.all_reduce_(radii, "max")
                counts = torch.stack([overflow.to(torch.int64), truncated.to(torch.int64)])
                counts = share.mesh.all_reduce_(
                    counts * int(share.weight == 1.0 or share.root))
                overflow, truncated = counts[0].to(overflow.dtype), counts[1]
            self.surfels = surf._replace(
                grad_accum=surf.grad_accum + grad_inc,
                denom=surf.denom + denom_inc,
                max_radii2d=torch.maximum(surf.max_radii2d, radii),
            )
        with profiler.span("s3.optim"):
            with torch.no_grad():
                self.gs_adam = gs_adam_update(sgrads, self.gs_adam, sp, self.gs_lrs)
            if self.warp_opt is not None:
                self.warp_opt.step()
        self.current_steps += 1
        if share is not None:
            loss_dict = sharding.reduce_metrics(loss_dict, share)
            total = sum(loss_dict[k] for k in sorted(loss_dict))

        return {
            "total": total.detach(),
            **{k: v.detach() for k, v in loss_dict.items()},
            "alive": self.surfels.num_alive(),
            "gnorm": gnorm,
            "overflow_splats": overflow,
            "truncated_entries": truncated,
        }

    # ------------------------------------------------------------------
    # the round's hooks
    # ------------------------------------------------------------------

    def _split_noise(self, m: int, shape) -> torch.Tensor:
        """Standard normal offsets of the split children of the densify at
        step m, from a generator seeded with m on the trainer's device (the
        JAX package draws them from PRNGKey(m); the streams differ)."""
        gen = torch.Generator(device=self.device).manual_seed(m)
        return torch.randn(shape, generator=gen, device=self.device)

    @profiler.span("s3.hooks")
    def _densify_hooks(self, span: int = 1) -> None:
        """Densify / opacity reset / outlier prune at the JAX cadence
        (`gs4d_trainer.py:830-875`). ``span`` is the number of steps just
        taken: a hook fires when a multiple of its interval lies in
        (current_steps - span, current_steps]. Each firing is appended to
        ``hook_log``."""
        o = self.opts
        it = self.current_steps
        until = o.get("densify_until_iter", 15000)
        reset_every = o.get("opacity_reset_interval", 3000)
        m = cadence_due(it, span, o.get("densification_interval", 100))
        if m is not None and o.get("densify_from_iter", 500) < m < until:
            # the screen- and world-size prune only after the first reset
            size_thr = 20.0 if m > reset_every else 0.0
            with profiler.span("s3.densify"):
                self.surfels, self.gs_adam, info = densify_mod.densify_and_prune(
                    self.surfels, self.gs_adam,
                    self._split_noise(m, (self.surfels.capacity, 2, 2)),
                    extent=o.get("cameras_extent", 1.0), max_screen_size=size_thr,
                    config=densify_mod.DensifyConfig(
                        grad_threshold=o.get("densify_grad_threshold", 2e-4),
                        min_opacity=0.005, percent_dense=o.get("percent_dense", 0.01)))
            self.hook_log.append({"hook": "densify", "step": m, **info})
        m = cadence_due(it, span, reset_every)
        if m is not None and m < until:
            with profiler.span("s3.reset_opacity"):
                self.surfels, self.gs_adam = densify_mod.reset_opacity(self.surfels,
                                                                       self.gs_adam)
            self.hook_log.append({"hook": "reset_opacity", "step": m})
        m = cadence_due(it, span, o.get("outlier_filtering_interval", 2000))
        if m is not None and m < o.get("outlier_stop_iter", 29000):
            with profiler.span("s3.outlier"):
                mask = densify_mod.radius_outlier_mask(
                    self.surfels.params.xyz, self.surfels.alive, nb_points=20, radius=0.004)
                self.surfels = densify_mod.prune_by_mask(self.surfels, mask)
            self.hook_log.append({"hook": "outlier", "step": m,
                                  "pruned": torch.sum(mask.to(torch.int64))})

    def _after_chunk(self, steps: int) -> None:
        self._densify_hooks(span=steps)

    def _rollback_state(self) -> tuple:
        """All of `state_tensors`, and both optimisers' counts
        (`gs4d_trainer.py:713`)."""
        warp = self.warp_opt.count if self.warp_opt is not None else None
        return self.state_tensors(), (self.gs_adam.count, warp)

    def _set_counts(self, counts: tuple) -> None:
        self.gs_adam = self.gs_adam._replace(count=counts[0])
        if self.warp_opt is not None:
            self.warp_opt.count = counts[1]

    def _before_round(self, rnd: int, logger) -> int:
        """An eval render of frame 0 to the logger (rank 0's); returns where
        the round's entries of ``hook_log`` start."""
        if self.is_root:
            eval_batch = construct_batch(inst_id=0, frameid_sub=np.arange(1),
                                         eval_res=self.res, field2cam=None, camera_int=None,
                                         crop2raw=None, device=self.device)
            rendered = self.render_batch(eval_batch, res=self.res)
            logger.image(rnd, "eval/rendered", rendered["rendered"][0])
            logger.image(rnd, "eval/mask", rendered["mask"][0])
        return len(self.hook_log)

    def _round_note(self, metrics: Dict, first_hook: int) -> str:
        """The last total, the alive surfels, the coverage losses and the
        round's hooks."""
        overflow = int(metrics["overflow_splats"])
        truncated = int(metrics["truncated_entries"])
        cover = ""
        if overflow or truncated:
            cover = (f" [coverage: {overflow} span-clamped splats,"
                     f" {truncated} budget-dropped entries]")
        return (f" total={float(metrics['total']):.4f} alive={int(metrics['alive'])}{cover}"
                f"{hooks_note(self.hook_log[first_hook:])}")

    # ------------------------------------------------------------------
    # rendering and checkpoints
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_batch(self, batch: Dict, res: Optional[int] = None,
                     no_warp: bool = False) -> Dict[str, np.ndarray]:
        """Render the frames of a `construct_batch` dict
        (`gs4d_trainer.py:924-967`), forward only (one launch of the
        forward tile kernel): (M, res, res, c) numpy arrays "rendered" (the
        background composited by the kernel), "mask", "depth", "normal",
        "median_depth". no_warp: the canonical surfels."""
        res = res or self.res
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if "frameid" not in batch:
            offset = torch.as_tensor(self.frame_info.frame_offset_raw, device=self.device)
            batch["frameid"] = batch["frameid_sub"] + offset[batch["dataid"].long()]
        d = self.deformer
        sp = self.surfels.params
        samples = d.get_samples(batch)
        xyz_cam, rot_cam, _ = d.warp_surfels(sp.xyz, sf.get_rotation(sp), samples,
                                             no_warp=no_warp)
        intrins = geom.mat2K(geom.Kmatinv(samples["Kinv"]))
        out = render_surfels_batch(sp, self.surfels.alive, xyz_cam, rot_cam, intrins, res,
                                   res, self.opts.get("sh_degree", 3), d.background(),
                                   self.raster_cfg)
        result = {"rendered": out.color, "mask": out.alpha[..., None],
                  "depth": out.depth[..., None], "normal": out.normal,
                  "median_depth": out.median_depth[..., None]}
        return {k: v.cpu().numpy() for k, v in result.items()}

    def save_checkpoint(self, round_count: int) -> None:
        """Write ``ckpt_NNNN.pth`` and ``ckpt_latest.pth`` and the alive
        surfels as ``point_cloud_NNNN.ply`` (`gs4d_trainer.py:969-988`).
        The payload has the JAX package's keys: "current_steps",
        "current_round", "params" (the deformer, by state_dict name),
        "surfels", "gs_adam", "opts", and no warp-optimiser state; it holds
        only dicts of numpy arrays and Python values, so reading it needs
        neither this package nor torch. Of a group's ranks, rank 0 alone
        writes."""
        if not self.is_root:
            return
        npy = lambda x: x.detach().cpu().numpy()
        fields = lambda tree: {f: npy(v) for f, v in zip(sf.SurfelParams._fields, tree)}
        s, a = self.surfels, self.gs_adam
        payload = {
            "current_steps": self.current_steps,
            "current_round": round_count,
            "params": {k: npy(v) for k, v in self.deformer.state_dict().items()},
            "surfels": {"params": fields(s.params),
                        **{f: npy(getattr(s, f)) for f in sf.SurfelState._fields[1:]}},
            "gs_adam": {"count": a.count, "mu": fields(a.mu), "nu": fields(a.nu)},
            "opts": {k: v for k, v in self.opts.items() if not callable(v)},
        }
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        for name in (f"ckpt_{round_count:04d}.pth", "ckpt_latest.pth"):
            with open(os.path.join(self.save_dir, name), "wb") as f:
                f.write(data)
        save_ply(os.path.join(self.save_dir, f"point_cloud_{round_count:04d}.ply"),
                 sf.SurfelParams(**payload["surfels"]["params"]), payload["surfels"]["alive"])

    def load_checkpoint(self, path: str, reset_steps: bool = True) -> Dict:
        """Load a checkpoint of `save_checkpoint` or of the JAX trainer
        (`gs4d_trainer.py:990`; read by `convert.load_jax_checkpoint`,
        without JAX): the deformer (in place, so the warp AdamW keeps its
        parameters; its moments are not in the file and stay as they are;
        a JAX file holds a flax tree, the port's a state dict), the surfel
        store and its Adam; the step and round counters too unless
        ``reset_steps``. Returns the payload."""
        payload = convert.load_jax_checkpoint(path)
        params = payload["params"]
        if isinstance(params.get("params"), dict):  # the JAX trainer's flax tree
            convert.load_flax_params_(self.deformer, params)
        else:
            self.deformer.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        self.surfels = convert.surfel_state_from_jax(payload["surfels"], self.device)
        self.gs_adam = convert.gs_adam_from_jax(payload["gs_adam"], self.device)
        if not reset_steps:
            self.current_steps = payload["current_steps"]
            self.current_round = payload["current_round"]
        self.broadcast_state()
        return payload

    def load_stage2(self, path: str) -> list:
        """Take over the warp, camera MLP, logscale and intrinsics of a
        Stage-2 checkpoint of the JAX package (`gs4d_trainer.py:1001`),
        in place. Returns the keys copied."""
        keys = transfer_stage2_params(convert.load_jax_checkpoint(path)["params"],
                                      self.deformer)
        self.broadcast_state()
        return keys


def hooks_note(events) -> str:
    """The hooks of a round for its console line, e.g.
    `` [hooks: densify@40 cloned=3 split=5 ...; outlier@40 pruned=2]``."""
    if not events:
        return ""
    parts = []
    for e in events:
        counts = " ".join(f"{k}={int(v)}" for k, v in e.items() if k not in ("hook", "step"))
        parts.append(f"{e['hook']}@{e['step']}" + (f" {counts}" if counts else ""))
    return " [hooks: " + "; ".join(parts) + "]"
