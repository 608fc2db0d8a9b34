"""Stage-2 trainer: round-based optimisation of the neural SDF model
(`vidu4d_tpu/engine/trainer.py`).

Per round: each field's proxy geometry is refreshed (the SDF on a grid ->
marching tetrahedra -> aabb and near/far), each field's canonical mesh and
its features are exported (the fg one is what Stage 3 starts from), then
``iters_per_round`` steps of `train_step` run. `mlp_init` first fits the
intrinsics and every field's camera MLP to their priors (the fg camera
prior for both fields, as the JAX trainer does) and pretrains the SDFs to
a sphere. ``field_type`` "fg", "bg" and "comp" (both) are supported, with
every ``fg_motion`` of `warp_module`.

Checkpoints (``ckpt_NNNN.pth``, ``ckpt_latest.pth``) are pickled dicts of
numpy arrays: "params" in the JAX package's flax layout, so that the
port's and the JAX package's Stage 3 read them (``--load_path``), the
field states, the optimiser state and the options. `load_checkpoint` also
reads the JAX trainer's checkpoints, without JAX.

Random draws (the sampled regularisers of each step, the SDF pretrain's
points) come from ``torch.Generator``s seeded as the JAX package seeds its
keys (the step number; 123 for the pretrain); both functions take the
draws as an argument too.

``--ngpu N`` (``group``, a `parallel.sharding.Mesh` of N ranks) is data
parallelism over frame pairs that gives the one-process step's numbers:
every rank draws the global batch and keeps its share of the pairs,
`DvrModel.loss` normalises every term by global counts (the sampled
regularisers and the camera prior on rank 0 only), and the gradients are
summed over the ranks in one buffer before gnorm, the NaN zeroing, the
clipping and AdamW read them. `mlp_init` and the proxy geometry run on rank
0 and are broadcast; checkpoints, meshes, logs and console lines are rank
0's only.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vidu4d_tpu_torch import convert
from vidu4d_tpu_torch.engine.model import FIELD_CATEGORIES, DvrModel
from vidu4d_tpu_torch.engine.optim import adam_step_, make_stage2_optimizer
from vidu4d_tpu_torch.engine.rounds import RoundTrainer
from vidu4d_tpu_torch.engine.schedules import progress_schedule
from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
from vidu4d_tpu_torch.models.fields.time_mlp import (
    camera_prior_loss,
    fit_to_prior,
    init_camera_base_params,
    init_intrinsics_base_params,
    intrinsics_prior_loss,
)
from vidu4d_tpu_torch.ops import geometry as geom
from vidu4d_tpu_torch.ops import global_batch
from vidu4d_tpu_torch.ops.marching import extract_mesh_np, sample_mesh_surface, save_obj
from vidu4d_tpu_torch.ops.numerics import safe_norm, safe_normalize
from vidu4d_tpu_torch.ops.quaternion import quaternion_translation_to_se3
from vidu4d_tpu_torch.parallel import sharding
from vidu4d_tpu_torch.utils.profiler import span

# the loss options and their JAX defaults (`trainer.py:152-172`)
LOSS_DEFAULTS = {
    "field_type": "fg", "train_res": 256, "no_loss_mask": False,
    "maskloss_no_vis2d": False, "mask_wt": 0.1, "rgb_wt": 0.1, "depth_wt": 1e-4,
    "flow_wt": 0.5, "vis_wt": 1e-2, "feature_wt": 1e-2, "feat_reproj_wt": 5e-2,
    "reg_visibility_wt": 1e-4, "reg_eikonal_wt": 1e-3, "reg_deform_cyc_wt": 0.01,
    "reg_delta_skin_wt": 5e-3, "reg_skin_entropy_wt": 5e-4, "reg_gauss_skin_wt": 1e-3,
    "reg_cam_prior_wt": 0.1, "reg_skel_prior_wt": 0.1, "reg_gauss_mask_wt": 0.01,
    "reg_soft_deform_wt": 100.0, "lambda_normal": 0.05, "lambda_dist": 0.0,
}
# points of one SDF-pretrain iteration (`trainer.py:236`)
N_SDF_INIT = 5000
# rays per chunk of an eval render
RENDER_CHUNK = 8192


class Stage2Trainer(RoundTrainer):
    """Stage-2 trainer state, its step and its round loop
    (`rounds.RoundTrainer`), on ``device`` (the card by default; the CPU
    only when asked for with ``device="cpu"``). opts: the JAX trainer's
    option dict. Parameters are drawn from a ``torch.Generator`` seeded
    with ``max(opts["seed"], 0)``."""

    UNLOGGED = ("gnorm",)

    def __init__(self, opts: Dict, device="cuda", datasets=None, data_info=None,
                 group: Optional[sharding.Mesh] = None):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Stage2Trainer: CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        super().__init__(opts, device, datasets, data_info, group, imgs_per_gpu=256)
        opts = self.opts
        self.total_steps = opts["num_rounds"] * opts["iters_per_round"]
        seed = max(opts.get("seed", 0), 0)

        # the fg camera prior (index 1 of the rtmat stack), translations at
        # the init scale 0.1
        rtmat = self.data_info.get("rtmat")
        prior = rtmat[1] if rtmat is not None else np.tile(
            np.eye(4, dtype=np.float32), (self.frame_info.num_frames_raw, 1, 1))
        self.rt_scaled = prior.copy()
        self.rt_scaled[:, :3, 3] *= 0.1

        # one instance code per video with --nosingle_inst (`trainer.py:88`)
        self.num_inst = 1 if opts.get("single_inst", True) else self.frame_info.num_vids
        self.model = DvrModel(
            self.frame_info, field_type=opts.get("field_type", "fg"),
            fg_motion=opts.get("fg_motion", "bob"), num_inst=self.num_inst,
            rtmat_prior=self.rt_scaled, rgb_timefree=opts.get("rgb_timefree", False),
            rgb_dirfree=opts.get("rgb_dirfree", False),
            use_wide_near_far=opts.get("use_wide_near_far", False),
            train_depth_samples=opts.get("train_depth_samples", 64),
            field_depth=opts.get("field_depth", 8), field_width=opts.get("field_width", 256),
            device=self.device, generator=torch.Generator(self.device).manual_seed(seed))
        # one state per field, in the model's category order (fg, then bg)
        self.states = {cate: FieldState.initial(self.frame_info.num_frames_raw,
                                                device=self.device)
                       for cate in FIELD_CATEGORIES[opts.get("field_type", "fg")]}
        # the JAX trainer draws one batch to initialise its parameters
        # (`trainer.py:179`): its draws are made here too (nothing is read),
        # so the same seed gives the same training batches
        self.batcher.draw()
        self.optimizer = make_stage2_optimizer(
            self.model, learning_rate=opts.get("learning_rate", 5e-4),
            total_steps=self.total_steps, num_rounds=opts["num_rounds"],
            intrinsics_lr_mult=opts.get("intrinsics_lr_mult", 1.0))
        # each field's proxy mesh (verts, faces), once it has one (rank 0's)
        self.proxy_meshes: Dict[str, tuple] = {}
        self.broadcast_state()

    def state_tensors(self) -> list:
        """The model's parameters and buffers, the field states and the
        optimiser's moments."""
        return [*self.model.state_dict().values(),
                *(x for st in self.states.values() for x in st),
                *self.optimizer.mu.values(), *self.optimizer.nu.values()]

    @property
    def _proxy_mesh(self):
        """The first field's proxy mesh (fg's, when there is an fg field),
        or None."""
        return self.proxy_meshes.get(next(iter(self.states)))

    def _loss_config(self) -> Dict:
        return {k: self.opts.get(k, v) for k, v in LOSS_DEFAULTS.items()}

    # ------------------------------------------------------------------
    # mlp_init: prior fits + SDF pretrain (`trainer.py:188`)
    # ------------------------------------------------------------------

    def mlp_init(self, sdf_iters: int = 1000, verbose: bool = True) -> Dict:
        """Fit the intrinsics MLP (to loss 1) and each field's camera MLP
        (to 1e-4) to their priors (the fg camera prior for every field,
        `trainer.py:198-219`), pretrain the SDFs to a sphere, then build
        the proxy geometry with beta 0. Returns the fits' losses, steps and
        seconds. Of a group's ranks, rank 0 fits and the others take its
        result (and return {})."""
        if not self.is_root:
            self.broadcast_state()
            self.update_geometry_aux(beta=0.0)
            return {}
        info = {}
        t0 = time.perf_counter()
        intr = self.model.intrinsics
        init_intrinsics_base_params(intr, self.data_info["intrinsics"], self.frame_info)
        intr_prior = torch.as_tensor(self.data_info["intrinsics"], device=self.device)
        loss, steps = fit_to_prior(lambda: intrinsics_prior_loss(intr, intr_prior),
                                   intr.parameters(), termination_loss=1.0)
        info["intrinsics"] = {"loss": loss, "steps": steps,
                              "seconds": time.perf_counter() - t0}
        frame_map = np.asarray(self.frame_info.frame_mapping)
        prior = torch.as_tensor(self.rt_scaled[frame_map], device=self.device)
        for cate in self.states:
            t0 = time.perf_counter()
            cam = self.model.fields[cate].camera_mlp
            init_camera_base_params(cam, self.rt_scaled, self.frame_info)
            loss, steps = fit_to_prior(lambda: camera_prior_loss(cam, prior),
                                       cam.parameters(), termination_loss=1e-4)
            info[f"camera_{cate}"] = {"loss": loss, "steps": steps,
                                      "seconds": time.perf_counter() - t0}
            if verbose:
                print(f"[mlp_init] camera[{cate}]: loss={loss:.6f} steps={steps} "
                      f"({info[f'camera_{cate}']['seconds']:.2f} s)")
        if verbose:
            i = info["intrinsics"]
            print(f"[mlp_init] intrinsics: loss={i['loss']:.6f} steps={i['steps']} "
                  f"({i['seconds']:.2f} s)")
        t0 = time.perf_counter()
        info["sdf_loss"] = self._geometry_init(sdf_iters=sdf_iters, verbose=verbose)
        info["sdf_seconds"] = time.perf_counter() - t0
        self.broadcast_state()
        self.update_geometry_aux(beta=0.0)
        return info

    def geometry_init_draws(self, sdf_iters: int) -> List[Dict]:
        """The SDF pretrain's draws: per iteration, and one more for the
        final loss, {cate: (uniform (N_SDF_INIT, 3), instance ids)}."""
        gen = torch.Generator(self.device).manual_seed(123)
        return [{cate: (torch.rand((N_SDF_INIT, 3), generator=gen, device=self.device),
                        torch.randint(0, self.num_inst, (N_SDF_INIT,), generator=gen,
                                      device=self.device))
                 for cate in sorted(self.states)} for _ in range(sdf_iters + 1)]

    def _geometry_init(self, sdf_iters: int = 1000, radius: float = 0.1,
                       verbose: bool = True, draws: Optional[List[Dict]] = None) -> float:
        """SDF-to-sphere pretrain (`trainer.py:225`): Adam 1e-3 on the sum
        over the fields (in sorted order: bg, then fg) of the SDF error at
        points drawn in the 0.25-extended aabb, with a visibility and an
        eikonal term. ``draws``: `geometry_init_draws`. Returns the loss on
        the last draw after the last step."""
        draws = draws if draws is not None else self.geometry_init_draws(sdf_iters)

        def loss_fn(draw):
            losses = []
            for cate in sorted(self.states):
                u, inst_id = draw[cate]
                aabb = geom.extend_aabb(self.states[cate].aabb, factor=0.25)
                pts = (aabb[0] + u * (aabb[1] - aabb[0])).requires_grad_(True)
                sdf_gt = torch.linalg.norm(pts.detach(), dim=-1, keepdim=True) - radius
                field = self.model.fields[cate]
                sdf, _ = field.sdf(pts, inst_id=inst_id)
                vis = field.visibility(pts, inst_id)
                g = torch.autograd.grad(sdf.sum(), pts, create_graph=True)[0]
                eik = (safe_norm(g, dim=-1) - 1.0) ** 2
                losses.append(torch.mean((sdf - sdf_gt) ** 2)
                              - torch.mean(F.logsigmoid(vis)) * 0.01
                              + torch.sum(eik) / torch.clamp(torch.sum(eik > 0), min=1.0)
                              * 1e-5)
            return sum(losses)

        params = [p for cate in self.states for m in (self.model.fields[cate].basefield,
                                                      self.model.fields[cate].sdf_head,
                                                      self.model.fields[cate].vis_field)
                  for p in m.parameters()]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        for i in range(sdf_iters):
            grads = torch.autograd.grad(loss_fn(draws[i]), params)
            adam_step_(params, grads, mu, nu, i + 1, 1e-3)
        final = float(loss_fn(draws[sdf_iters]).detach())
        if verbose:
            print(f"[mlp_init] sdf pretrain loss={final:.6f}")
        return final

    # ------------------------------------------------------------------
    # proxy geometry (`trainer.py:271`)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def update_geometry_aux(self, beta: float = 0.9, grid_size: int = 64,
                            n_proxy: int = 64) -> None:
        """The SDF on a grid over the 0.5-extended aabb -> marching tets ->
        the proxy mesh; its bounds and the near/far planes of n_proxy
        surface points under the current cameras, blended into the field
        state with weight ``beta`` on the old. Of a group's ranks, rank 0
        computes and the others take its field states."""
        if not self.is_root:
            sharding.broadcast_tensors_([x for st in self.states.values() for x in st],
                                        self.group)
            return
        self._update_geometry_aux(beta, grid_size, n_proxy)
        sharding.broadcast_tensors_([x for st in self.states.values() for x in st],
                                    self.group)

    def _update_geometry_aux(self, beta: float, grid_size: int, n_proxy: int) -> None:
        for cate, state in self.states.items():
            aabb_ext = geom.extend_aabb(state.aabb, factor=0.5)
            ext = aabb_ext.cpu().numpy()
            axes = [np.linspace(float(ext[0][i]), float(ext[1][i]), grid_size)
                    for i in range(3)]
            grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
            pts = torch.as_tensor(grid.astype(np.float32), device=self.device)
            field = self.model.fields[cate]
            sdf = field.sdf(pts)[0].reshape(grid_size, grid_size, grid_size)
            verts, faces = extract_mesh_np(sdf, aabb_ext)
            if len(verts) < 4:
                continue
            self.proxy_meshes[cate] = (verts, faces)
            proxy_pts, _, _ = sample_mesh_surface(verts, faces, n_proxy,
                                                  rng=np.random.default_rng(0))
            proxy = torch.as_tensor(np.asarray(proxy_pts, np.float32), device=self.device)
            new_aabb = torch.as_tensor(np.stack([verts.min(0), verts.max(0)]).astype(
                np.float32), device=self.device)
            aabb = state.aabb * beta + new_aabb * (1 - beta)
            rtmat = quaternion_translation_to_se3(*field.camera_vals())
            near_far = geom.get_near_far(proxy, rtmat)
            frame_map = torch.as_tensor(np.asarray(self.frame_info.frame_mapping),
                                        device=self.device)
            nf = state.near_far.clone()
            nf[frame_map] = nf[frame_map] * beta + near_far * (1 - beta)
            self.states[cate] = FieldState(aabb=aabb, near_far=nf, proxy_pts=proxy)

    def export_proxy_mesh(self, path: str) -> None:
        """The first field's proxy mesh as an OBJ (none before it has one)."""
        if self._proxy_mesh is not None:
            save_obj(path, *self._proxy_mesh)

    def export_geometry(self, rnd: int) -> None:
        """Per field (``cate`` fg / bg) with a proxy mesh: ``NNN-<cate>-geo.obj``
        (the proxy mesh), ``NNN-<cate>-geo-colors.npy`` (colours at the
        vertices, seen along the SDF gradient at frame 0) and
        ``NNN-<cate>-feat.npy`` (16-dim unit features at the vertices)
        (`trainer.py:490`), by rank 0 of a group. The fg files are the mesh
        Stage 3 starts from.
        The JAX trainer keeps one proxy mesh, the last field's, and writes
        it under the fg name with the first field's colours and features:
        for "comp" the bg mesh; the port writes each field's own."""
        if not self.is_root:
            return
        for cate, (verts, faces) in self.proxy_meshes.items():
            path = os.path.join(self.save_dir, f"{rnd:03d}-{cate}-geo.obj")
            save_obj(path, verts, faces)
            field = self.model.fields[cate]
            verts = torch.as_tensor(np.asarray(verts, np.float32), device=self.device)
            with torch.enable_grad():
                pts = verts.clone().requires_grad_(True)
                g = torch.autograd.grad(field.sdf(pts)[0].sum(), pts)[0]
            with torch.no_grad():
                feats = field.features(verts)
                fid = torch.zeros(verts.shape[0], dtype=torch.int64, device=self.device)
                rgb, _ = field.query(verts[:, None, None],
                                     direction=safe_normalize(g)[:, None, None],
                                     frame_id=fid, inst_id=fid)
            np.save(os.path.join(self.save_dir, f"{rnd:03d}-{cate}-feat.npy"),
                    feats.cpu().numpy())
            np.save(path.replace(".obj", "-colors.npy"), rgb[:, 0, 0].cpu().numpy())

    # ------------------------------------------------------------------
    # the step and the round's hooks (`trainer.py:318-488`)
    # ------------------------------------------------------------------

    @span("s2.step")
    def train_step(self, batch: Optional[Dict[str, torch.Tensor]] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One step: loss, backward, the optimiser's update. ``batch``
        defaults to the batcher's next one, ``draws`` to the step's
        (`DvrModel.reg_draws` from a generator seeded with the step
        number). Returns 0-d tensors: every weighted loss term, "total" and
        "gnorm" (the gradients' global norm before clipping), the global
        batch's. Advances ``current_steps``. ``batch`` is the global
        batch; with a group each rank keeps its share and the gradients are
        summed over the ranks before the optimiser reads them."""
        if batch is None:
            batch = self._next_batch()
        share = None
        if self.group is not None:
            batch, share = sharding.shard_batch(batch, self.group)
        if draws is None:
            draws = self.model.reg_draws(
                torch.Generator(self.device).manual_seed(self.current_steps))
        cfg = self._loss_config()
        weights = progress_schedule(cfg, self.current_steps)
        self.model.zero_grad(set_to_none=True)
        with global_batch.over(share):
            loss_dict, _ = self.model.loss(batch, self.states, cfg, weights, draws)
        total = sum(loss_dict.values())
        with span("s2.backward"):
            total.backward()
            sharding.all_reduce_grads_(list(self.model.parameters()), self.group)
        with span("s2.optim"):
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            self.optimizer.step()
        self.current_steps += 1
        if share is not None:
            loss_dict = sharding.reduce_metrics(loss_dict, share)
            total = sum(loss_dict.values())
        return {**{k: v.detach() for k, v in loss_dict.items()}, "total": total.detach(),
                "gnorm": gnorm}

    def _rollback_state(self) -> tuple:
        """The model's parameters and buffers and AdamW's moments, and its
        count; not the field states (`trainer.py:366`)."""
        opt = self.optimizer
        tensors = [*self.model.state_dict().values(), *opt.mu.values(), *opt.nu.values()]
        return tensors, (opt.count,)

    def _set_counts(self, counts: tuple) -> None:
        (self.optimizer.count,) = counts

    def _round_result(self, metrics: Dict) -> float:
        """The last step's total, as a float."""
        return float(metrics["total"])

    def _before_round(self, rnd: int, logger) -> None:
        """The proxy geometry, then its export (`trainer.py:468`)."""
        self.update_geometry_aux()
        self.export_geometry(rnd)

    def _round_note(self, total: float, before) -> str:
        return f" loss={total:.4f}"

    # ------------------------------------------------------------------
    # rendering (`trainer.py:516`)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def render_batch(self, batch: Dict, res: int, no_warp: bool = False,
                     chunk: int = RENDER_CHUNK) -> Dict[str, np.ndarray]:
        """Render the frames of a `construct_batch` dict with the eval path
        (importance sampling, aabb mask), frame by frame in chunks of
        ``chunk`` rays: (M, res, res, c) numpy arrays, the colour-like ones
        composited over black by the mask. Rays are independent, so chunks
        join into the whole frame's render ("vis", normalised by the
        frame's mean transmittance, is joined by its "vis_norm")."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if "frameid" not in batch:
            offset = torch.as_tensor(self.frame_info.frame_offset_raw, device=self.device)
            batch["frameid"] = batch["frameid_sub"] + offset[batch["dataid"].long()]
        n = batch["frameid"].shape[0]
        n_rays = batch["hxy"].shape[1]
        frames = []
        for i in range(n):
            one = {k: v[i:i + 1] for k, v in batch.items()}
            parts = []
            for s in range(0, n_rays, chunk):
                part = dict(one, hxy=one["hxy"][:, s:s + chunk])
                rendered, _ = self.model.render(part, self.states, train=False,
                                                no_warp=no_warp)
                parts.append(rendered)
            norms = torch.stack([p.pop("vis_norm") for p in parts])
            sizes = torch.tensor([p["mask"].shape[1] for p in parts], device=self.device)
            out = {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
            vis_scale = torch.repeat_interleave(norms, sizes)[None, :, None]
            out["vis"] = out["vis"] * vis_scale / (torch.sum(norms * sizes) / n_rays)
            frames.append(out)
        merged = {}
        for k in frames[0]:
            v = torch.cat([f[k] for f in frames], dim=0).cpu().numpy()
            merged[k] = v.reshape(n, res, res, -1) if v.ndim == 3 else v
        for k in list(merged):
            if k != "mask" and "mask" not in k and merged[k].ndim == 4:
                merged[k] = merged[k] * merged["mask"]
        return merged

    # ------------------------------------------------------------------
    # checkpoints (`trainer.py:555`)
    # ------------------------------------------------------------------

    def save_checkpoint(self, round_count: int) -> None:
        """``ckpt_NNNN.pth`` and ``ckpt_latest.pth``: "current_steps",
        "current_round", "params" (the flax tree), "states" ({cate: {aabb,
        near_far, proxy_pts}}), "opt_state" ({count, mu, nu} by state-dict
        name), "opts"; dicts of numpy arrays and Python values only. Of a
        group's ranks, rank 0 alone writes."""
        if not self.is_root:
            return
        npy = lambda t: t.detach().cpu().numpy()
        opt = self.optimizer
        payload = {
            "current_steps": self.current_steps,
            "current_round": round_count,
            "params": convert.dvr_flax_from_state_dict(self.model.state_dict()),
            "states": {c: {f: npy(v) for f, v in zip(FieldState._fields, s)}
                       for c, s in self.states.items()},
            "opt_state": {"count": opt.count, "mu": {k: npy(v) for k, v in opt.mu.items()},
                          "nu": {k: npy(v) for k, v in opt.nu.items()}},
            "opts": {k: v for k, v in self.opts.items() if not callable(v)},
        }
        data = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        for name in (f"ckpt_{round_count:04d}.pth", "ckpt_latest.pth"):
            with open(os.path.join(self.save_dir, name), "wb") as f:
                f.write(data)

    def load_checkpoint(self, path: str, reset_steps: bool = True) -> Dict:
        """Load a checkpoint of `save_checkpoint` or of the JAX trainer
        (read by `convert.load_jax_checkpoint`, without JAX): the model's
        parameters (in place), the field states, the optimiser state; the
        step and round counters too unless ``reset_steps``. Returns the
        payload."""
        payload = convert.load_jax_checkpoint(path)
        if not isinstance(payload["params"].get("params"), dict):
            raise ValueError(f"{path} is not a Stage-2 checkpoint (its parameters are not "
                             "a flax tree)")
        sd = convert.dvr_state_dict_from_flax(payload["params"])
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self.states = convert.field_states_from_checkpoint(payload["states"], self.device)
        opt_state = payload.get("opt_state")
        if isinstance(opt_state, dict):
            t = lambda tree: {k: torch.tensor(v, device=self.device) for k, v in tree.items()}
            self.optimizer.load_state({"count": opt_state["count"], "mu": t(opt_state["mu"]),
                                       "nu": t(opt_state["nu"])})
        elif opt_state is not None:
            self.optimizer.load_state(convert.warp_adamw_from_optax(opt_state, self.model,
                                                                    self.device))
        if not reset_steps:
            self.current_steps = payload["current_steps"]
            self.current_round = payload["current_round"]
        self.broadcast_state()
        return payload
