"""Data parallelism over frame pairs (`vidu4d_tpu/parallel/sharding.py`).

The reference trains on several GPUs with DDP over NCCL
(`lab4d/train.py:28-36`). The JAX package's ``--ngpu N`` is one GSPMD
program over a (data, surfel) mesh: frames ride "data", XLA inserts the
all-reduce, and the step gives the one-device step's numbers by
construction. The port runs N processes ("ranks") of `torch.distributed`
instead, one card each over NCCL (or gloo: the CPU, or ranks sharing one
card), and holds them to the same numbers:

* every rank draws the whole global batch from the same seed and keeps its
  share (`shard_batch`): whole pairs (the flow and cycle terms read a
  pair's two frames together), contiguous and equal when the pairs divide
  by the world size; otherwise every rank keeps every pair and weights its
  sums by 1 / world, as JAX replicates an axis that does not divide
  (`sharding.py:59-64`);
* a loss is a local sum over a global count, never a mean of means: the
  step runs its loss inside `ops.global_batch.over(share)`, whose
  reductions all-reduce the counts (detached);
* the gradients are all-reduced with SUM in one flat buffer per step
  (`all_reduce_grads_`), not averaged, before anything reads them;
* terms that do not depend on the batch count once: only rank 0 adds
  them (`global_batch.once`);
* initial state is broadcast from rank 0 (`broadcast_tensors_`), and
  `checksum_agrees` tells whether the ranks still hold the same state.

JAX's "surfel" mesh axis is not ported: it is a GSPMD layout of the
capacity dimension, not a semantics, and 400k slots fit on one card.

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
gloo takes CUDA tensors for. `spawn` starts the ranks of one node with a
``file://`` store in a temporary directory, never a fixed TCP port.

`make_synthetic_stage3_inputs` / `build_stage3_train_step` and
`make_synthetic_stage2_inputs` / `build_stage2_train_step` are the JAX
module's reduced dryrun steps, over the port's group.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vidu4d_tpu_torch.data.frame_info import FrameInfo
from vidu4d_tpu_torch.ops import global_batch


class Mesh(NamedTuple):
    """One rank's view of its data-parallel group: its ``rank`` of
    ``world``, the ``backend`` ("nccl" or "gloo"), the ``device`` it
    computes on and the process ``group`` (None for a single process
    without a group, where every collective is the identity)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: Any = None

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks in place ("sum" or "max")."""
        if self.group is not None:
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                            group=self.group)
        return x

    def broadcast_(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        if self.group is not None:
            dist.broadcast(x, src=0, group=self.group)
        return x


class Share(NamedTuple):
    """This rank's part of a global batch of pairs: pairs ``lo`` to ``hi``
    (frames 2 lo to 2 hi of the flattened batch), each of its sums counted
    with ``weight`` (1, or 1 / world where every rank holds every pair)."""

    mesh: Mesh
    lo: int
    hi: int
    weight: float

    @property
    def root(self) -> bool:
        """Whether this rank adds the terms that do not depend on the batch."""
        return self.mesh.rank == 0

    @property
    def holds_first(self) -> bool:
        """Whether this rank holds the global batch's first pair."""
        return self.lo == 0


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def check_cards(n_ranks: int, device) -> None:
    """Raise ValueError when ``n_ranks`` ranks of one card each ask for more
    cards than are visible (JAX's `make_mesh` fails there too)."""
    if torch.device(device).type == "cuda" and n_ranks > visible_cards():
        raise ValueError(f"--ngpu {n_ranks} needs {n_ranks} CUDA devices, but "
                         f"{visible_cards()} are visible")


def make_mesh(n_devices: Optional[int] = None, data_axis: Optional[int] = None,
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """The group descriptor of this process (JAX: the (data, surfel) mesh
    over the first ``n_devices`` devices).

    A process group that is initialised already (`spawn`'s ranks, or
    ``init_process_group`` by the caller) is used as it is. Otherwise a
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as torchrun sets them) initialises one, with
    ``backend`` (default: nccl on CUDA, gloo on the CPU). Otherwise this is
    one process without a group. ``n_devices``, when given, must be the
    world size; ``data_axis`` must be None or the world size (the port has
    no surfel axis). ``device`` "cuda" is the card of the local rank
    (``LOCAL_RANK``); CUDA asked for and not there, or a local rank
    without a card, raises: only ``device="cpu"`` runs on the CPU."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} ranks asked for, but this process's group has {world}: "
                         f"start them with `train.main --ngpu {n_devices}`, `sharding.spawn` "
                         "or a launcher")
    if data_axis not in (None, world):
        raise ValueError(f"make_mesh: data_axis {data_axis} with {world} ranks (the port "
                         "shards only the data axis)")
    device = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if not dist.is_initialized() and world > 1:
        dist.init_process_group(backend or _default_backend(device), init_method="env://",
                                rank=rank, world_size=world)
    if dist.is_initialized():
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        group, backend = None, backend or _default_backend(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: the nccl backend needs a CUDA device, not {device}")
    return Mesh(rank, world, backend, device, group)


def rank_device(device, local_rank: int) -> torch.device:
    """The device a rank computes on: ``device`` itself, or card
    ``local_rank`` for a bare "cuda". CUDA asked for raises when it is not
    available or the card is not visible: nothing moves to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: {dev} asked for, but CUDA is not available; pass "
                           "device='cpu' to run on the CPU over gloo")
    index = local_rank if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"make_mesh: local rank {local_rank} needs CUDA device {index}, but "
                         f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", index)


def trainer_group(ngpu: int, device, group: Optional[Mesh]) -> Optional[Mesh]:
    """A trainer's data-parallel group for ``--ngpu``: ``group`` (its world
    size must be ngpu), else for ngpu > 1 the process's initialised group
    or a launcher's (`make_mesh`, which raises when its size differs: no
    fallback to one process), else None (one process)."""
    if group is None:
        return make_mesh(ngpu, device=device) if ngpu > 1 else None
    if group.world != ngpu:
        raise ValueError(f"opts ngpu {ngpu} with a group of {group.world} ranks")
    return group


def _default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str,
               fn: Callable, args: tuple, out_dir: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    try:
        out = fn(make_mesh(world, device=dev), *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device="cuda",
          backend: Optional[str] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` ranks, each a spawned process
    (``torch.multiprocessing``, spawn context), over a ``file://`` store in
    a temporary directory. ``device`` "cuda" puts rank r on card r (nccl by
    default; more ranks than cards raise ValueError); "cuda:0" puts every
    rank on that card, which only gloo allows; "cpu" runs gloo on the CPU.
    A rank that raises makes this raise (the others are stopped). Returns
    the ranks' return values, in rank order (pickled: return CPU data)."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    backend = backend or _default_backend(dev)
    if backend == "nccl" and dev.index is None:
        check_cards(world, dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn: CUDA is not available; pass device='cpu'")
    with tempfile.TemporaryDirectory(prefix="vidu4d_spawn_") as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, f"file://{tmp}/store", backend, str(dev), fn, tuple(args), tmp))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# ----------------------------------------------------------------------
# the share of a batch and the reductions of the step's results
# ----------------------------------------------------------------------


def pair_share(n_pairs: int, mesh: Mesh) -> Share:
    """Equal contiguous shares of whole pairs when ``n_pairs`` divides by
    the world size, else every pair on every rank at weight 1 / world."""
    if n_pairs % mesh.world == 0:
        k = n_pairs // mesh.world
        return Share(mesh, mesh.rank * k, (mesh.rank + 1) * k, 1.0)
    return Share(mesh, 0, n_pairs, 1.0 / mesh.world)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh):
    """This rank's rows of a flattened (2 M, ...) pair batch and its
    `Share` (JAX places the frame axis sharded when it divides and
    replicated otherwise; the port splits whole pairs). Returns (rows,
    share)."""
    n_frames = int(batch["frameid"].shape[0])
    if n_frames % 2:
        raise ValueError(f"shard_batch: {n_frames} frames are not whole pairs")
    share = pair_share(n_frames // 2, mesh)
    lo, hi = 2 * share.lo, 2 * share.hi
    return {k: v[lo:hi] if v.dim() >= 1 and v.shape[0] == n_frames else v
            for k, v in batch.items()}, share


def reduce_metrics(metrics: Dict[str, torch.Tensor], share: Optional[Share]
                   ) -> Dict[str, torch.Tensor]:
    """Every rank's parts of the loss terms summed (one all-reduce): the
    global batch's terms."""
    if share is None:
        return metrics
    keys = sorted(metrics)
    vec = share.mesh.all_reduce_(torch.stack([metrics[k].detach() for k in keys]))
    return dict(zip(keys, vec.unbind(0)))


def all_reduce_grads_(params: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum every rank's gradients of ``params`` in one flat buffer (a
    missing gradient counts as zeros) and write the sums to ``.grad``."""
    if mesh is None or mesh.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = mesh.all_reduce_(_flatten_dense_tensors(grads))
    for p, g in zip(params, _unflatten_dense_tensors(flat, grads)):
        p.grad = g


def broadcast_tensors_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place (one flat
    buffer per dtype)."""
    if mesh is None or mesh.group is None:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:  # bool travels as uint8
        by_dtype.setdefault(torch.uint8 if t.dtype == torch.bool else t.dtype, []).append(t)
    with torch.no_grad():
        for dtype, group in by_dtype.items():
            flat = mesh.broadcast_(_flatten_dense_tensors([t.detach().to(dtype)
                                                           for t in group]))
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)


def checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A float64 fingerprint of ``tensors``: per tensor its sum and a sum
    weighted by position (a permutation changes it)."""
    parts = []
    for t in tensors:
        x = t.detach().reshape(-1).double()
        pos = torch.arange(1, x.numel() + 1, dtype=torch.float64, device=x.device)
        parts += [x.sum(), (x * torch.sin(pos)).sum()]
    return torch.stack(parts)


def checksum_agrees(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> bool:
    """Whether every rank holds bitwise the same ``tensors`` (as far as a
    `checksum` tells: its maximum over the ranks equals its minimum)."""
    if mesh is None or mesh.group is None:
        return True
    c = checksum(tensors)
    hi = mesh.all_reduce_(c.clone(), "max")
    lo = -mesh.all_reduce_(-c, "max")
    return bool(torch.equal(hi, lo))


# ----------------------------------------------------------------------
# the reduced dryrun steps (`sharding.py:67-293`)
# ----------------------------------------------------------------------


def make_synthetic_stage3_inputs(frame_info: FrameInfo, n_frames: int, n_surfels: int,
                                 res: int, capacity: Optional[int] = None, seed: int = 0,
                                 device="cuda"):
    """Synthetic deformer + surfels + pixel batch for dryruns (`sharding.py:67`):
    the batch is the JAX function's (numpy, from ``seed``); the deformer's
    and the surfels' random parameters come from a ``torch.Generator``
    seeded with ``seed`` (the JAX ones from flax's PRNGKey), the intrinsics
    set to focal 1.2 res at the image centre. Returns (deformer, surfels,
    batch of tensors on ``device``)."""
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.deformable import GaussianDeformer

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    capacity = capacity or n_surfels
    gen = torch.Generator(device=device).manual_seed(seed)
    deformer = GaussianDeformer(frame_info, fg_motion="bob", device=device, generator=gen)
    pts = rng.normal(size=(n_surfels, 3)).astype(np.float32) * 0.05
    cols = rng.uniform(size=(n_surfels, 3)).astype(np.float32)
    feats = rng.normal(size=(n_surfels, 16)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    surfels = sf.init_from_points(
        t(pts), t(cols), capacity, sh_degree=3, generator=gen,
        regist_feat=t(feats / np.linalg.norm(feats, axis=-1, keepdims=True)))

    m, hw = n_frames, res * res
    x0, y0 = np.meshgrid(range(res), range(res))
    hxy = np.stack([x0, y0, np.ones_like(x0)], -1).reshape(1, -1, 3)
    batch = {
        "rgb": rng.uniform(size=(m, hw, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(m, hw, 1)) > 0.5).astype(np.float32),
        "vis2d": np.ones((m, hw, 1), np.float32),
        "feature": rng.normal(size=(m, hw, 16)).astype(np.float32),
        "is_detected": np.ones((m,), np.float32),
        "crop2raw": np.tile([1.0, 1.0, 0.0, 0.0], (m, 1)).astype(np.float32),
        "dataid": np.zeros((m,), np.int32),
        "frameid": (np.arange(m) % frame_info.num_frames_raw).astype(np.int32),
        "frameid_sub": (np.arange(m) % frame_info.num_frames_raw).astype(np.int32),
        "hxy": np.tile(hxy, (m, 1, 1)).astype(np.float32),
        # the cloud in front of the camera (field-space z 0.4 > near)
        "field2cam": np.tile(np.array([[1.0, 0, 0, 0, 0, 0, 4.0]], np.float32), (m, 1)),
    }
    with torch.no_grad():
        deformer.intrinsics.base_logfocal.fill_(float(np.log(1.2 * res)))
        deformer.intrinsics.base_ppoint.fill_(res / 2.0)
    return deformer, surfels, {k: t(v) for k, v in batch.items()}


def build_stage3_train_step(deformer, res: int, raster_cfg, mesh: Optional[Mesh] = None,
                            sh_degree: int = 3, gs_lrs=None):
    """The reduced Stage-3 step (`sharding.py:137`): rgb L1, mask L2 and
    cycle loss -> surfel gradients -> surfel Adam, over ``mesh``'s ranks
    (each renders its share of the frames; the means are global, the
    gradients summed). The deformer is frozen, as JAX differentiates only
    the surfels. Returns step(surfels, gs_adam, batch) -> (surfels,
    gs_adam, metrics); the surfel parameters are updated in place."""
    from vidu4d_tpu_torch.models.gaussian import surfels as sf
    from vidu4d_tpu_torch.models.gaussian.deformable import prepare_surfels_batch
    from vidu4d_tpu_torch.models.gaussian.optimizer import GsLearningRates, gs_adam_update
    from vidu4d_tpu_torch.ops import geometry as geom
    from vidu4d_tpu_torch.ops.rasterize.tile_backward import composite_batch

    gs_lrs = gs_lrs or GsLearningRates()
    deformer.requires_grad_(False)  # JAX differentiates the surfels only

    def step(surfels, gs_adam, batch):
        share = None
        if mesh is not None:
            batch, share = shard_batch(batch, mesh)
        sp = surfels.params
        for p in sp:
            p.grad = None
        samples = deformer.get_samples(batch)
        bg = deformer.background()
        xyz_cam, rot_cam, _ = deformer.warp_surfels(sp.xyz, sf.get_rotation(sp), samples)
        intrins = geom.mat2K(geom.Kmatinv(samples["Kinv"]))
        prepared = prepare_surfels_batch(sp, surfels.alive, xyz_cam, rot_cam, intrins, res,
                                         res, sh_degree, bg, raster_cfg)
        out = composite_batch(prepared, res, res)
        m = xyz_cam.shape[0]
        img = lambda x: x.reshape(m, res, res, -1)
        with global_batch.over(share):
            rgb_l1 = global_batch.mean(torch.abs(out.color[..., :3] - img(batch["rgb"]))
                                       * img(batch["vis2d"]))
            mask_l = global_batch.mean((out.alpha[..., None] - img(batch["mask"])) ** 2)
            cyc = deformer.cycle_loss(xyz_cam, sp.xyz, samples)
            cyc_l = global_batch.mean(cyc["cyc_dist"])
        total = 0.1 * rgb_l1 + 0.1 * mask_l + 0.01 * cyc_l
        total.backward()
        with torch.no_grad():
            all_reduce_grads_(list(sp), mesh)
            sgrads = sf.SurfelParams(*[p.grad if p.grad is not None else torch.zeros_like(p)
                                       for p in sp])
            gs_adam = gs_adam_update(sgrads, gs_adam, sp, gs_lrs)
        parts = reduce_metrics({"rgb": rgb_l1, "mask": mask_l, "cyc": cyc_l}, share)
        total = 0.1 * parts["rgb"] + 0.1 * parts["mask"] + 0.01 * parts["cyc"]
        return surfels, gs_adam, {"total": total.detach(), **parts}

    return step


def make_synthetic_stage2_inputs(n_frames: int = 8, n_pixels: int = 12, m: int = 4,
                                 res: int = 32, seed: int = 0, device="cuda"):
    """A tiny DvrModel + pixel-ray batch for Stage-2 dryruns (`sharding.py:218`):
    the batch, the loss options and the weights are the JAX function's;
    the parameters come from a ``torch.Generator`` seeded with ``seed``,
    the intrinsics set to the JAX function's prior. Returns (model, field
    states, batch of tensors on ``device``, config, weights)."""
    from vidu4d_tpu_torch.engine.model import DvrModel
    from vidu4d_tpu_torch.engine.schedules import progress_schedule
    from vidu4d_tpu_torch.models.fields.dyn_nerf import FieldState
    from vidu4d_tpu_torch.models.fields.time_mlp import init_intrinsics_base_params

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    fi = FrameInfo.single_video(n_frames)
    intr = np.tile(np.array([[40.0, 40.0, res / 2, res / 2]], np.float32), (n_frames, 1))
    rt = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    rt[:, 2, 3] = 3.0
    config = {
        "field_type": "fg", "fg_motion": "bob", "train_res": res,
        "mask_wt": 0.1, "rgb_wt": 0.1, "depth_wt": 1e-4, "flow_wt": 0.5,
        "vis_wt": 1e-2, "feature_wt": 1e-2, "feat_reproj_wt": 5e-2,
        "reg_visibility_wt": 1e-4, "reg_eikonal_wt": 1e-3,
        "reg_deform_cyc_wt": 0.01, "reg_delta_skin_wt": 5e-3,
        "reg_skin_entropy_wt": 5e-4, "reg_gauss_skin_wt": 1e-3,
        "reg_cam_prior_wt": 0.1, "reg_skel_prior_wt": 0.1,
        "reg_gauss_mask_wt": 0.01, "reg_soft_deform_wt": 100.0,
        "lambda_normal": 0.05, "lambda_dist": 0.0,
    }
    model = DvrModel(fi, fg_motion="bob", rtmat_prior=rt, train_depth_samples=8,
                     field_depth=2, field_width=32, device=device,
                     generator=torch.Generator(device=device).manual_seed(seed))
    with torch.no_grad():
        init_intrinsics_base_params(model.intrinsics, intr, fi)
    n = n_pixels
    batch = {
        "rgb": rng.uniform(size=(m, n, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(m, n, 1)) > 0.4).astype(np.float32),
        "depth": rng.uniform(1, 3, size=(m, n, 1)).astype(np.float32),
        "flow": rng.normal(size=(m, n, 2)).astype(np.float32),
        "flow_uct": rng.uniform(size=(m, n, 1)).astype(np.float32),
        "vis2d": np.ones((m, n, 1), np.float32),
        "crop2raw": np.tile([1.0, 1.0, 0.0, 0.0], (m, 1)).astype(np.float32),
        "dataid": np.zeros((m,), np.int32),
        "frameid_sub": (np.arange(m) % n_frames).astype(np.int32),
        "frameid": (np.arange(m) % n_frames).astype(np.int32),
        "is_detected": np.ones((m,), np.float32),
        "hxy": np.concatenate([rng.uniform(0, res, (m, n, 2)), np.ones((m, n, 1))],
                              axis=-1).astype(np.float32),
        "feature": rng.normal(size=(m, n, 16)).astype(np.float32),
    }
    states = {"fg": FieldState.initial(fi.num_frames_raw, device=device)}
    weights = progress_schedule(config, 100)
    return model, states, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}, \
        config, weights


def build_stage2_train_step(model, states, config, weights, mesh: Optional[Mesh] = None,
                            lr: float = 1e-3):
    """The Stage-2 dryrun step (`sharding.py:270`): loss -> gradients ->
    plain Adam(lr), data-parallel over ``mesh`` (each rank its share of
    the pairs, global normalisation, gradients summed in one buffer).
    Returns (step, init): init() -> the Adam state; step(opt_state, batch,
    draws) -> (opt_state, total, loss_dict), the model updated in place
    (``draws``: `DvrModel.reg_draws`)."""
    from vidu4d_tpu_torch.engine.optim import adam_step_

    params = list(model.parameters())

    def init():
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def step(opt_state, batch, draws):
        share = None
        if mesh is not None:
            batch, share = shard_batch(batch, mesh)
        model.zero_grad(set_to_none=True)
        with global_batch.over(share):
            loss_dict, _ = model.loss(batch, states, config, weights, draws)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        total.backward()
        all_reduce_grads_(params, mesh)
        count = opt_state["count"] + 1
        adam_step_(params, [p.grad if p.grad is not None else torch.zeros_like(p)
                            for p in params], opt_state["mu"], opt_state["nu"], count, lr)
        loss_dict = reduce_metrics(loss_dict, share)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        return {**opt_state, "count": count}, total.detach(), \
            {k: v.detach() for k, v in loss_dict.items()}

    return step, init
