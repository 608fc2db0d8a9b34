"""Static-scene 2DGS trainer (`vidu4d_tpu/engine/gs_trainer.py`, the
reference's `gs/train.py`).

`train_step` renders one camera through the tile kernels, takes
(1 - lambda) L1 + lambda DSSIM, updates the surfel store with the per-field
Adam and accumulates the densification statistics; `train` is the host loop
that fires densify / prune / opacity reset at the reference cadence
(`gs/train.py:31-132`). The store's leaves and the Adam moments are updated
in place (`gs_adam_update`), so the statistics read the projection of the
step's forward, taken before the update, as JAX's functional step does.

The loop's random draws (the camera of each step, the split noise of each
densify) come from one ``torch.Generator`` through `LoopDraws`.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vidu4d_tpu_torch.models.gaussian import densify as densify_mod
from vidu4d_tpu_torch.models.gaussian import surfels as sf
from vidu4d_tpu_torch.models.gaussian.optimizer import (
    GsAdamState,
    GsLearningRates,
    gs_adam_init,
    gs_adam_update,
)
from vidu4d_tpu_torch.ops.image_losses import dssim_l1_loss, psnr
from vidu4d_tpu_torch.ops.rasterize.api import (
    UNCAPPED,
    RasterizeConfig,
    rasterize,
    rasterize_with_projection,
)
from vidu4d_tpu_torch.ops.rasterize.common import compute_tile_rects
from vidu4d_tpu_torch.ops.rasterize.tile_forward import TILE


class Camera(NamedTuple):
    viewmat: torch.Tensor  # (4, 4) world-to-camera
    intrins: torch.Tensor  # (4,) fx, fy, cx, cy
    image: torch.Tensor  # (H, W, 3) ground truth in [0, 1]


class GsTrainConfig(NamedTuple):
    """Reference defaults: `gs/arguments/__init__.py` OptimizationParams.
    ``raster`` has no entry cap, as JAX's `RasterizeConfig()`."""

    iterations: int = 30_000
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    sh_increase_interval: int = 1000
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    size_threshold: float = 20.0
    white_background: bool = False
    raster: RasterizeConfig = UNCAPPED
    lrs: GsLearningRates = GsLearningRates()


def bg_color(config: GsTrainConfig, device) -> torch.Tensor:
    return torch.full((3,), 1.0 if config.white_background else 0.0, device=device)


def train_step(state: sf.SurfelState, adam: GsAdamState, viewmat: torch.Tensor,
               intrins: torch.Tensor, gt_image: torch.Tensor, height: int, width: int,
               active_sh_degree: int, config: GsTrainConfig):
    """One optimisation step (`gs_trainer.py:63`). Updates the store's
    leaves and the Adam moments in place; leaves the step's gradients in
    the leaves' ``.grad``. Returns (state with the new statistics, adam,
    metrics dict of 0-d tensors: loss, psnr, alive)."""
    p = state.params
    for leaf in p:
        leaf.grad = None
    dummy = torch.zeros((state.capacity, 2), device=p.xyz.device, requires_grad=True)
    out, proj = rasterize_with_projection(
        p.xyz, sf.get_rotation(p), sf.get_scaling(p), sf.get_opacity(p)[:, 0],
        viewmat, intrins, height, width, shs=sf.get_features(p),
        sh_degree=active_sh_degree, bg_color=bg_color(config, p.xyz.device),
        mask=state.alive, densify_dummy=dummy, config=config.raster,
    )
    loss = dssim_l1_loss(out.color.permute(2, 0, 1), gt_image.permute(2, 0, 1),
                         config.lambda_dssim)
    loss.backward()
    with torch.no_grad():
        grads = sf.SurfelParams(*[leaf.grad if leaf.grad is not None
                                  else torch.zeros_like(leaf) for leaf in p])
        # densification statistics from the forward's projection of the
        # pre-update params: the reference's NDC-scaled mean2D gradient
        # (backward.cu:647-649), dL/dT[u,z] z W, dL/dT[v,z] z H
        rects = compute_tile_rects(proj, height, width, TILE, config.raster.span_cap)
        vs_grad = dummy.grad * proj.depth[:, None].detach() * torch.tensor(
            [[float(width), float(height)]], device=dummy.device)
        new_state = sf.add_densification_stats(state, vs_grad, rects.valid,
                                               proj.radius.detach())
        metrics = {"loss": loss.detach(), "psnr": psnr(out.color, gt_image),
                   "alive": state.num_alive()}
        adam = gs_adam_update(grads, adam, p, config.lrs)
    return new_state, adam, metrics


def densify_step(state: sf.SurfelState, adam: GsAdamState, noise: torch.Tensor,
                 extent: float, max_screen_size: float, config: GsTrainConfig):
    """Densify + prune with the config's thresholds (`gs_trainer.py:138`);
    ``noise`` (N, 2, 2) standard normal split offsets."""
    dcfg = densify_mod.DensifyConfig(
        grad_threshold=config.densify_grad_threshold,
        min_opacity=config.min_opacity,
        percent_dense=config.percent_dense,
    )
    return densify_mod.densify_and_prune(state, adam, noise, extent,
                                         max_screen_size=max_screen_size, config=dcfg)


@torch.no_grad()
def render_viewer_frame(state: sf.SurfelState, cam, active_sh: int,
                        config: GsTrainConfig) -> np.ndarray:
    """Render one live-viewer request (`gs/train.py:58-60`): ``cam`` is a
    `utils.network_gui.ViewerCamera`; its scaling_modifier scales the surfel
    extents. Returns (H, W, 3) numpy."""
    p = state.params
    dev = p.xyz.device
    scaling = p.scaling
    if cam.scaling_modifier != 1.0:
        scaling = scaling + float(np.log(np.float32(cam.scaling_modifier)))
    out = rasterize(
        p.xyz, sf.get_rotation(p), torch.exp(scaling), sf.get_opacity(p)[:, 0],
        torch.as_tensor(np.asarray(cam.viewmat, np.float32), device=dev),
        torch.as_tensor(np.asarray(cam.intrins, np.float32), device=dev),
        cam.height, cam.width, shs=sf.get_features(p), sh_degree=active_sh,
        bg_color=bg_color(config, dev), mask=state.alive, config=config.raster,
    )
    return out.color.cpu().numpy()


class LoopDraws:
    """The random draws of `train`, from one CPU ``torch.Generator``: the
    camera of iteration ``it`` and the split noise of the densify at ``it``
    (drawn on the CPU, then moved to the store's device). JAX draws them
    from ``jax.random.split`` keys; the streams differ."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def camera_index(self, it: int, n_cameras: int) -> int:
        return int(torch.randint(n_cameras, (), generator=self.generator))

    def split_noise(self, it: int, shape, device) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator).to(device)


def train(state: sf.SurfelState, cameras: Sequence[Camera], config: GsTrainConfig,
          scene_extent: float, generator: Optional[torch.Generator] = None,
          log_every: int = 0, viewer=None):
    """Host training loop: camera sampling and the densification cadence
    (`gs_trainer.py:184`). ``viewer`` is an optional
    `utils.network_gui.ViewerServer`, polled once per iteration. Returns
    (state, adam, history list of metric dicts)."""
    draws = LoopDraws(generator if generator is not None
                      else torch.Generator().manual_seed(0))
    adam = gs_adam_init(state.params)
    history = []
    active_sh = 0
    t0 = time.time()

    for it in range(1, config.iterations + 1):
        if viewer is not None:
            viewer.poll(lambda cam: render_viewer_frame(state, cam, active_sh, config),
                        training_done=it == config.iterations)
        if it % config.sh_increase_interval == 0 and active_sh < config.sh_degree:
            active_sh += 1
        cam = cameras[draws.camera_index(it, len(cameras))]
        h, w = cam.image.shape[:2]
        state, adam, metrics = train_step(state, adam, cam.viewmat, cam.intrins, cam.image,
                                          h, w, active_sh, config)

        if it < config.densify_until_iter:
            if it > config.densify_from_iter and it % config.densification_interval == 0:
                size_thr = config.size_threshold if it > config.opacity_reset_interval else 0.0
                noise = draws.split_noise(it, (state.capacity, 2, 2), state.alive.device)
                state, adam, _ = densify_step(state, adam, noise, scene_extent, size_thr,
                                              config)
            if it % config.opacity_reset_interval == 0 or (
                    config.white_background and it == config.densify_from_iter):
                state, adam = densify_mod.reset_opacity(state, adam)

        if log_every and it % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(iter=it, elapsed=time.time() - t0)
            history.append(m)

    return state, adam, history
