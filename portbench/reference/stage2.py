"""The plain reference of a Stage-2 training step of Vidu4D's ``bob``
recipe (the neural SDF of lab4d's ``--fg_motion bob`` with
``--rgb_timefree --rgb_dirfree``): its batch of sampled pixels, read from
the database's files; the rays through them; the backward warp of every
sample into the canonical space (`nets`: the camera, the intrinsics and
the 25-bone dual-quaternion skinning with its delta-skin MLP); the VolSDF
field (an 8 x 256 SDF trunk, the Laplace-CDF density, a colour head and a
feature head) and a visibility field; volume rendering; the flow by the
forward warp to the pair's other frame; every loss term and regulariser;
the NaN zeroing, the clip and AdamW on its one-cycle rate. Functions of a
flat ``{name: tensor}`` dict, no module classes; nothing of the program is
imported. The step's draws are inputs: the frame pairs and pixels of the
program's batches and the regularisers' uniform points. The step's
annealed numbers (the PE window ``alpha``, the eikonal, gauss-mask and
camera-prior weights) are worked out here from the step (`schedule`).

As the configured recipe runs it, which departs from the published
description (lab4d's Stage 2) in these points:

- depths: 64 uniform between each frame's near and far, no jitter; each
  sample's length is its depth step times the ray's length;
- rendering: weights normalised by the ray's opacity (+1e-6); the cycle
  distance and the skin entropy integrated under the detached normalised
  weights; the flow under the weights times its validity (in front of the
  paired camera and under ``train_res`` px), renormalised;
- the visibility term: the samples' log-sigmoid weighted by the detached
  transmittance, over its mean over the whole batch;
- the eikonal term at every 16th pixel of each image, at the detached
  canonical samples (its gradient taken with ``create_graph``), averaged
  over each ray's samples;
- the feature match: a softmax over 1,024 canonical samples taken at a
  stride from the whole batch, scaled by exp(logsigma);
- every dense term is the mean over its positive entries (the plain mean
  when none is), the flow and the reprojection in units of ``train_res``;
- the mask balanced between the object's and the background's visible
  pixels; rgb, depth, flow and visibility counted on the object's visible
  pixels; features and reprojection on the object's pixels of detected
  frames; the gauss mask against the detached rendered mask;
- the optimiser: NaN gradients to 0, the global norm clipped to 5, Adam
  (0.9, 0.999, 1e-8) with bias corrections rounded to float32, decay 1e-4
  added to Adam's ratio, x10 for the scalars named in ``EXPLICIT``, the
  one-cycle rate from lr / 25 up over two rounds and down to lr / 25 at
  the end of the schedule.

`initial_state` makes the benchmark's state from the seed (in place of the
prior fits and the SDF pretrain, and of the proxy geometry); `replay`
follows the program's first steps from it and returns what
`portbench.compare` compares (the change over the first update), in
float32 or, as a witness of float32's round-off, in float64.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench import database
from portbench.reference import nets
from portbench.reference import stage3 as ref3

# the recipe's numbers (Vidu4D's Stage-2 defaults) that the step reads
RECIPE = dict(
    depth_samples=64, eikonal_stride=16, match_candidates=1024, n_vis=512, n_gauss=2048,
    mask_wt=0.1, rgb_wt=0.1, depth_wt=1e-4, flow_wt=0.5, vis_wt=1e-2, feature_wt=1e-2,
    feat_reproj_wt=5e-2, reg_visibility_wt=1e-4, reg_eikonal_wt=1e-3,
    reg_deform_cyc_wt=0.01, reg_delta_skin_wt=5e-3, reg_skin_entropy_wt=5e-4,
    reg_gauss_skin_wt=1e-3, reg_cam_prior_wt=0.1, reg_gauss_mask_wt=0.01,
    learning_rate=5e-4, num_rounds=21, iters_per_round=200,
)
WIDTH, DEPTH, SKIP = 256, 8, 4      # the SDF trunk
FREQ_SDF, FREQ_RGB, FREQ_VIS, FREQ_FEAT = 10, 12, 10, 6
FEATURE = 16
EXPLICIT = ref3.EXPLICIT
FIELD = "fields.fg."                # the program's prefix of the field's names


def ramp(step: int, end: int, y0: float, y1: float, log: bool = False) -> float:
    """y0 at step 0 to y1 at ``end``, held at y1 after; linear, or linear
    in log10 y."""
    if log:
        return 10 ** ramp(step, end, math.log10(y0), math.log10(y1))
    return float(min(max(y0 + step * (y1 - y0) / end, min(y0, y1)), max(y0, y1)))


def schedule(step: int) -> Dict[str, float]:
    """The step's annealed numbers (lab4d's progress schedule): the PE
    window opens from 0.6 to 1 over 4,000 steps; the eikonal weight grows
    100-fold over 4,000 steps on a log scale; the gauss-mask weight falls to
    0 over 4,000 steps, the camera prior's (a weight under 1) over 800."""
    R = RECIPE
    return {"alpha": ramp(step, 4000, 0.6, 1.0),
            "reg_eikonal_wt": R["reg_eikonal_wt"] * ramp(step, 4000, 1.0, 100.0, log=True),
            "reg_gauss_mask_wt": R["reg_gauss_mask_wt"] * ramp(step, 4000, 1.0, 0.0),
            "reg_cam_prior_wt": R["reg_cam_prior_wt"] * ramp(step, 800, 1.0, 0.0)}


# --- parameters ----------------------------------------------------------------

def shapes(frames: int) -> Dict[str, tuple]:
    """Every parameter's short name and shape: the deformer's (`nets`,
    without a background colour) and the field's."""
    out = {k: v for k, v in nets.shapes(frames).items() if k != "bg_color"}

    def mlp(name, n_in, depth, width, n_out, skip=SKIP):
        ch = n_in
        for i in range(depth):
            if i == skip:
                ch += n_in
            out[f"{name}.linear_{i + 1}.weight"] = (width, ch)
            out[f"{name}.linear_{i + 1}.bias"] = (width,)
            ch = width
        out[f"{name}.linear_final.weight"] = (n_out, ch)
        out[f"{name}.linear_final.bias"] = (n_out,)

    embed = lambda n: 3 * (2 * n + 1)
    mlp("basefield.mlp", embed(FREQ_SDF), DEPTH, WIDTH, WIDTH)
    mlp("colorfield.mlp", embed(FREQ_RGB), 2, WIDTH, WIDTH)
    mlp("vis_field.mlp", embed(FREQ_VIS), 2, 64, 1)
    mlp("feature_field", embed(FREQ_FEAT), 5, 128, FEATURE)
    for name, n_in, n_out in (("sdf_head", WIDTH, 1), ("rgb_hidden", WIDTH, WIDTH // 2),
                              ("rgb_out", WIDTH // 2, 3)):
        out[f"{name}.weight"] = (n_out, n_in)
        out[f"{name}.bias"] = (n_out,)
    out["logibeta"] = (1,)
    return out


def program_name(short: str) -> str:
    return short if short.startswith("intrinsics.") else FIELD + short


def short_name(name: str) -> str:
    return name[len(FIELD):] if name.startswith(FIELD) else name


@torch.no_grad()
def init(frames: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Parameters drawn from ``gen`` as flax initialises them (weights
    lecun-normal truncated at 2 sigma, biases 0, instance codes N(0, 1)),
    the scalars at their starting values (SDF beta 0.1, scale 0.1, match
    temperature 1, skinning temperature 0.01, bone radius 0.03)."""
    out = {}
    for name, shape in shapes(frames).items():
        if name.endswith(".weight"):
            std = (1.0 / shape[1]) ** 0.5 / 0.87962566103423978
            w = torch.empty(shape, device=device)
            out[name] = torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                                    generator=gen)
        elif name.endswith("inst_embedding.mapping"):
            out[name] = torch.randn(shape, generator=gen, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    out["logibeta"].fill_(-math.log(0.1))
    out["logscale"].fill_(math.log(0.1))
    out["warp.logibeta"].fill_(-math.log(0.01))
    out["warp.skinning_model.log_gauss"].fill_(math.log(nets.INIT_GAUSS))
    return out


# --- the batch -------------------------------------------------------------------

class Pixels(ref3.Database):
    """The database's maps of one video, read at sampled pixels."""

    def __init__(self, root: str, seq: str, res: int, device):
        super().__init__(root, seq, res, device)
        cams = np.load(os.path.join(root, "processed", "Cameras", "Full-Resolution",
                                    f"{seq}-0000", "01-canonical.npy")).astype(np.float32)
        cams[:, :3, 3] *= 0.1           # the recipe's initial scale of the object
        self.camera_prior = torch.as_tensor(cams, device=self.device)
        self._feature = torch.as_tensor(np.asarray(self.feature, np.float32),
                                        device=self.device)

    def rows(self, frame: np.ndarray, towards: np.ndarray, xy: np.ndarray) -> Dict:
        """Frames ``frame`` (R,) at pixels ``xy`` (R, N, 2) integer (x, y),
        each with its flow towards ``towards`` (R,)."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        f, x, y = frame[:, None], xy[..., 0], xy[..., 1]
        flow = np.zeros(xy.shape[:2] + (3,), np.float32)
        for r, (i, j) in enumerate(zip(frame, towards)):
            d = int(j) - int(i)
            if d > 0 and ("FW", d) in self.flow:
                flow[r] = self.flow["FW", d][i // d][y[r], x[r]]
            elif d < 0 and ("BW", -d) in self.flow:
                flow[r] = self.flow["BW", -d][i // -d - 1][y[r], x[r]]
        # features: bilinear on the coarse grid at pixel (x, y) * grid / res, in float64
        g = self._feature.shape[1]
        px = torch.as_tensor(xy, device=self.device).double()
        u = torch.clamp(px[..., 0] / self.res * g, 0, g - 1.000001)
        v = torch.clamp(px[..., 1] / self.res * g, 0, g - 1.000001)
        u0, v0 = u.floor().long(), v.floor().long()
        wu, wv = (u - u0)[..., None], (v - v0)[..., None]
        fi = torch.as_tensor(frame, device=self.device).long()[:, None]
        at = lambda vv, uu: self._feature[fi, vv, uu].double()
        feat = (at(v0, u0) * (1 - wu) * (1 - wv) + at(v0, u0 + 1) * wu * (1 - wv)
                + at(v0 + 1, u0) * (1 - wu) * wv + at(v0 + 1, u0 + 1) * wu * wv)
        mask = self.mask[f, y, x]
        hxy = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
        return {"rgb": t(self.rgb[f, y, x]), "mask": t(mask[..., :1]),
                "vis2d": t(mask[..., 1:]), "depth": t(self.depth[f, y, x][..., None]),
                "flow": t(flow[..., :2]), "flow_uct": t(flow[..., 2:]),
                "feature": feat.float(), "crop2raw": t(self.crop2raw[frame]),
                "is_detected": t(self.detected[frame]), "hxy": t(hxy),
                "frameid": torch.as_tensor(frame, device=self.device).long()}

    def batch(self, frame: np.ndarray, xy: np.ndarray) -> Dict:
        """Rows 2k, 2k + 1 the pair (a, b): a with its flow towards b, b
        towards a."""
        towards = frame.reshape(-1, 2)[:, ::-1].reshape(-1)
        return self.rows(frame, towards, xy)


def read_batch(db: Pixels, prog_batch: Dict):
    """The program's batch's frames and pixels read here, and the largest
    difference from the program's values (infinite where a pair is not one
    the loader can draw or a pixel is not one of the image's)."""
    frame = prog_batch["frameid"].reshape(-1).cpu().numpy().astype(np.int64)
    hxy = prog_batch["hxy"].cpu().double().numpy()
    xy = np.rint(hxy[..., :2]).astype(np.int64)
    ok = (np.all(xy == hxy[..., :2]) and np.all(hxy[..., 2] == 1.0) and xy.min() >= 0
          and xy.max() < db.res and frame.shape[0] % 2 == 0
          and all(db.pair_ok(int(a), int(b)) for a, b in frame.reshape(-1, 2)))
    xy = np.clip(xy, 0, db.res - 1)
    frame = np.clip(frame, 0, db.frames - 1)
    ref = db.batch(frame, xy)
    return ref, (ref3.batch_gap(prog_batch, ref) if ok else math.inf)


# --- the field -------------------------------------------------------------------

def linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def embed(x: torch.Tensor, bands: int, alpha: Optional[float] = None) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] per band of all three
    coordinates; ``alpha`` opens band j by 0.5 (1 - cos(pi clip(alpha bands
    - j, 0, 1)))."""
    xf = x[..., None, :] * (2.0 ** torch.arange(bands, dtype=x.dtype, device=x.device))[:, None]
    s, c = torch.sin(xf), torch.cos(xf)
    if alpha is not None:
        j = torch.arange(bands, dtype=x.dtype, device=x.device)
        w = torch.clamp(alpha * bands - j, 0.0, 1.0)
        w = (0.5 * (1.0 + torch.cos(math.pi * w + math.pi)))[:, None]
        s, c = s * w, c * w
    return torch.cat([x, torch.stack([s, c], -2).flatten(-3)], -1)


def mlp(P, name, x, depth, final_relu=False):
    h = x
    for i in range(depth):
        if i == SKIP:
            h = torch.cat([x, h], -1)
        h = torch.relu(linear(P, f"{name}.linear_{i + 1}", h))
    h = linear(P, f"{name}.linear_final", h)
    return torch.relu(h) if final_relu else h


def sdf(P, x, alpha):
    """Signed distance (..., 1) and the trunk's feature (..., 256)."""
    h = mlp(P, "basefield.mlp", embed(x, FREQ_SDF, alpha), DEPTH, final_relu=True)
    return linear(P, "sdf_head", h), h


def density(P, s):
    """VolSDF: beta^-1 times the Laplace CDF of -sdf at scale beta."""
    ib = torch.exp(P["logibeta"])
    e = 0.5 * torch.exp(-torch.abs(s) * ib)
    return ib * torch.where(s > 0, e, 1.0 - e)


def colour(P, x, h):
    """Colour from the trunk's feature and the colour MLP (no view
    direction, no appearance code)."""
    h = h + mlp(P, "colorfield.mlp", embed(x, FREQ_RGB), 2, final_relu=True)
    return torch.sigmoid(linear(P, "rgb_out", torch.relu(linear(P, "rgb_hidden", h))))


def visibility(P, x):
    return mlp(P, "vis_field.mlp", embed(x, FREQ_VIS), 2)


def features(P, x):
    return nets.normalize(mlp(P, "feature_field", embed(x, FREQ_FEAT), 5))


def bone_centres(rest):
    """Bone centres (1, B, 3) of the rest pose."""
    return nets.qt_from_dq(rest[0][:1], rest[1][:1])[1]


def gauss(x, centres):
    """The bones' proxy density (..., 1): the largest Gaussian of radius
    0.01 about a bone centre."""
    d2 = torch.sum((x[..., None, :] - centres.reshape(-1, 3)) ** 2, -1) / 0.01 ** 2
    return torch.amax(torch.exp(-0.5 * d2), -1, keepdim=True)


# --- the step ----------------------------------------------------------------------

nonzero_mean, norm = ref3.nonzero_mean, ref3.norm


def kinv(P, frame, crop2raw, frames):
    """(M, 3, 3) pixel -> camera-ray map: the inverse intrinsics after the
    crop's map to the raw image."""
    K = nets.intrinsics(P, frame, frames)
    o, z = torch.ones_like(K[:, 0]), torch.zeros_like(K[:, 0])
    k_inv = torch.stack([1 / K[:, 0], z, -K[:, 2] / K[:, 0], z, 1 / K[:, 1], -K[:, 3] / K[:, 1],
                         z, z, o], -1).reshape(-1, 3, 3)
    c = crop2raw
    crop = torch.stack([c[:, 0], z, c[:, 2], z, c[:, 1], c[:, 3], z, z, o], -1).reshape(-1, 3, 3)
    return k_inv @ crop


def project(ki, x):
    """Pixel (x, y) of camera points x (M, ..., 3) under the inverse map
    ``ki`` (M, 3, 3); |z| held at 1e-3 or more, its sign kept."""
    a, b, c, d = ki[:, 0, 0], ki[:, 0, 2], ki[:, 1, 1], ki[:, 1, 2]
    shape = (-1,) + (1,) * (x.dim() - 2)
    a, b, c, d = (v.reshape(shape) for v in (a, b, c, d))
    z = x[..., 2]
    z = torch.where(z.abs() < 1e-3, torch.where(z < 0, -1e-3, 1e-3).to(z.dtype), z)
    return torch.stack([(x[..., 0] - b * x[..., 2]) / a / z,
                        (x[..., 1] - d * x[..., 2]) / c / z], -1)


def swap(v):
    """Each pair's two rows swapped."""
    return v.reshape((v.shape[0] // 2, 2) + v.shape[1:]).flip(1).reshape(v.shape)


def weights_of(sigma, deltas):
    """Volume-rendering weights and transmittance after each sample, (M,
    N, D) of densities and lengths (M, N, D)."""
    tau = sigma * deltas
    trans = torch.exp(-torch.cumsum(tau, -1))
    before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return (1.0 - torch.exp(-tau)) * before, trans


def loss(P, field: Dict, batch: Dict, step: int, draws: Dict, frames: int, res: int,
         fault: Optional[str] = None):
    """Step ``step``'s total loss and its weighted terms."""
    R = RECIPE
    sched = schedule(step)
    alpha = sched["alpha"]
    wt = lambda k: sched.get(k + "_wt", R[k + "_wt"])
    frame, hxy = batch["frameid"], batch["hxy"]
    m, n = hxy.shape[:2]
    ki = kinv(P, frame, batch["crop2raw"], frames)
    cam = nets.camera(P, frame, frames)                  # canonical -> camera
    art = nets.bones(P, frame, frames)
    rest = nets.bones(P, frame, frames, mean=True)
    rest = (rest[0].expand_as(art[0]), rest[1].expand_as(art[1]))

    # rays and their samples
    d = torch.einsum("mij,mnj->mni", ki, hxy)
    d_len = norm(d)
    D = R["depth_samples"]
    z = torch.arange(D, device=d.device, dtype=d.dtype) * (1.0 / (D - 1))
    z[-1] = 1.0
    nf = field["near_far"][frame]
    depth = nf[:, :1] * (1 - z) + nf[:, 1:] * z          # (M, D)
    x_cam = d[:, :, None] * depth[:, None, :, None]       # (M, N, D, 3)
    step = torch.cat([depth[:, 1:] - depth[:, :-1], depth[:, -1:] - depth[:, -2:-1]], -1)
    deltas = step[:, None, :] * d_len                     # (M, N, D)

    # the backward warp: camera -> the frame's object space -> canonical
    qi = nets.qconj(cam[0])[:, None, None]
    x_t = nets.qrot(qi, x_cam - cam[1][:, None, None])
    flat = lambda v: v.reshape(m, n * D, v.shape[-1])
    qt_b, logit_b, delta_b = nets.warp(P, flat(x_t), art, rest, frame, frames, backward=True)
    x = nets.apply(qt_b, flat(x_t)).reshape(m, n, D, 3)

    # the field at the canonical samples
    vis = visibility(P, x)
    s, h = sdf(P, x, alpha)
    sigma = density(P, s)[..., 0]
    rgb = colour(P, x, h)
    feat = features(P, x)

    # flow: the samples forward-warped into the pair's other frame
    other = (swap(art[0]), swap(art[1]))
    qt_f, _, _ = nets.warp(P, flat(x), other, rest, swap(frame), frames)
    cam_o = (swap(cam[0]), swap(cam[1]))
    x_o = nets.qrot(cam_o[0][:, None], nets.apply(qt_f, flat(x))) + cam_o[1][:, None]
    x_o = x_o.reshape(m, n, D, 3)
    flow = project(swap(ki), x_o) - hxy[:, :, None, :2]
    valid = (x_o[..., 2] > 1e-6) & (norm(flow, keepdim=False) < float(res))

    # the cycle: the canonical samples forward-warped back into the frame
    qt_c, logit_c, delta_c = nets.warp(P, flat(x), art, rest, frame, frames)
    cyc = norm(nets.apply(qt_c, flat(x)) - flat(x_t)).reshape(m, n, D, 1)

    def entropy(logit):
        return -torch.gather(torch.log_softmax(logit, -1), -1, logit.argmax(-1, keepdim=True))

    ent = ((entropy(logit_c) + entropy(logit_b)) / 2).reshape(m, n, D, 1)
    dskin = ((torch.mean(delta_c ** 2, -1) + torch.mean(delta_b ** 2, -1)) / 2).reshape(m, n, D)

    # the eikonal term at every stride-th pixel's samples
    stride = R["eikonal_stride"]
    with torch.enable_grad():
        pts = x[:, ::stride].detach().requires_grad_(True)
        g = torch.autograd.grad(sdf(P, pts, alpha)[0].sum(), pts, create_graph=True)[0]
    eik = torch.zeros((m, n, D), device=x.device, dtype=x.dtype)
    eik[:, ::stride] = (norm(g, keepdim=False) - 1.0) ** 2

    # the feature match and its reprojection into the frame
    total_s = m * n * D
    k = min(R["match_candidates"], total_s)
    cs = max(1, total_s // k)
    cand_f, cand_x = feat.reshape(-1, FEATURE)[::cs][:k], x.reshape(-1, 3)[::cs][:k]
    prob = torch.softmax(batch["feature"].reshape(-1, FEATURE) @ cand_f.T
                         * torch.exp(P["logsigma"]), -1)
    match = (prob @ cand_x).reshape(m, n, 3)
    qt_m, _, _ = nets.warp(P, match, art, rest, frame, frames)
    xy_m = project(ki, nets.qrot(cam[0][:, None], nets.apply(qt_m, match)) + cam[1][:, None])

    # volume rendering
    w, trans = weights_of(sigma, deltas)
    mask = torch.sum(w, -1, keepdim=True)
    wn = w / (mask + 1e-6)
    along = lambda v, ww: torch.sum(ww[..., None] * v, -2)
    rgb_r = along(rgb, wn)
    if fault == "altered":
        rgb_r = rgb_r * 1.01
    depth_r = along(depth[:, None, :, None].expand(m, n, D, 1) / torch.exp(P["logscale"]), wn)
    feat_r = along(feat, wn)
    wf = w * valid
    wf = wf / (torch.sum(wf, -1, keepdim=True) + 1e-6)
    flow_r = along(flow, wf)
    cyc_r = along(cyc, wn.detach())
    ent_r = along(ent, wn.detach())
    td = trans.detach()
    vis_r = -torch.mean(F.logsigmoid(vis[..., 0]) * td, -1, keepdim=True) / torch.mean(td)
    gauss_w, _ = weights_of(gauss(x, bone_centres(rest))[..., 0] * torch.exp(P["warp.logibeta"]),
                            deltas)
    gauss_mask = torch.sum(gauss_w, -1, keepdim=True)

    # the dense terms, masked
    gt, vis2d = batch["mask"], batch["vis2d"]
    det = batch["is_detected"].reshape(-1, 1, 1)
    vd = vis2d * det
    pos, neg = torch.sum(gt * (vd > 0)), torch.sum((1 - gt) * (vd > 0))
    tot = torch.sum(vd)
    bal = 0.5 * tot / torch.clamp(pos, min=1e-6) * gt + 0.5 * tot / torch.clamp(neg, min=1e-6) \
        * (1 - gt)
    bal = torch.where((torch.sum(gt) > 0) & (torch.sum(1 - gt) > 0), bal, torch.ones_like(bal))
    fg = gt * vis2d
    dense = {
        "mask": (mask - gt) ** 2 * bal * vis2d * det,
        "feature": norm(feat_r - batch["feature"]) * gt * det,
        "feat_reproj": norm(xy_m - hxy[..., :2]) * gt * det / res,
        "rgb": (rgb_r - batch["rgb"]) ** 2 * fg,
        "depth": norm(depth_r - batch["depth"]) * fg,
        "flow": norm(flow_r - batch["flow"]) * (batch["flow_uct"] > 0) * fg / res,
        "vis": vis_r * fg,
        "reg_gauss_mask": (gauss_mask - mask.detach()) ** 2,
        "reg_eikonal": torch.mean(eik, -1),
        "reg_deform_cyc": cyc_r,
        "reg_delta_skin": torch.mean(dskin, -1),
        "reg_skin_entropy": ent_r,
    }
    terms = {k: nonzero_mean(v) * wt(k) for k, v in dense.items()}

    # the regularisers at points drawn in the field's box
    lo, hi = field["aabb"][0], field["aabb"][1]
    box = lambda u, f: lo - (hi - lo) * f + u * (hi - lo) * (1 + 2 * f)
    terms["reg_visibility"] = -torch.mean(F.logsigmoid(-visibility(P, box(draws["vis"], 1.0)))) \
        * wt("reg_visibility")
    pg = box(draws["gauss"], 0.25)
    dg = gauss(pg, bone_centres(rest))
    occ = (density(P, sdf(P, pg, alpha)[0]) / torch.exp(P["logibeta"])).detach()
    bw = (occ * 0.5 / (1e-6 + torch.mean(occ)) + (1 - occ) * 0.5 / (1e-6 + torch.mean(1 - occ)))
    dg = torch.clamp(dg, 1e-7, 1 - 1e-7)
    bce = -(occ * torch.log(dg) + (1 - occ) * torch.log(1 - dg))
    terms["reg_gauss_skin"] = torch.mean(bce * bw.detach()) * wt("reg_gauss_skin")
    every = torch.arange(frames, device=x.device)
    q_all, t_all = nets.camera(P, every, frames)
    pred = torch.cat([torch.cat([nets.qmat(q_all), t_all[..., None]], -1),
                      field["camera_prior"][:, 3:]], -2)
    prior = field["camera_prior"]
    prior = torch.cat([torch.cat([prior[:, :3, :3], prior[:, :3, 3:] * torch.exp(P["logscale"])],
                                 -1), prior[:, 3:]], -2)
    terms["reg_cam_prior"] = torch.mean((pred - prior) ** 2) * wt("reg_cam_prior")
    total = sum(terms[k] for k in sorted(terms))
    return total, terms


# --- the optimiser -------------------------------------------------------------------

def rate(count: int) -> float:
    """One-cycle: up from lr / 25 over the first two rounds, down to lr / 25
    at the end of the schedule."""
    R = RECIPE
    lr, total = R["learning_rate"], R["num_rounds"] * R["iters_per_round"]
    warm = max(int(total * 2.0 / max(R["num_rounds"], 2)), 1)
    if count < warm:
        return lr / 25 + (lr - lr / 25) * count / warm
    return lr + (lr / 25 - lr) * min((count - warm) / max(total - warm, 1), 1.0)


@torch.no_grad()
def adamw(P, grads, mu, nu, count: int) -> None:
    """AdamW (0.9, 0.999, eps 1e-8, decay 1e-4) at the one-cycle rate of
    update ``count`` (from 0), x10 for the explicit scalars, in place; the
    bias corrections rounded to float32."""
    lr = rate(count)
    c1 = float(np.float32(1.0) - np.float32(0.9) ** (count + 1))
    c2 = float(np.float32(1.0) - np.float32(0.999) ** (count + 1))
    for k in P:
        mult = 10.0 if any(part in EXPLICIT for part in k.split(".")) else 1.0
        g = grads[k]
        mu[k] = 0.9 * mu[k] + 0.1 * g
        nu[k] = 0.999 * nu[k] + 0.001 * (g * g)
        P[k] = P[k] - ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) + 1e-4 * P[k]) \
            * (mult * lr)


def grads_at(P, field, batch, step, draws, frames, res, fault=None):
    """The loss and every parameter's gradient as AdamW takes them (NaN to
    0, the global norm clipped to 5)."""
    P = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    with torch.enable_grad():
        total, _ = loss(P, field, batch, step, draws, frames, res, fault)
        gs = torch.autograd.grad(total, list(P.values()), allow_unused=True)
    gs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(P.items(), gs)}
    return total.detach(), ref3.warp_grads(gs)


# --- the initial state and the steps ---------------------------------------------------

def field_state(frames: int, device) -> Dict[str, torch.Tensor]:
    """The field's box and each frame's near / far from the database's
    object: its bounds in the canonical space, and its depth +- 1.5 times its
    largest semi-axis."""
    axes = torch.tensor(database.AXES, device=device)
    r = 1.5 * max(database.AXES)
    nf = torch.tensor([[database.OBJECT_DEPTH - r, database.OBJECT_DEPTH + r]],
                      device=device).repeat(frames, 1)
    return {"aabb": torch.stack([-axes, axes]), "near_far": nf}


def initial_state(frames: int, res: int, seed: int, db: Pixels, pairs: int, pixels: int,
                  step: int) -> Dict:
    """The benchmark's state, on the host: {"params": {program name:
    tensor}, "field": {"aabb", "near_far"}, "moments": {"mu" | "nu": {name:
    tensor}}}. The parameters from the seed (`init`), the intrinsics at the
    database's camera, the camera at the object (identity rotation, the
    object at its depth); moments as a run that has trained a while holds
    them: first 0, second each leaf's mean squared gradient at this state
    on a batch of ``pairs`` pairs of consecutive frames x ``pixels`` pixels
    drawn from the seed (at step ``step``)."""
    dev = db.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = init(frames, gen, dev)
    prior = torch.as_tensor(database.intrinsics_prior(res, frames)[0], device=dev)
    P["intrinsics.base_logfocal"][0] = torch.log(prior[:2])
    P["intrinsics.base_ppoint"][0] = prior[2:]
    for head, bias in (("trans_head", (0.0, 0.0, database.OBJECT_DEPTH)),
                       ("quat_head", (1.0, 0.0, 0.0, 0.0))):
        P[f"camera_mlp.{head}.out.weight"].zero_()
        P[f"camera_mlp.{head}.out.bias"].copy_(torch.tensor(bias))
    P["camera_mlp.base_quat"][0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    box = field_state(frames, dev)
    field = {**box, "camera_prior": db.camera_prior}
    a = torch.randint(0, frames - 1, (pairs,), generator=gen, device=dev)
    frame = torch.stack([a, a + 1], -1).reshape(-1).cpu().numpy()
    xy = torch.randint(0, res, (2 * pairs, pixels, 2), generator=gen, device=dev).cpu().numpy()
    draws = {"vis": torch.rand((RECIPE["n_vis"], 3), generator=gen, device=dev),
             "gauss": torch.rand((RECIPE["n_gauss"], 3), generator=gen, device=dev)}
    _, g = grads_at(P, field, db.batch(frame, xy), step, draws, frames, res)
    host = lambda t: t.detach().to("cpu", copy=True)
    second = lambda v: torch.full_like(v, float(torch.mean(v.double() ** 2)))
    return {"params": {program_name(k): host(v) for k, v in P.items()},
            "field": {k: host(v) for k, v in box.items()},
            "moments": {"mu": {program_name(k): host(torch.zeros_like(v)) for k, v in g.items()},
                        "nu": {program_name(k): host(second(v)) for k, v in g.items()}}}


def replay(db: Pixels, state: Dict, batches: List[Dict], draws: List[Dict], frames: int,
           res: int, start: int, count: int, steps: int, fault: Optional[str] = None,
           first_step=None, dtype: torch.dtype = torch.float32) -> Dict:
    """``steps`` steps from ``state`` at step ``start``, with AdamW at
    ``count`` updates, on the batches ``batches`` (read here) and the
    regularisers' ``draws``: every step's loss, the first step's gradients
    as AdamW takes them, each leaf's change over the first update
    (``change``; program names; the later steps' changes carry the warp's
    discontinuities, see `portbench.drivers.stage2`) and over all the steps
    (``change_all``). ``fault`` ("half_batch": the batch's second half
    replaced by its first; "altered": the rendered colour 1% brighter)
    breaks the step underneath; ``first_step`` is a context the first step
    runs in; ``dtype`` the precision of the state, the batches and the
    arithmetic."""
    dev = db.device
    cast = lambda v: v.to(dev, dtype) if v.is_floating_point() else v.to(dev)
    P = {short_name(k): cast(v) for k, v in state["params"].items()}
    mu = {short_name(k): cast(v) for k, v in state["moments"]["mu"].items()}
    nu = {short_name(k): cast(v) for k, v in state["moments"]["nu"].items()}
    field = {**{k: cast(v) for k, v in state["field"].items()},
             "camera_prior": cast(db.camera_prior)}
    before = {k: v.clone() for k, v in P.items()}
    changed = lambda: {program_name(k): float(torch.linalg.vector_norm((v - before[k]).double()))
                       for k, v in P.items()}
    losses, grad = [], {}
    for i in range(steps):
        batch = {k: cast(v) for k, v in batches[i].items()}
        if fault == "half_batch":
            h = batch["frameid"].shape[0] // 2
            batch = {k: torch.cat([v[:h], v[:h], v[2 * h:]]) for k, v in batch.items()}
        dr = {k: cast(v) for k, v in draws[i].items()}
        with first_step if first_step is not None and i == 0 else contextlib.nullcontext():
            total, g = grads_at(P, field, batch, start + i, dr, frames, res, fault)
        if i == 0:
            grad = {program_name(k): float(torch.linalg.vector_norm(v.double()))
                    for k, v in g.items()}
        losses.append(float(total))
        adamw(P, g, mu, nu, count + i)
        if i == 0:
            change = changed()
    return {"loss": losses, "grad": grad, "change": change, "change_all": changed(),
            "densify": {}}
