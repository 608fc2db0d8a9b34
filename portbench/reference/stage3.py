"""The plain reference of a Stage-3 training step of Vidu4D's ``gs-bob``
recipe: its batch, read from the database's files; the deformer's warp
(`nets`); colour, projection and a dense depth-sorted composite
(`render`); the loss terms; the surfels' Adam and the deformer's AdamW;
and the densify that fires after a step. Nothing of the program is
imported: it reads the configuration's numbers (``RECIPE``), the
database and the benchmark's initial state.

`replay` follows the program's first steps from the same state and the
same frame pairs and returns what `portbench.compare` compares.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import nets, render

# the recipe's numbers (Vidu4D's Stage-3 defaults) that the step reads
RECIPE = dict(
    raster_span_cap=4, raster_entry_cap=2 ** 19,
    rgb_wt=0.1, mask_wt=0.1, depth_wt=1e-4, flow_wt=0.5, flow_noise_px=2.5,
    feat_reproj_wt=0.05, feat_reproj_px=8192, reg_deform_cyc_wt=0.01, cycle_subsample=4,
    reg_delta_skin_wt=5e-3, reg_skin_entropy_wt=5e-4, lambda_normal=0.05, normal_from=8000,
    match_candidates=2048,
    position_lr_init=5e-5, position_lr_final=1.6e-6, position_lr_max_steps=30000,
    feature_lr=2.5e-3, opacity_lr=0.05, scaling_lr=5e-3, rotation_lr=1e-3,
    regist_feat_lr=2.5e-3, learning_rate=5e-4, num_rounds=61, iters_per_round=200,
    densification_interval=100, densify_from_iter=500, densify_until_iter=15000,
    densify_grad_threshold=2e-4, min_opacity=0.005, percent_dense=0.01, cameras_extent=1.0,
    opacity_reset_interval=3000, outlier_filtering_interval=2000, outlier_stop_iter=29000,
)
SURFEL_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
                 "regist_feat")
EXPLICIT = ("logibeta", "logsigma", "logscale", "log_gauss", "base_quat", "base_logfocal",
            "base_ppoint", "trans_scaling", "bg_color")
FLOW_DELTAS = (1, 2, 4, 8)


# --- the batch -----------------------------------------------------------------

class Database:
    """The database's maps of one video, read from its files at ``res``."""

    def __init__(self, root: str, seq: str, res: int, device):
        base = os.path.join(root, "processed")
        load = lambda sub, name: np.load(os.path.join(base, sub, "Full-Resolution",
                                                      f"{seq}-0000", name))
        pre = f"crop-{res}"
        self.res, self.device = res, torch.device(device)
        self.rgb = load("JPEGImages", f"{pre}.npy")
        self.depth = load("Depth", f"{pre}.npy")
        self.mask = load("Annotations", f"{pre}.npy")
        self.crop2raw = load("Annotations", f"{pre}-crop2raw.npy")
        self.detected = load("Annotations", f"{pre}-is_detected.npy")
        self.feature = load("Features", f"{pre}-dinov2-01.npy")
        self.frames = self.rgb.shape[0]
        self.flow = {}
        for d in FLOW_DELTAS:
            for way in ("FW", "BW"):
                path = os.path.join(base, f"Flow{way}_{d}", "Full-Resolution", f"{seq}-0000",
                                    f"{pre}.npy")
                if os.path.exists(path):
                    self.flow[way, d] = np.load(path)

    def pair_ok(self, a: int, b: int) -> bool:
        """Whether (a, b) is a pair the recipe's loader can draw: b = a + d,
        d = 1 or a flow step that divides a."""
        d = b - a
        return 0 <= a and b < self.frames and (d == 1 or (
            d in FLOW_DELTAS and a % d == 0 and ("FW", d) in self.flow))

    def frame(self, i: int, towards: int) -> Dict[str, torch.Tensor]:
        res = self.res
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        d = towards - i
        if d > 0 and ("FW", d) in self.flow:
            flow = self.flow["FW", d][i // d]
        elif d < 0 and ("BW", -d) in self.flow:
            flow = self.flow["BW", -d][i // -d - 1]
        else:
            flow = np.zeros((res, res, 3), np.float32)
        y, x = torch.meshgrid(torch.arange(res, device=self.device),
                              torch.arange(res, device=self.device), indexing="ij")
        hxy = torch.stack([x, y, torch.ones_like(x)], -1).reshape(-1, 3)
        # features: bilinear on the coarse grid at pixel (x, y) * grid / res, in float64
        feat = torch.as_tensor(np.asarray(self.feature[i], np.float32), device=self.device)
        g = feat.shape[0]
        u = torch.clamp(hxy[:, 0].double() / res * g, 0, g - 1.000001)
        v = torch.clamp(hxy[:, 1].double() / res * g, 0, g - 1.000001)
        u0, v0 = u.floor().long(), v.floor().long()
        wu, wv = (u - u0)[:, None], (v - v0)[:, None]
        f64 = feat.double()
        sample = (f64[v0, u0] * (1 - wu) * (1 - wv) + f64[v0, u0 + 1] * wu * (1 - wv)
                  + f64[v0 + 1, u0] * (1 - wu) * wv + f64[v0 + 1, u0 + 1] * wu * wv)
        flow = t(flow).reshape(-1, 3)
        mask = t(self.mask[i]).reshape(-1, 2)
        return {"rgb": t(self.rgb[i]).reshape(-1, 3), "mask": mask[:, :1],
                "vis2d": mask[:, 1:], "depth": t(self.depth[i]).reshape(-1, 1),
                "flow": flow[:, :2], "flow_uct": flow[:, 2:], "feature": sample.float(),
                "crop2raw": t(self.crop2raw[i]), "is_detected": t(self.detected[i]),
                "hxy": hxy.float(), "frameid": torch.tensor(i, device=self.device)}

    def batch(self, a: int, b: int) -> Dict[str, torch.Tensor]:
        """The pair (a, b): frame a with its flow towards b, b towards a."""
        fa, fb = self.frame(a, b), self.frame(b, a)
        return {k: torch.stack([fa[k], fb[k]]) for k in fa}


def batch_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The largest difference between the program's batch and the one read
    here, over every map the step reads."""
    gap = 0.0
    for k, v in ref.items():
        p = prog[k].to(v.device).reshape(v.shape).to(v.dtype)
        gap = max(gap, float(torch.max(torch.abs(p - v))))
    return gap


# --- the initial state --------------------------------------------------------

@torch.no_grad()
def mean_knn_sq(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest others."""
    out = []
    for s in range(0, points.shape[0], chunk):
        d2 = torch.cdist(points[s:s + chunk], points) ** 2
        out.append(torch.topk(d2, k + 1, largest=False).values[:, 1:].mean(-1))
    return torch.cat(out)


@torch.no_grad()
def surfels(points, colours, feats, capacity, gen) -> Dict[str, torch.Tensor]:
    """A store of ``capacity`` slots holding the given points first: SH
    DC from the colours, log-scale from the 3-NN distance, random unit
    rotations, opacity 0.1; the rest dead."""
    n, dev = points.shape[0], points.device
    k = (3 + 1) ** 2

    def slots(x):
        out = torch.zeros((capacity,) + tuple(x.shape[1:]), device=dev)
        out[:n] = x
        return out

    rot = slots(torch.rand((n, 4), generator=gen, device=dev))
    rot[n:, 0] = 1.0
    scale = torch.log(torch.sqrt(torch.clamp(mean_knn_sq(points), min=1e-7)))
    return {"xyz": slots(points),
            "features_dc": slots(((colours - 0.5) / render.SH_C0)[:, None]),
            "features_rest": torch.zeros((capacity, k - 1, 3), device=dev),
            "scaling": slots(scale[:, None].repeat(1, 2)), "rotation": rot,
            "opacity": slots(torch.full((n, 1), math.log(0.1 / 0.9), device=dev)),
            "regist_feat": slots(feats),
            "alive": torch.arange(capacity, device=dev) < n,
            "max_radii2d": torch.zeros(capacity, device=dev),
            "grad_accum": torch.zeros(capacity, device=dev),
            "denom": torch.zeros(capacity, device=dev)}


# --- the step ------------------------------------------------------------------

def nonzero_mean(v):
    pos = (v > 0).to(v.dtype)
    n = torch.sum(pos)
    return torch.where(n > 0, torch.sum(v * pos) / torch.clamp(n, min=1.0), torch.mean(v))


def norm(x, keepdim=True):
    return torch.sqrt(torch.clamp(torch.sum(x * x, -1, keepdim=keepdim), min=1e-24))


def k_inv(K):
    """(M, 4) intrinsics -> their inverse as (1/fx, 1/fy, -cx/fx, -cy/fy)."""
    return torch.stack([1.0 / K[:, 0], 1.0 / K[:, 1], -K[:, 2] / K[:, 0], -K[:, 3] / K[:, 1]], -1)


def pixel(K, x):
    """Pinhole pixel (x, y) of camera points x (M, N, 3) under K (M, 4);
    |z| held at 1e-3 or more, its sign kept."""
    z = x[..., 2:3]
    z = torch.where(z.abs() < 1e-3, torch.where(z < 0, -1e-3, 1e-3).to(z.dtype), z)
    fx, fy, cx, cy = (K[:, i, None, None] for i in range(4))
    return torch.cat([(fx * x[..., 0:1] + cx * x[..., 2:3]) / z,
                      (fy * x[..., 1:2] + cy * x[..., 2:3]) / z], -1)


class Step:
    """The step's fixed inputs: frames, resolution, capacity."""

    def __init__(self, frames: int, res: int, capacity: int, device):
        self.frames, self.res, self.cap, self.device = frames, res, capacity, device

    def pose(self, P: Dict, frame, crop2raw):
        """Per frame: the intrinsics K (M, 4) through the crop (K o
        crop2raw, taken back and forth as a matrix pair), the camera (q,
        t), the bones and the rest pose broadcast to the frames."""
        T = self.frames
        kinv = k_inv(nets.intrinsics(P, frame, T))
        c = crop2raw
        kinv = torch.stack([kinv[:, 0] * c[:, 0], kinv[:, 1] * c[:, 1],
                            kinv[:, 0] * c[:, 2] + kinv[:, 2],
                            kinv[:, 1] * c[:, 3] + kinv[:, 3]], -1)
        art = nets.bones(P, frame, T)
        rest = nets.bones(P, frame, T, mean=True)
        rest = (rest[0].expand_as(art[0]), rest[1].expand_as(art[1]))
        return k_inv(kinv), nets.camera(P, frame, T), art, rest

    @torch.no_grad()
    def camera_points(self, P: Dict, xyz, frame, crop2raw):
        """Points (N, 3) warped to each frame's camera (M, N, 3)."""
        _, cam, art, rest = self.pose(P, frame, crop2raw)
        x = xyz[None].expand(frame.shape[0], -1, -1)
        qt, _, _ = nets.warp(P, x, art, rest, frame, self.frames)
        return nets.qrot(cam[0][:, None], nets.apply(qt, x)) + cam[1][:, None]

    def loss(self, P: Dict, S: Dict, alive, batch: Dict, step: int, dummy,
             fault: Optional[str] = None):
        """The step's total loss, its terms, and the projection (for the
        densify statistics)."""
        R, res, T = RECIPE, self.res, self.frames
        frame = batch["frameid"]
        m = frame.shape[0]
        K, cam, art, rest = self.pose(P, frame, batch["crop2raw"])
        xyz = S["xyz"][None].expand(m, -1, -1)
        qt, _, _ = nets.warp(P, xyz, art, rest, frame, T)
        rot = nets.normalize(S["rotation"])
        to_cam = lambda qt_w, x: nets.qrot(cam[0][:, None], nets.apply(qt_w, x)) + cam[1][:, None]
        x_cam = to_cam(qt, xyz)
        r_cam = nets.qmul(cam[0][:, None], nets.qmul(qt[0], rot[None]))
        # surfel flow to the pair's other frame: warped there from the canonical points
        swap = lambda v: v.reshape((m // 2, 2) + v.shape[1:]).flip(1).reshape(v.shape)
        cam_n = (swap(cam[0]), swap(cam[1]))
        qt_n, _, _ = nets.warp(P, xyz, (swap(art[0]), swap(art[1])), rest, swap(frame), T)
        x_next = nets.qrot(cam_n[0][:, None], nets.apply(qt_n, xyz)) + cam_n[1][:, None]
        flow = pixel(swap(K), x_next) - pixel(K, x_cam)
        scale_f = torch.amax(torch.abs(torch.where(alive[None, :, None], flow, 0.0))).detach() \
            + 1e-6
        colour = render.sh_colour(torch.cat([S["features_dc"], S["features_rest"]], 1), x_cam)
        colour = torch.cat([colour, flow / scale_f], -1)
        proj = render.project(x_cam, nets.qmat(r_cam), torch.exp(S["scaling"]), K, alive,
                              dummy)
        bg = torch.cat([torch.sigmoid(P["bg_color"]), colour.new_zeros(2)])
        out = render.composite(proj, colour, torch.sigmoid(S["opacity"][:, 0]), bg, res,
                               R["raster_span_cap"], R["raster_entry_cap"])
        if fault == "altered":
            out["colour"] = out["colour"] * 1.01
        img = lambda v: v.reshape(m, res, res, -1)
        gt_mask, vis = img(batch["mask"]), img(batch["vis2d"])
        fg = gt_mask * vis
        terms = {}
        terms["rgb"] = R["rgb_wt"] * torch.mean(
            torch.abs(out["colour"][..., :3] - img(batch["rgb"])) * vis)
        gt_flow = img(batch["flow"])
        snr = torch.clamp(norm(gt_flow) / R["flow_noise_px"] - 1.0, 0.0, 1.0)
        err = norm(out["colour"][..., 3:5] * scale_f - gt_flow)
        terms["flow"] = nonzero_mean(
            err * snr * (img(batch["flow_uct"]) > 0) * fg) / res * R["flow_wt"]
        alpha = out["alpha"][..., None]
        depth = out["depth"][..., None] / torch.clamp(alpha, min=1e-6)
        terms["depth"] = nonzero_mean(torch.abs(depth - img(batch["depth"])) * fg) * R["depth_wt"]
        det = batch["is_detected"].reshape(-1, 1, 1, 1)
        vd = vis * det
        pos, neg = torch.sum(gt_mask * (vd > 0)), torch.sum((1 - gt_mask) * (vd > 0))
        total = torch.sum(vd)
        pos_wt, neg_wt = total / torch.clamp(pos, min=1e-6), total / torch.clamp(neg, min=1e-6)
        bal = 0.5 * pos_wt * gt_mask + 0.5 * neg_wt * (1 - gt_mask)
        bal = torch.where((torch.sum(gt_mask) > 0) & (torch.sum(1 - gt_mask) > 0), bal,
                          torch.ones_like(bal))
        terms["mask"] = R["mask_wt"] * nonzero_mean((alpha - gt_mask) ** 2 * bal * vis * det)
        # feature reprojection: soft match of a pixel grid's features to the surfels'
        feat, hxy, fmask = batch["feature"], batch["hxy"][..., :2], batch["mask"]
        n_px = R["feat_reproj_px"]
        if 0 < n_px < feat.shape[1]:
            st = feat.shape[1] // n_px
            if feat.shape[1] % n_px == 0 and res % st == 0 and 0 < st < res:
                pick = lambda v: v[:, ::st][:, :n_px]
            else:
                nc = min(res, int(math.ceil(math.sqrt(n_px))))
                rows = np.round(np.linspace(0, res - 1, -(-n_px // nc))).astype(np.int64)
                cols = np.round(np.linspace(0, res - 1, nc)).astype(np.int64)
                idx = torch.as_tensor((rows[:, None] * res + cols).reshape(-1)[:n_px],
                                      device=feat.device)
                pick = lambda v: v.index_select(1, idx)
            feat, hxy, fmask = pick(feat), pick(hxy), pick(fmask)
        cap = S["regist_feat"].shape[0]
        kk = min(R["match_candidates"], cap)
        stride = max(1, cap // kk)
        cand_f, cand_x = S["regist_feat"][::stride][:kk], S["xyz"][::stride][:kk]
        prob = torch.softmax((feat.reshape(-1, feat.shape[-1]) @ cand_f.T)
                             * torch.exp(P["logsigma"]), -1)
        match = (prob @ cand_x).reshape(m, -1, 3)
        qt_m, _, _ = nets.warp(P, match, art, rest, frame, T)
        xy = pixel(K, nets.qrot(cam[0][:, None], nets.apply(qt_m, match)) + cam[1][:, None])
        terms["feat_reproj"] = nonzero_mean(norm(xy - hxy) * fmask) / res * R["feat_reproj_wt"]
        # cycle: the warped surfels taken back to the rest pose
        sub = R["cycle_subsample"]
        q_i = nets.qconj(cam[0])
        x_obj = nets.qrot(q_i[:, None], x_cam[:, ::sub]) + nets.qrot(q_i, -cam[1])[:, None]
        qt_b, logits, delta = nets.warp(P, x_obj, art, rest, frame, T, backward=True)
        back = nets.apply(qt_b, x_obj)
        terms["reg_deform_cyc"] = R["reg_deform_cyc_wt"] * nonzero_mean(
            norm(back - S["xyz"][::sub][None]))
        logp = torch.log_softmax(logits, -1)
        entropy = -torch.gather(logp, -1, logits.argmax(-1, keepdim=True))
        terms["reg_skin_entropy"] = R["reg_skin_entropy_wt"] * nonzero_mean(entropy)
        terms["reg_delta_skin"] = R["reg_delta_skin_wt"] * nonzero_mean(
            torch.mean(delta ** 2, -1, keepdim=True))
        if step > R["normal_from"]:
            surf = depth_normal(depth[..., 0], K) * out["alpha"].detach()[..., None]
            terms["normal_loss"] = R["lambda_normal"] * torch.mean(
                1.0 - torch.sum(out["normal"] * surf, -1))
        total = sum(terms[k] for k in sorted(terms))
        return total, terms, proj


def depth_normal(depth, K):
    """Normals (M, H, W, 3) of a depth map: unprojected, central
    differences down and across, their normalised cross product; 0 on the
    border."""
    h, w = depth.shape[-2:]
    y, x = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                          torch.arange(w, dtype=depth.dtype, device=depth.device),
                          indexing="ij")
    fx, fy, cx, cy = (K[:, i, None, None] for i in range(4))
    pts = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x - cx)], -1) \
        * depth[..., None]
    n = torch.linalg.cross(pts[:, 2:, 1:-1] - pts[:, :-2, 1:-1],
                           pts[:, 1:-1, 2:] - pts[:, 1:-1, :-2], dim=-1)
    return torch.nn.functional.pad(n / norm(n), (0, 0, 1, 1, 1, 1))


# --- the optimisers and the densify ------------------------------------------------

def xyz_lr(count: int) -> float:
    """The surfel positions' rate: log-linear from init to final over max steps."""
    R = RECIPE
    t = min(max(count / R["position_lr_max_steps"], 0.0), 1.0)
    return math.exp(math.log(R["position_lr_init"]) * (1 - t)
                    + math.log(R["position_lr_final"]) * t)


def surfel_lrs(count: int) -> Dict[str, float]:
    R = RECIPE
    return {"xyz": xyz_lr(count), "features_dc": R["feature_lr"],
            "features_rest": R["feature_lr"] / 20.0, "scaling": R["scaling_lr"],
            "rotation": R["rotation_lr"], "opacity": R["opacity_lr"],
            "regist_feat": R["regist_feat_lr"]}


@torch.no_grad()
def surfel_adam(S, grads, mu, nu, count: int) -> None:
    """Adam (0.9, 0.999, eps 1e-15) of every surfel leaf at its rate, in place."""
    lrs = surfel_lrs(count)
    c1, c2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
    for k in SURFEL_FIELDS:
        g = grads[k]
        mu[k] = 0.9 * mu[k] + 0.1 * g
        nu[k] = 0.999 * nu[k] + 0.001 * (g * g)
        S[k] = S[k] - lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-15)


def warp_rate(count: int) -> float:
    """One-cycle: up from lr / 25 over the first two rounds, down to lr / 25
    at the end of the schedule."""
    R = RECIPE
    lr, total = R["learning_rate"], R["num_rounds"] * R["iters_per_round"]
    warm = max(int(total * 2.0 / max(R["num_rounds"], 2)), 1)
    if count < warm:
        return lr / 25 + (lr - lr / 25) * count / warm
    return lr + (lr / 25 - lr) * min((count - warm) / max(total - warm, 1), 1.0)


def warp_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The deformer's gradients as AdamW takes them: NaN to 0, clipped to
    a global norm of 5."""
    g = {k: torch.nan_to_num(v, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
         for k, v in grads.items()}
    n = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
    return {k: torch.where(n >= 5.0, v / n * 5.0, v) for k, v in g.items()}


@torch.no_grad()
def warp_adamw(P, grads, mu, nu, count: int) -> None:
    """AdamW (0.9, 0.999, eps 1e-8, decay 1e-4) at the one-cycle rate of
    update ``count`` (from 0), x10 for the explicit scalars, in place; the
    bias corrections rounded to float32."""
    rate = warp_rate(count)
    n = count + 1
    c1 = float(np.float32(1.0) - np.float32(0.9) ** n)
    c2 = float(np.float32(1.0) - np.float32(0.999) ** n)
    for k in P:
        mult = 10.0 if any(part in EXPLICIT for part in k.split(".")) else 1.0
        g = grads[k]
        mu[k] = 0.9 * mu[k] + 0.1 * g
        nu[k] = 0.999 * nu[k] + 0.001 * (g * g)
        P[k] = P[k] - ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) + 1e-4 * P[k]) \
            * (mult * rate)


@torch.no_grad()
def densify(S, mu, nu, step: int, device) -> None:
    """Clone the small surfels whose mean screen gradient reached the
    threshold, split the large ones in two (children drawn about the
    parent in its plane, scales / 1.6, the parent dies), prune the faint
    (and, after the first opacity reset, the large on screen or in the
    world); children fill the dead slots in order and their moments
    start at 0; the statistics restart. In place."""
    R = RECIPE
    cap = S["alive"].shape[0]
    alive = S["alive"]
    grad = S["grad_accum"] / torch.clamp(S["denom"], min=1e-12)
    grad = torch.where(torch.isnan(grad) | (S["denom"] == 0), 0.0, grad)
    scale = torch.exp(S["scaling"])
    big_scale = scale.amax(-1)
    opac = torch.sigmoid(S["opacity"][:, 0])
    ext = R["cameras_extent"]
    screen = 20.0 if step > R["opacity_reset_interval"] else 0.0
    hot = alive & (grad >= R["densify_grad_threshold"])
    small = big_scale <= R["percent_dense"] * ext
    clone, split = hot & small, hot & ~small
    faint = opac < R["min_opacity"]
    prune = faint | ((S["max_radii2d"] > screen) | (big_scale > 0.1 * ext)) if screen else faint
    keep = alive & ~split & ~prune
    noise = torch.randn((cap, 2, 2), generator=torch.Generator(device=device).manual_seed(step),
                        device=device)
    axes = nets.qmat(nets.normalize(S["rotation"]))
    off = noise * scale[:, None]
    child_xyz = S["xyz"][:, None] + (axes[:, None, :, 0] * off[..., 0:1]
                                     + axes[:, None, :, 1] * off[..., 1:2])
    child_scaling = torch.log(scale / 1.6)
    bad_split = faint | (torch.exp(child_scaling).amax(-1) > 0.1 * ext) if screen else faint
    bad_clone = faint | (big_scale > 0.1 * ext) if screen else faint
    ok_split = split & ~bad_split
    born = torch.cat([(clone & ~bad_clone) | ok_split, ok_split])   # child c of i: c * cap + i
    slots = torch.nonzero(~keep).flatten()                         # dead slots, in order
    kids = torch.nonzero(born).flatten()[:slots.shape[0]]
    slots = slots[:kids.shape[0]]
    parent, child = kids % cap, kids // cap
    as_clone = (child == 0) & clone[parent]
    for k in SURFEL_FIELDS:
        v = S[k][parent]
        if k == "xyz":
            v = torch.where(as_clone[:, None], v, child_xyz[parent, child])
        elif k == "scaling":
            v = torch.where(as_clone[:, None], v, child_scaling[parent])
        S[k] = S[k].index_copy(0, slots, v)
        mu[k] = mu[k].index_fill(0, slots, 0.0)
        nu[k] = nu[k].index_fill(0, slots, 0.0)
    S["alive"] = keep.index_fill(0, slots, True)
    for k in ("max_radii2d", "grad_accum", "denom"):
        S[k] = torch.zeros_like(S[k])
    return {"cloned": int(torch.sum(clone)), "split": int(torch.sum(split)),
            "pruned": int(torch.sum(alive & prune)), "alive": int(torch.sum(S["alive"]))}


@torch.no_grad()
def hooks(S, mu, nu, step: int, device) -> Dict:
    """What fires after the step that brought the count to ``step``; the
    densify's counts, if it fired."""
    R = RECIPE
    out = {}
    if step % R["densification_interval"] == 0 \
            and R["densify_from_iter"] < step < R["densify_until_iter"]:
        out = densify(S, mu, nu, step, device)
    if step % R["opacity_reset_interval"] == 0 and step < R["densify_until_iter"]:
        S["opacity"] = torch.logit(torch.clamp(torch.sigmoid(S["opacity"]), max=0.01))
        mu["opacity"], nu["opacity"] = torch.zeros_like(mu["opacity"]), \
            torch.zeros_like(nu["opacity"])
    if step % R["outlier_filtering_interval"] == 0 and step < R["outlier_stop_iter"]:
        raise NotImplementedError(f"the outlier filter fires at step {step}: no cell checks it")
    return out


# --- the steps -------------------------------------------------------------------

def grads_at(step_fn: Step, P, S, batch, step, fault=None):
    """The loss and the gradients of the deformer's and the surfels' leaves
    at one batch, and the densify statistics' increments."""
    P = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    leaves = {k: S[k].detach().requires_grad_(True) for k in SURFEL_FIELDS}
    m = batch["frameid"].shape[0]
    dummy = torch.zeros((m, step_fn.cap, 2), device=step_fn.device, requires_grad=True)
    total, _, proj = step_fn.loss(P, {**S, **leaves}, S["alive"], batch, step, dummy, fault)
    names = list(P) + [f"s.{k}" for k in leaves]
    gs = torch.autograd.grad(total, [*P.values(), *leaves.values(), dummy], allow_unused=True)
    flat = dict(zip(names + ["dummy"], gs))
    zero = lambda g, v: torch.zeros_like(v) if g is None else g
    gp = {k: zero(flat[k], v) for k, v in P.items()}
    gs_ = {k: zero(flat[f"s.{k}"], v) for k, v in leaves.items()}
    with torch.no_grad():
        vis = render.tile_box(proj["centre"], proj["radius"], proj["valid"],
                              -(-step_fn.res // render.TILE), RECIPE["raster_span_cap"])[4]
        grad2d = norm(zero(flat["dummy"], dummy) * proj["depth"][..., None] * float(step_fn.res),
                      keepdim=False)
        stats = (torch.sum(torch.where(vis, grad2d, 0.0), 0), torch.sum(vis.float(), 0),
                 torch.amax(torch.where(vis, proj["radius"], 0.0), 0))
    return total.detach(), gp, gs_, stats


def warm_moments(step_fn: Step, P, S, batch, step) -> Dict:
    """Moments as a run that has trained a while holds them: first
    moments 0, second moments each leaf's mean squared gradient at the
    initial state, so that the first updates scale with the gradient and
    are not lr x its sign."""
    _, gp, gs, _ = grads_at(step_fn, P, S, batch, step)
    gp = warp_grads(gp)
    second = lambda g: torch.full_like(g, float(torch.mean(g.double() ** 2)))
    return {"deformer": {"mu": {k: torch.zeros_like(v) for k, v in gp.items()},
                         "nu": {k: second(v) for k, v in gp.items()}},
            "surfels": {"mu": {k: torch.zeros_like(v) for k, v in gs.items()},
                        "nu": {k: second(v) for k, v in gs.items()}}}


def replay(step_fn: Step, db: Database, state: Dict, pairs: List, start: int, count: int,
           steps: int, fault: Optional[str] = None, first_step=None) -> Dict:
    """``steps`` steps from ``state`` at step ``start`` with the optimisers
    at ``count`` updates, on the frame pairs ``pairs`` (each (a, b), as the
    program's batches name them), each followed by its hooks: every step's
    loss, the first step's gradients as the optimisers take them, and each
    leaf's change over all of it, with the surfel store and its moments
    before and after the last step's hooks. ``fault`` ("half_batch": the
    batch's second frame replaced by its first; "altered": the rendered
    colour 1% brighter) breaks the step underneath; ``first_step`` is a
    context the first step runs in."""
    dev = step_fn.device
    P = {k: v.to(dev) for k, v in state["deformer"].items()}
    S = {k: v.to(dev) for k, v in state["surfels"].items()}
    mom = state["moments"]
    mu_p = {k: v.to(dev) for k, v in mom["deformer"]["mu"].items()}
    nu_p = {k: v.to(dev) for k, v in mom["deformer"]["nu"].items()}
    mu_s = {k: v.to(dev) for k, v in mom["surfels"]["mu"].items()}
    nu_s = {k: v.to(dev) for k, v in mom["surfels"]["nu"].items()}
    before = {**{f"deformer.{k}": v.clone() for k, v in P.items()},
              **{f"surfels.{k}": S[k].clone() for k in SURFEL_FIELDS}}
    losses, grad = [], {}

    def change():
        return {**{f"deformer.{k}": float(torch.linalg.vector_norm(
                    (v - before[f"deformer.{k}"]).double())) for k, v in P.items()},
                **{f"surfels.{k}": float(torch.linalg.vector_norm(
                    (S[k] - before[f"surfels.{k}"]).double())) for k in SURFEL_FIELDS}}

    for i in range(steps):
        a, b = pairs[i]
        batch = db.batch(a, b)
        if fault == "half_batch":
            batch = {k: torch.cat([v[:1], v[:1]]) for k, v in batch.items()}
        if first_step is not None and i == 0:
            with first_step:
                total, gp, gs, stats = grads_at(step_fn, P, S, batch, start + i, fault)
        else:
            total, gp, gs, stats = grads_at(step_fn, P, S, batch, start + i, fault)
        gp = warp_grads(gp)
        if i == 0:
            grad = {**{f"deformer.{k}": float(torch.linalg.vector_norm(v.double()))
                       for k, v in gp.items()},
                    **{f"surfels.{k}": float(torch.linalg.vector_norm(v.double()))
                       for k, v in gs.items()}}
        losses.append(float(total))
        S["grad_accum"] = S["grad_accum"] + stats[0]
        S["denom"] = S["denom"] + stats[1]
        S["max_radii2d"] = torch.maximum(S["max_radii2d"], stats[2])
        surfel_adam(S, gs, mu_s, nu_s, count + i + 1)
        warp_adamw(P, gp, mu_p, nu_p, count + i)
        if i == steps - 1:
            pre = {"surfels": {k: v.clone() for k, v in S.items()},
                   "mu": {k: v.clone() for k, v in mu_s.items()},
                   "nu": {k: v.clone() for k, v in nu_s.items()}}
        fired = hooks(S, mu_s, nu_s, start + i + 1, dev)
    return {"loss": losses, "grad": grad, "change": change(), "densify": fired,
            "before_hooks": pre,
            "after_hooks": {"surfels": S, "mu": mu_s, "nu": nu_s}}
