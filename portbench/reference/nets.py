"""The Stage-3 deformer of Vidu4D's ``gs-bob`` recipe, written out plainly
from its parameters: the per-frame camera and intrinsics, the 25 free
bones over time, and the dual-quaternion blend-skinning warp with its
delta-skin MLP. Functions of a flat ``{name: tensor}`` dict whose names
are the deformer's parameter names; no module classes.

Conventions: quaternions (w, x, y, z); a dual quaternion is the pair
(real, dual); a rigid transform (q, t) maps x to q x q* + t.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

WIDTH = 256          # the time trunks' width and depth, and the heads' hidden width
TRUNK_DEPTH = 5
BONES = 25
SKIN_WIDTH, SKIN_DEPTH = 64, 2   # the delta-skin MLP
SKIN_TIME = 128                  # the delta-skin MLP's time code
FREQ_T = 6                       # Fourier bands of time (trunks: adjusted to the video)
INIT_GAUSS = 0.03                # bones' Gaussian radius at init
TRUNKS = {"warp.articulation": FREQ_T, "camera_mlp": FREQ_T, "intrinsics": 0}
TIME_SCALE = {"warp.articulation": 1.0, "camera_mlp": 1.0, "intrinsics": 0.1}


def trunk_freqs(frames: int, n: int) -> int:
    """Time bands of a trunk for a video of ``frames`` frames: ``n`` at 64
    frames, one less for each halving."""
    if n <= 0:
        return n
    return int(round(math.log2(max(frames, 1) / 64) + n))


def shapes(frames: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, for one video of ``frames``."""
    out = {"logscale": (1,), "logsigma": (1,), "bg_color": (3,), "warp.logibeta": (1,)}

    def linear(name, n_in, n_out):
        out[f"{name}.weight"] = (n_out, n_in)
        out[f"{name}.bias"] = (n_out,)

    def time_embedding(name, bands, width):
        out[f"{name}.inst_embedding.mapping"] = (1, width)
        linear(f"{name}.mapping1", 1 if bands <= 0 else 2 * bands + 1, width)
        linear(f"{name}.mapping2", 2 * width, width)

    for mod, n in TRUNKS.items():
        time_embedding(f"{mod}.time_mlp.time_embedding", trunk_freqs(frames, n), WIDTH)
        for i in range(TRUNK_DEPTH):
            linear(f"{mod}.time_mlp.trunk.linear_{i + 1}", WIDTH, WIDTH)
        linear(f"{mod}.time_mlp.trunk.linear_final", WIDTH, WIDTH)
    heads = {"warp.articulation.trans_head": 3 * BONES, "warp.articulation.so3_head": 3 * BONES,
             "camera_mlp.trans_head": 3, "camera_mlp.quat_head": 4, "intrinsics.focal_head": 2}
    for name, n_out in heads.items():
        linear(f"{name}.hidden", WIDTH, WIDTH // 2)
        linear(f"{name}.out", WIDTH // 2, n_out)
    out["warp.skinning_model.log_gauss"] = (BONES, 3)
    time_embedding("warp.skinning_model.time_embedding", FREQ_T, SKIN_TIME)
    n_in = 3 * BONES + SKIN_TIME
    for i in range(SKIN_DEPTH):
        linear(f"warp.skinning_model.delta_field.mlp.linear_{i + 1}", n_in, SKIN_WIDTH)
        n_in = SKIN_WIDTH
    linear("warp.skinning_model.delta_field.mlp.linear_final", SKIN_WIDTH, BONES)
    out["camera_mlp.base_quat"] = (1, 4)
    out["intrinsics.base_logfocal"] = (1, 2)
    out["intrinsics.base_ppoint"] = (1, 2)
    return out


@torch.no_grad()
def init(frames: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Parameters drawn from ``gen`` as flax initialises them: weights
    lecun-normal truncated at 2 sigma, biases 0, instance codes N(0, 1);
    the scalars at their starting values (scale 0.1, bone radius 0.03,
    skinning temperature 0.01, no background, no base pose)."""
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
    out["logscale"].fill_(math.log(0.1))
    out["warp.logibeta"].fill_(-math.log(0.01))
    out["warp.skinning_model.log_gauss"].fill_(math.log(INIT_GAUSS))
    return out


# --- quaternions -------------------------------------------------------------

def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qrot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x rotated by the unit quaternion q: x + 2 w (v x x) + 2 v x (v x x)."""
    w, v = q[..., :1], q[..., 1:]
    v, x = torch.broadcast_tensors(v, x)
    c = torch.linalg.cross(v, x, dim=-1)
    return x + 2.0 * (w * c + torch.linalg.cross(v, c, dim=-1))


def qmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation of a quaternion, normalised inside."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, -1)
    return torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
                        s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
                        s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
                       -1).reshape(q.shape[:-1] + (3, 3))


def axis_angle(v: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation vector (safe at 0)."""
    a2 = torch.sum(v * v, -1, keepdim=True)
    a = torch.sqrt(torch.clamp(a2, min=1e-24))
    k = torch.where(a < 1e-6, 0.5 - a2 / 48.0, torch.sin(0.5 * a) / a)
    return torch.cat([torch.cos(0.5 * a), v * k], -1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True), min=1e-24))


def dq_from_qt(q, t):
    return q, 0.5 * qmul(F.pad(t, (1, 0)), q)


def qt_from_dq(r, d):
    return r, 2.0 * qmul(d, qconj(r))[..., 1:]


def dq_mul(a, b):
    return qmul(a[0], b[0]), qmul(a[0], b[1]) + qmul(a[1], b[0])


def dq_conj(a):
    return qconj(a[0]), qconj(a[1])


# --- the time-conditioned MLPs -----------------------------------------------

def _linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def fourier(x: torch.Tensor, bands: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] of a (..., 1) input."""
    if bands <= 0:
        return x
    xf = x * (2.0 ** torch.arange(bands, dtype=x.dtype, device=x.device))
    return torch.cat([x, torch.stack([torch.sin(xf), torch.cos(xf)], -1).flatten(-2)], -1)


def time_code(P, name, frame: torch.Tensor, frames: int, bands: int,
              scale: float = 1.0) -> torch.Tensor:
    """The time embedding of frames (...,) of one video of ``frames``:
    its time in [-1, 1), Fourier bands, a linear map, the video's code."""
    dtype = P[f"{name}.mapping1.weight"].dtype
    t = ((frame.to(dtype) - frames / 2.0) / frames * 2.0 * scale)[..., None]
    h = _linear(P, f"{name}.mapping1", fourier(t, bands))
    code = P[f"{name}.inst_embedding.mapping"][0].expand(h.shape)
    return _linear(P, f"{name}.mapping2", torch.cat([h, code], -1))


def trunk(P, mod, frame, frames, mean=False):
    """A module's time trunk at frames, or at the mean time code."""
    te = f"{mod}.time_mlp.time_embedding"
    bands = trunk_freqs(frames, TRUNKS[mod])
    if mean:
        h = time_code(P, te, torch.arange(frames, device=frame.device), frames, bands,
                      TIME_SCALE[mod]).mean(0, keepdim=True)
    else:
        h = time_code(P, te, frame, frames, bands, TIME_SCALE[mod])
    for i in range(TRUNK_DEPTH):
        h = torch.relu(_linear(P, f"{mod}.time_mlp.trunk.linear_{i + 1}", h))
    return torch.relu(_linear(P, f"{mod}.time_mlp.trunk.linear_final", h))


def head(P, name, h):
    return _linear(P, f"{name}.out", torch.relu(_linear(P, f"{name}.hidden", h)))


def camera(P, frame, frames):
    """Object-to-camera (q (M, 4), t (M, 3)) at frames."""
    h = trunk(P, "camera_mlp", frame, frames)
    q = normalize(head(P, "camera_mlp.quat_head", h))
    base = P["camera_mlp.base_quat"][0].expand(q.shape)
    n = torch.sqrt(torch.clamp(torch.sum(base * base, -1, keepdim=True), min=1e-24))
    base = torch.where(n > 1e-6, base / n, base.new_tensor([1.0, 0.0, 0.0, 0.0]))
    return qmul(q, base), head(P, "camera_mlp.trans_head", h)


def intrinsics(P, frame, frames):
    """(fx, fy, cx, cy) (M, 4) at frames, square pixels."""
    h = trunk(P, "intrinsics", frame, frames)
    f = torch.exp(head(P, "intrinsics.focal_head", h)) * torch.exp(
        P["intrinsics.base_logfocal"][0])
    f = (f + f.flip(-1)) / 2.0
    return torch.cat([f, P["intrinsics.base_ppoint"][0].expand(f.shape)], -1)


def bones(P, frame, frames, mean=False):
    """Bone-to-object dual quaternions ((M, B, 4), (M, B, 4)) at frames
    (or at the rest pose, the mean time code: leading dim 1)."""
    h = trunk(P, "warp.articulation", frame, frames, mean)
    t = 0.1 * head(P, "warp.articulation.trans_head", h).reshape(h.shape[:-1] + (BONES, 3))
    r = head(P, "warp.articulation.so3_head", h).reshape(h.shape[:-1] + (BONES, 3))
    return dq_from_qt(axis_angle(r), t)


# --- blend skinning ----------------------------------------------------------

def skin_logits(P, x, bone2obj, frame, frames):
    """Skinning logits (M, N, B) and delta (M, N, B) of points x (M, N, 3)
    against bones ((M, B, 4), (M, B, 4)): minus the squared distance in
    each bone's Gaussian frame, minus the delta MLP's correction,
    conditioned on the frames' time code (the mean one when ``frame`` is
    None)."""
    q, t = qt_from_dq(*dq_conj(bone2obj))                     # object -> bone
    xb = torch.einsum("mbij,mnj->mnbi", qmat(q), x) + t[:, None]
    xb = xb / torch.exp(P["warp.skinning_model.log_gauss"])
    d2 = torch.sum(xb * xb, -1)
    te = "warp.skinning_model.time_embedding"
    if frame is None:
        code = time_code(P, te, torch.arange(frames, device=x.device), frames,
                         FREQ_T).mean(0, keepdim=True)
    else:
        code = time_code(P, te, frame, frames, FREQ_T)
    code = code[:, None].expand(x.shape[0], x.shape[1], code.shape[-1])
    h = torch.cat([xb.flatten(-2), code], -1)
    for i in range(SKIN_DEPTH):
        h = torch.relu(_linear(P, f"warp.skinning_model.delta_field.mlp.linear_{i + 1}", h))
    delta = 0.1 * torch.relu(_linear(P, "warp.skinning_model.delta_field.mlp.linear_final", h))
    return -(d2 + delta), delta


def blend(se3, x, weights):
    """Per point, the dual-quaternion blend of bones se3 ((M, B, 4) x 2)
    under weights (M, N, B), each bone's real part first turned into the
    hemisphere of the point's heaviest bone: the rigid transform (q, t)."""
    r, d = se3
    with torch.no_grad():
        top = torch.gather(r, 1, weights.argmax(-1)[..., None].expand(-1, -1, 4))
        sign = torch.where(torch.einsum("mnd,mbd->mnb", top, r) > 0, 1.0, -1.0)
    w = weights * sign
    rw, dw = torch.einsum("mnb,mbd->mnd", w, r), torch.einsum("mnb,mbd->mnd", w, d)
    inv = 1.0 / torch.sqrt(torch.clamp(torch.sum(rw * rw, -1, keepdim=True), min=1e-24))
    return qt_from_dq(rw * inv, dw * inv)


def warp(P, x, art, rest, frame, frames, backward=False):
    """The skinning warp's rigid transform per point x (M, N, 3): forward
    (rest pose -> frame, skinned at the rest pose with the mean time code)
    or backward (frame -> rest pose, skinned at the frame's pose with its
    time code). Returns ((q, t), skin logits, delta)."""
    if backward:
        se3, at, fr = dq_mul(rest, dq_conj(art)), art, frame
    else:
        se3, at, fr = dq_mul(art, dq_conj(rest)), rest, None
    logits, delta = skin_logits(P, x, at, fr, frames)
    return blend(se3, x, torch.softmax(logits, -1)), logits, delta


def apply(qt, x):
    return qrot(qt[0], x) + qt[1]
