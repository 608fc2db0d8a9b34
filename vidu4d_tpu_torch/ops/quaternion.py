"""Quaternion / dual-quaternion algebra (`vidu4d_tpu/ops/quaternion.py`).

Convention: real part first, ``q = (w, x, y, z)``. A dual quaternion is a
pair ``(q_r, q_d)`` of real/dual parts. All functions broadcast over leading
dimensions. Only what the Stage-3 step and its round loop reach is ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vidu4d_tpu_torch.ops.point_reduce import reduce_points

DualQuaternion = Tuple[torch.Tensor, torch.Tensor]
QuaternionTranslation = Tuple[torch.Tensor, torch.Tensor]


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., 0:1], -q[..., 1:]], dim=-1)


def quaternion_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two (w, x, y, z) quaternions, broadcasting."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate 3D points by unit quaternions: ``q * p * q^-1`` (15-mul form)."""
    qw = q[..., 0:1]
    qv = q[..., 1:]
    qv, point = torch.broadcast_tensors(qv, point)
    uv = torch.linalg.cross(qv, point, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return point + 2.0 * (qw * uv + uuv)


def quaternion_translation_apply(q, t, point):
    return quaternion_apply(q, point) + t


def quaternion_translation_inverse(q, t) -> QuaternionTranslation:
    q_inv = quaternion_conjugate(q)
    return q_inv, quaternion_apply(q_inv, -t)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) vectors to quaternions, safe at zero angle."""
    angle_sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle_sq, min=1e-24))
    half = 0.5 * angle
    small = angle < 1e-6
    # sin(x/2)/x ~= 1/2 - x^2/48 for small x
    sin_half_over_angle = torch.where(
        small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle
    )
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-ish quaternions to (..., 3, 3) rotation matrices."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.sqrt(torch.clamp(x, min=1e-24)), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (w, x, y, z) quaternions: the
    best-conditioned of the four candidates (`quaternion.py:127`)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = \
        matrix.reshape(matrix.shape[:-2] + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2) / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    return torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4))).squeeze(-2)


def quaternion_translation_to_se3(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(quaternion (..., 4), translation (..., 3)) -> (..., 4, 4) SE(3)
    (`quaternion.py:169`)."""
    top = torch.cat([quaternion_to_matrix(q), t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_to_quaternion_translation(se3: torch.Tensor) -> QuaternionTranslation:
    """(..., 4, 4) SE(3) -> (quaternion (..., 4), translation (..., 3))."""
    return matrix_to_quaternion(se3[..., :3, :3]), se3[..., :3, 3]


def quaternion_translation_to_dual_quaternion(q, t) -> DualQuaternion:
    t_quat = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return q, 0.5 * quaternion_mul(t_quat, q)


def dual_quaternion_to_quaternion_translation(dq: DualQuaternion) -> QuaternionTranslation:
    q_r, q_d = dq
    t = 2.0 * quaternion_mul(q_d, quaternion_conjugate(q_r))[..., 1:]
    return q_r, t


def dual_quaternion_mul(dq1: DualQuaternion, dq2: DualQuaternion) -> DualQuaternion:
    q_r1, q_d1 = dq1
    q_r2, q_d2 = dq2
    r = quaternion_mul(q_r1, q_r2)
    d = quaternion_mul(q_r1, q_d2) + quaternion_mul(q_d1, q_r2)
    return r, d


def dual_quaternion_inverse(dq: DualQuaternion) -> DualQuaternion:
    """Inverse of a *unit* dual quaternion = conjugate of both parts."""
    return quaternion_conjugate(dq[0]), quaternion_conjugate(dq[1])


def dual_quaternion_apply(dq: DualQuaternion, point: torch.Tensor) -> torch.Tensor:
    q, t = dual_quaternion_to_quaternion_translation(dq)
    return quaternion_translation_apply(q, t, point)


def dual_quaternion_normalize(dq: DualQuaternion) -> DualQuaternion:
    q_r, q_d = dq
    inv_mag = 1.0 / torch.sqrt(
        torch.clamp(torch.sum(q_r * q_r, dim=-1, keepdim=True), min=1e-24)
    )
    return q_r * inv_mag, q_d * inv_mag


class _BoneBlend(torch.autograd.Function):
    """``(w @ qr, w @ qd)`` per batch entry: weights w (M, N, B), bone
    parts (M, B, 4). The forward is the two einsums; in the backward the
    bones' gradients, sums over the N points, go to `reduce_points`."""

    @staticmethod
    def forward(ctx, w, qr, qd):
        ctx.save_for_backward(w, qr, qd)
        return torch.einsum("mnb,mbd->mnd", w, qr), torch.einsum("mnb,mbd->mnd", w, qd)

    @staticmethod
    def backward(ctx, g_r, g_d):
        w, qr, qd = ctx.saved_tensors
        g_w = g_qr = g_qd = None
        if ctx.needs_input_grad[0]:
            g_w = torch.bmm(g_r, qr.transpose(1, 2)) + torch.bmm(g_d, qd.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            g_qr = reduce_points(w, g_r)
        if ctx.needs_input_grad[2]:
            g_qd = reduce_points(w, g_d)
        return g_w, g_qr, g_qd


def dual_quaternion_skinning(
    dual_quat: DualQuaternion,
    pts: torch.Tensor,
    skin: torch.Tensor,
    return_qt: bool = False,
):
    """Dual-quaternion blend skinning with hemisphere alignment
    (`vidu4d_tpu/ops/quaternion.py:232`).

    Per point, every bone quaternion is sign-aligned to the max-weight
    bone's hemisphere before blending. The sign is piecewise constant, so it
    is computed without gradient. The bones' gradients are sums over the
    points (`_BoneBlend`).

    Args:
        dual_quat: ``((M, B, 4), (M, B, 4))`` per-bone SE(3) as dual quats.
        pts: ``(M, ..., 3)`` canonical points.
        skin: ``(M, ..., B)`` skinning weights.
        return_qt: if True return the blended ``(q, t)`` instead of warped pts.
    """
    shape = pts.shape
    qr_bones, qd_bones = dual_quat
    m, b, _ = qr_bones.shape
    pts_flat = pts.reshape(m, -1, 3)
    skin_flat = skin.reshape(m, -1, b)

    with torch.no_grad():
        anchor = torch.argmax(skin_flat, dim=-1)  # (M, N)
        qr_anchor = torch.gather(
            qr_bones, 1, anchor[..., None].expand(-1, -1, 4)
        )  # (M, N, 4)
        dots = torch.einsum("mnd,mbd->mnb", qr_anchor, qr_bones)
        sign = torch.where(dots > 0, 1.0, -1.0).to(skin_flat.dtype)

    w_signed = skin_flat * sign
    qr_w, qd_w = _BoneBlend.apply(w_signed, qr_bones, qd_bones)
    qr_w, qd_w = dual_quaternion_normalize((qr_w, qd_w))

    if return_qt:
        q, t = dual_quaternion_to_quaternion_translation((qr_w, qd_w))
        return q.reshape(shape[:-1] + (4,)), t.reshape(shape)
    out = dual_quaternion_apply((qr_w, qd_w), pts_flat)
    return out.reshape(shape)
