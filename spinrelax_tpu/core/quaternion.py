"""Batched quaternion algebra as pure JAX functions.

Accelerator-native replacement for the reference's ``transforms3d_supplement.py``
(plus the parts of the external ``transforms3d`` package it relies on).
All functions operate on arrays whose **last axis** holds the quaternion
(w, x, y, z) or vector (x, y, z) components, broadcast over any number of
leading batch axes, and are jit/vmap/grad-safe (no data-dependent Python
control flow).

Convention: Hamilton quaternions, scalar-first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def qnorm(q):
    """Normalise quaternions along the last axis; zero-safe
    (transforms3d_supplement.py:40-52 semantics: 0-vectors map to 0)."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where(n > 0, q / jnp.where(n > 0, n, 1.0), jnp.zeros_like(q))


def vecnorm(v):
    """Normalise vectors along the last axis, mapping zero vectors to zero
    (transforms3d_supplement.py:40-52)."""
    return qnorm(v)


def qmult(q1, q2):
    """Hamilton product, broadcasting over leading axes
    (transforms3d_supplement.py:163-183)."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - jnp.sum(v1 * v2, axis=-1, keepdims=True)
    v = w1 * v2 + w2 * v1 + jnp.cross(v1, v2)
    return jnp.concatenate([w, v], axis=-1)


def qconj(q):
    """Conjugate (= inverse for unit quaternions)
    (transforms3d_supplement.py:185-186)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


qinvert = qconj


def qreduce(q, qref=None):
    """Select the image of +-q closer to ``qref`` (double-cover reduction,
    transforms3d_supplement.py:219-245). sign(0) counts as +1."""
    if qref is None:
        d = q[..., 0]
    else:
        qref = jnp.asarray(qref, dtype=q.dtype)
        d = jnp.einsum("...i,...i->...", q, qref,
                   precision=jax.lax.Precision.HIGHEST)
    sgn = jnp.where(d >= 0, 1.0, -1.0).astype(q.dtype)
    return q * sgn[..., None]


def rotate_vector(v, q, normalised: bool = False):
    """Rotate vectors ``v`` by unit quaternions ``q``; broadcasts
    (transforms3d_supplement.py:263-296): b = q_v x (q_v x v + w v); v + 2b.
    """
    q = jnp.asarray(q)
    v = jnp.asarray(v)
    if not normalised:
        q = qnorm(q)
    w, qv = q[..., :1], q[..., 1:]
    a = jnp.cross(qv, v) + w * v
    b = jnp.cross(qv, a)
    return v + 2.0 * b


def axangle_to_quat(axis, angle, normalised: bool = False):
    """Axis-angle to quaternion, batched
    (transforms3d_supplement.py:54-69)."""
    axis = jnp.asarray(axis)
    angle = jnp.asarray(angle)
    if not normalised:
        axis = vecnorm(axis)
    half = angle / 2.0
    w = jnp.cos(half)[..., None]
    v = axis * jnp.sin(half)[..., None]
    return jnp.concatenate([w, v], axis=-1)


def quat_v1v2(v1, v2, normalised: bool = False):
    """Minimum-angle quaternion rotating v1 onto v2, batched
    (transforms3d_supplement.py:85-106).  Parallel vectors give identity."""
    v1 = jnp.asarray(v1)
    v2 = jnp.asarray(v2)
    if not normalised:
        v1 = vecnorm(v1)
        v2 = vecnorm(v2)
    dot = jnp.clip(jnp.sum(v1 * v2, axis=-1), -1.0, 1.0)
    th = jnp.arccos(dot)
    ax = jnp.cross(v1, v2)
    # Parallel vectors: zero cross, th=0 -> identity, matching the
    # reference's qeye() branch (transforms3d_supplement.py:78-81).
    # ANTIparallel vectors also give a zero cross but th=pi: the naive
    # axangle of a zero axis would return the INVALID zero quaternion
    # (the reference does; frame_transform then silently zeroes out) —
    # any axis perpendicular to v1 realises the 180-degree rotation.
    px = jnp.cross(v1, jnp.zeros_like(v1).at[..., 0].set(1.0))
    py = jnp.cross(v1, jnp.zeros_like(v1).at[..., 1].set(1.0))
    fallback = jnp.where(
        jnp.sum(px * px, axis=-1, keepdims=True) > 1e-12, px, py
    )
    anti = (dot < -1.0 + 1e-12)[..., None]
    ax = jnp.where(anti, fallback, ax)
    return axangle_to_quat(ax, th)


def quat_to_mat(q):
    """Unit quaternion -> 3x3 rotation matrix, batched over leading axes."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def mat_to_quat(M):
    """Rotation matrix -> unit quaternion (w>=0), batched; branch-free
    variant suitable for jit (replaces transforms3d.quaternions.mat2quat).

    Uses the standard four-candidate construction and selects the
    numerically safest via the largest diagonal combination.
    """
    M = jnp.asarray(M)
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate 4*q_i^2 - 1 style discriminants
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 0.0))

    # Candidate quaternions built from each pivot
    qw = jnp.stack(
        [0.5 * safe_sqrt(tw),
         0.25 * (m21 - m12) / jnp.maximum(safe_sqrt(tw), 1e-30) * 2,
         0.25 * (m02 - m20) / jnp.maximum(safe_sqrt(tw), 1e-30) * 2,
         0.25 * (m10 - m01) / jnp.maximum(safe_sqrt(tw), 1e-30) * 2],
        axis=-1,
    )
    qx = jnp.stack(
        [0.25 * (m21 - m12) / jnp.maximum(safe_sqrt(tx), 1e-30) * 2,
         0.5 * safe_sqrt(tx),
         0.25 * (m01 + m10) / jnp.maximum(safe_sqrt(tx), 1e-30) * 2,
         0.25 * (m02 + m20) / jnp.maximum(safe_sqrt(tx), 1e-30) * 2],
        axis=-1,
    )
    qy = jnp.stack(
        [0.25 * (m02 - m20) / jnp.maximum(safe_sqrt(ty), 1e-30) * 2,
         0.25 * (m01 + m10) / jnp.maximum(safe_sqrt(ty), 1e-30) * 2,
         0.5 * safe_sqrt(ty),
         0.25 * (m12 + m21) / jnp.maximum(safe_sqrt(ty), 1e-30) * 2],
        axis=-1,
    )
    qz = jnp.stack(
        [0.25 * (m10 - m01) / jnp.maximum(safe_sqrt(tz), 1e-30) * 2,
         0.25 * (m02 + m20) / jnp.maximum(safe_sqrt(tz), 1e-30) * 2,
         0.25 * (m12 + m21) / jnp.maximum(safe_sqrt(tz), 1e-30) * 2,
         0.5 * safe_sqrt(tz)],
        axis=-1,
    )

    disc = jnp.stack([tw, tx, ty, tz], axis=-1)
    idx = jnp.argmax(disc, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4cand, 4comp)
    q = jnp.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    q = qnorm(q)
    return qreduce(q)


def frame_transform(axes):
    """Quaternion performing the COORDINATE transform that maps the three
    given (row) axes onto the lab axes (transforms3d_supplement.py:119-133).
    ``axes`` has shape (..., 3, 3) with axes[..., i, :] the i-th axis."""
    ref_z = jnp.zeros_like(axes[..., 2, :]).at[..., 2].set(1.0)
    ref_x = jnp.zeros_like(axes[..., 0, :]).at[..., 0].set(1.0)
    q1 = quat_v1v2(axes[..., 2, :], ref_z)
    xrot = rotate_vector(axes[..., 0, :], q1, normalised=True)
    q2 = quat_v1v2(xrot, ref_x)
    return qmult(q2, q1)


def frame_transform_min(axes):
    """Sign-minimised variant: chooses +-z and +-x targets that maximise the
    quaternion scalar part, i.e. the smallest rotation
    (transforms3d_supplement.py:137-149). Batched over leading axes."""
    axes = jnp.asarray(axes)
    zax = axes[..., 2, :]
    ref_zp = jnp.zeros_like(zax).at[..., 2].set(1.0)
    q1a = quat_v1v2(zax, ref_zp)
    q1b = quat_v1v2(zax, -ref_zp)
    pick1 = (q1a[..., 0] > q1b[..., 0])[..., None]
    q1 = jnp.where(pick1, q1a, q1b)

    xrot = rotate_vector(axes[..., 0, :], q1, normalised=True)
    ref_xp = jnp.zeros_like(xrot).at[..., 0].set(1.0)
    q2a = quat_v1v2(xrot, ref_xp)
    q2b = quat_v1v2(xrot, -ref_xp)
    pick2 = (q2a[..., 0] > q2b[..., 0])[..., None]
    q2 = jnp.where(pick2, q2a, q2b)
    return qmult(q2, q1)


def random_quats(key, n: int, dtype=jnp.float64, reduce: bool = True):
    """Shoemake-uniform random rotations (transforms3d_supplement.py:200-217)
    driven by a JAX PRNG key instead of python ``random``."""
    r = jax.random.uniform(key, (3, n), dtype=dtype)
    q = jnp.stack(
        [
            jnp.sqrt(1.0 - r[0]) * jnp.sin(2.0 * jnp.pi * r[1]),
            jnp.sqrt(1.0 - r[0]) * jnp.cos(2.0 * jnp.pi * r[1]),
            jnp.sqrt(r[0]) * jnp.sin(2.0 * jnp.pi * r[2]),
            jnp.sqrt(r[0]) * jnp.cos(2.0 * jnp.pi * r[2]),
        ],
        axis=-1,
    )
    if reduce:
        q = qreduce(q)
    return q


def slerp(q1, q2, r):
    """Spherical interpolation between two quaternions along the shortest
    arc, with q=q1 at r=0 and q=q2 (up to sign) at r=1.

    Covers transforms3d_supplement.py:253-261, but fixes two bugs the
    reference itself flags with a WARNING: it doubles the arc angle
    (2*acos of the relative-quaternion w, giving uneven interpolation)
    and divides by sin(th)=0 for identical endpoints.  Here th is the
    4D angle arccos(|q1.q2|); near-parallel endpoints fall back to
    normalised lerp."""
    dot = jnp.sum(q1 * q2, axis=-1)
    q2s = jnp.where(dot[..., None] < 0, -q2, q2)  # shortest path
    d = jnp.clip(jnp.abs(dot), 0.0, 1.0)
    th = jnp.arccos(d)
    s = jnp.sin(th)
    safe = s > 1e-8
    s_ = jnp.where(safe, s, 1.0)
    w1 = jnp.where(safe, jnp.sin((1 - r) * th) / s_, 1.0 - r)
    w2 = jnp.where(safe, jnp.sin(r * th) / s_, r)
    return qnorm(w1[..., None] * q1 + w2[..., None] * q2s)
