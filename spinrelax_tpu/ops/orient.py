"""Trajectory orientation: batched Horn quaternion superposition.

Accelerator-native replacement for the reference's *external* orientation
toolchain — the PLUMED2 QUATERNION colvar (computes the per-frame
rigid-body orientation quaternion vs a reference structure;
plumed-quat-template.dat + run-all.bash:359) and mdtraj's
``center_coordinates``/``superpose`` least-squares fit
(calculate-Ct-from-traj.py:433,466-467).

Horn's closed-form solution: the optimal rotation mapping reference
coordinates onto a frame is the leading eigenvector of the 4x4 key
matrix K built from the coordinate correlation matrix.  All frames are
solved in one vmapped `eigh` — no external processes, no per-frame loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import quaternion as qt


def _horn_K(S):
    """Horn's 4x4 key matrix from a 3x3 correlation S = sum w x_ref x_frm^T."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    row0 = jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1)
    row1 = jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1)
    row2 = jnp.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1)
    row3 = jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1)
    return jnp.stack([row0, row1, row2, row3], -2)


def _quats_from_S(S, continuous: bool):
    """Horn quaternions from the correlation matrices: top eigenvector of
    the 4x4 K, double-cover reduced; optionally sign-continuous along the
    leading (frame) axis (flip q_t if q_t . q_{t-1} < 0).  ``continuous``
    is a trace-time constant.  Shared by :func:`orientation_quats` and
    :func:`bond_vectors_from_obs` so the convention cannot diverge."""
    K = _horn_K(S)
    _, vecs = jnp.linalg.eigh(K)  # ascending; take last column
    q = qt.qreduce(vecs[..., :, -1])
    if not continuous:
        return q

    def body(prev, qi):
        s = jnp.where(jnp.sum(prev * qi) >= 0, 1.0, -1.0)
        cur = qi * s
        return cur, cur

    _, q_cont = jax.lax.scan(body, q[0], q)
    return q_cont


@jax.jit
def orientation_quats(frames, reference, weights=None):
    """Per-frame rigid-body orientation quaternions vs a reference.

    frames    : (nFrames, nAtoms, 3) trajectory coordinates.
    reference : (nAtoms, 3) reference coordinates.
    weights   : (nAtoms,) fit weights (e.g. occupancies/masses) or None.

    Returns q (nFrames, 4) such that rotating the *reference* by q gives
    the best fit to each frame (the same convention as the PLUMED
    QUATERNION colvar: the orientation of the frame relative to the
    reference).  Quaternions are double-cover reduced and sign-continuous
    along the trajectory.
    """
    frames = jnp.asarray(frames)
    reference = jnp.asarray(reference)
    if weights is None:
        weights = jnp.ones(reference.shape[0], dtype=frames.dtype)
    weights = weights / jnp.sum(weights)

    ref_c = reference - jnp.sum(weights[:, None] * reference, axis=0)
    frm_c = frames - jnp.sum(weights[None, :, None] * frames, axis=1, keepdims=True)

    # S_f = sum_a w_a ref_a (x) frm_fa : (nFrames, 3, 3)
    S = jnp.einsum("a,ai,faj->fij", weights, ref_c, frm_c,
                  precision=jax.lax.Precision.HIGHEST)
    return _quats_from_S(S, continuous=True)


@jax.jit
def superpose(frames, reference, fit_weights=None):
    """Least-squares superpose all frames onto the reference (the
    mdtraj ``center_coordinates`` + ``superpose`` step,
    calculate-Ct-from-traj.py:433,466-467).

    Returns the rotated+centred coordinates (nFrames, nAtoms, 3): each
    frame is centred on its fit-weight centroid and rotated so the fit
    atoms best match the centred reference.
    """
    frames = jnp.asarray(frames)
    reference = jnp.asarray(reference)
    q = orientation_quats(frames, reference, fit_weights)
    if fit_weights is None:
        w = jnp.ones(reference.shape[0], dtype=frames.dtype)
    else:
        w = jnp.asarray(fit_weights)
    w = w / jnp.sum(w)
    frm_c = frames - jnp.sum(w[None, :, None] * frames, axis=1, keepdims=True)
    # q rotates the reference onto the frame; to bring the frame onto the
    # reference, apply the conjugate.
    return qt.rotate_vector(frm_c, qt.qconj(q)[:, None, :])


class BondVectors(NamedTuple):
    raw: jnp.ndarray  # (nFrames, nBonds, 3) lab-frame unit vectors
    fitted: jnp.ndarray  # (nFrames, nBonds, 3) after superposition


@partial(jax.jit, static_argnames=())
def bond_vectors(frames, reference, idx_h, idx_x, fit_weights=None):
    """Extract normalised X-H bond vectors pre- and post-fit
    (obtain_XHvecs, calculate-Ct-from-traj.py:64-86).

    idx_h / idx_x : (nBonds,) atom indices of H and X partners.
    """
    frames = jnp.asarray(frames)
    raw = frames[:, idx_h, :] - frames[:, idx_x, :]
    raw = qt.vecnorm(raw)
    # Rotation is linear and translation cancels in differences, so only
    # the nBonds difference vectors need rotating — not all nAtoms via a
    # full superpose (the streamed C(t) hot path; ~10x less rotation work
    # for a solvated system, bit-equivalent results).
    q = orientation_quats(frames, reference, fit_weights)
    fitted = qt.vecnorm(qt.rotate_vector(raw, qt.qconj(q)[:, None, :]))
    return BondVectors(raw, fitted)


def bond_obs_matrix(reference, fit_weights=None):
    """The (3, nAtoms) f64 weighted-centred reference correlation matrix
    A with S_f = A @ frame — the single home of the reduction both
    :func:`bond_obs_host` (numpy slabs) and the fused native ingest
    (io.native.iter_xtc_obs; reduction inside the decoder) apply.
    A's weighted columns sum to zero, so A @ frame is translation-
    invariant without per-frame centring."""
    import numpy as np

    reference = np.asarray(reference, dtype=np.float64)
    if fit_weights is None:
        w = np.ones(reference.shape[0])
    else:
        w = np.asarray(fit_weights, dtype=np.float64)
    w = w / w.sum()
    ref_c = reference - (w[:, None] * reference).sum(0)
    return (w[:, None] * ref_c).T


def bond_obs_host(xyz, reference, idx_h, idx_x, fit_weights=None,
                  frame_slab_bytes=1 << 23):
    """Host-side sufficient statistics for :func:`bond_vectors_from_obs`.

    The per-frame Kabsch/Horn fit consumes the coordinates ONLY through
    the 3x3 correlation S (see :func:`orientation_quats`), and the bond
    vectors are translation-invariant coordinate differences — so a
    file-fed chunk never needs to ship its full (nFrames, nAtoms, 3)
    coordinate block to the device.  This reduction is the whole
    host->device contract of the streamed C(t) stages: nAtoms/nBonds-fold
    less transfer (~17x for the reference's ubiquitin system).

    Returns (raw_diff (F, nBonds, 3), S (F, 3, 3)), both in the CANONICAL
    dtype of ``xyz`` — i.e. exactly what ``jnp.asarray(xyz)`` would use
    on device (f64 input under x64 stays f64: the mesh-parity tests rely
    on f64 C(t) sitting 8 digits below printed precision).  S is
    accumulated in float64 slabs (``frame_slab_bytes`` bounds the f64
    temporary) — tighter than the device's f32-HIGHEST einsum.
    """
    import numpy as np

    xyz = np.asarray(xyz)
    out_dtype = jax.dtypes.canonicalize_dtype(
        np.result_type(xyz.dtype, np.float32)
    )
    A = bond_obs_matrix(reference, fit_weights)
    if xyz.dtype == np.float32:
        # f32 chunks (every binary trajectory codec) reduce through the
        # NATIVE per-frame loop — the same code the fused .xtc ingest
        # runs inside the decoder, so host-reduced and decoder-reduced
        # observables are BIT-identical (numpy's BLAS dgemm sums S in a
        # different f64 order, flipping occasional f32-cast ulps).
        from ..io import native as natio

        out = natio.reduce_obs_mem(xyz, idx_h, idx_x, A)
        if out is not None:
            raw_diff, S64 = out
            return raw_diff, S64.astype(out_dtype)

    raw_diff = (xyz[:, idx_h, :] - xyz[:, idx_x, :]).astype(
        out_dtype, copy=False
    )
    n_frames, n_atoms = xyz.shape[:2]
    slab = max(1, int(frame_slab_bytes // (n_atoms * 3 * 8)))
    S = np.empty((n_frames, 3, 3), dtype=out_dtype)
    for lo in range(0, n_frames, slab):
        x = xyz[lo : lo + slab].astype(np.float64, copy=False)
        # No per-frame COM subtraction: A's weighted columns sum to zero
        # (ref_c is weighted-centred), so A @ (x - com) == A @ x exactly —
        # translation invariance is built into A.  Skipping the centring
        # pass avoids a second (slab, nAtoms, 3) f64 temporary; with the
        # default 8 MB slab the BLAS temporaries stay arena-resident
        # (fresh large numpy buffers pay a page fault per page).
        S[lo : lo + slab] = A @ x
    return raw_diff, S


@jax.jit
def bond_vectors_from_obs(raw_diff, S):
    """Device half of the split :func:`bond_vectors`: normalised raw and
    superposed bond vectors from the host-reduced observables of
    :func:`bond_obs_host`.  Identical convention to ``bond_vectors`` —
    Horn quaternion from S, conjugate rotation of the difference vectors
    (calculate-Ct-from-traj.py:64-86,466-467).  The sign-continuity scan
    is skipped: rotate_vector is invariant under q -> -q, so continuity
    only matters when the quaternions themselves are exposed."""
    raw = qt.vecnorm(jnp.asarray(raw_diff))
    q = _quats_from_S(jnp.asarray(S), continuous=False)
    fitted = qt.vecnorm(qt.rotate_vector(raw, qt.qconj(q)[:, None, :]))
    return BondVectors(raw, fitted)
