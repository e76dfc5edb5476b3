"""iRED / wiRED order parameters (Gu, Li & Brueschweiler, JCTC 2014).

The reference ships only empty stubs for these
(calculate-Ct-from-traj.py:156-180); this module provides working,
batched implementations.

isotropic Reorientational Eigenmode Dynamics (iRED):
  1. M_ij = < P2( v_i(t) . v_j(t) ) >  over a time window.
  2. Eigendecompose M (symmetric, nRes x nRes).
  3. The 5 largest-eigenvalue modes describe collective reorientation
     (the rank-2 global tumbling subspace); the remainder are internal.
  4. S2_i = 1 - sum_{k internal} lambda_k |psi_k,i|^2.

Window lengths: iRED averages over blocks of ~5*tau_c, wiRED over ~2*tau_c
(reference stub comments :156-180).  Per-block S2 estimates give a mean
and SEM, mirroring the Palmer block statistics convention.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class IredResult(NamedTuple):
    S2: jnp.ndarray  # (nRes,) mean over blocks
    dS2: jnp.ndarray  # (nRes,) SEM over blocks (sqrt(n)-1 convention)
    eigenvalues: jnp.ndarray  # (nBlocks, nRes) descending
    modes: jnp.ndarray  # (nBlocks, nRes, nRes) eigenvectors (columns)


def _ired_matrix(vecs):
    """M_ij = < P2(v_i . v_j) > over the frame axis.

    vecs : (nFrames, nRes, 3) unit vectors.

    Identity: (v_i . v_j)^2 = Q_i . Q_j with Q_i = vec(v_i v_i^T) (9
    components), so the frame average collapses to ONE matmul over
    the (T*9) axis — O(T * nRes * 9) memory instead of materialising the
    (T, nRes, nRes) dot tensor (0.5 GB/block at 250 res x 1000 frames)."""
    T = vecs.shape[0]
    Q = vecs[:, :, :, None] * vecs[:, :, None, :]  # (T, nRes, 3, 3)
    Q = Q.reshape(T, vecs.shape[1], 9)
    return (1.5 / T) * jnp.einsum(
        "tic,tjc->ij", Q, Q, precision=jax.lax.Precision.HIGHEST
    ) - 0.5


def _eig_s2(M, n_global: int):
    """Eigendecompose one block matrix -> (s2, vals desc, modes desc)."""
    vals, vecs_e = jnp.linalg.eigh(M)  # ascending
    n_res = M.shape[0]
    if n_res <= n_global:
        # vals[: n_res - n_global] would be a NEGATIVE slice, silently
        # misclassifying the smallest modes as internal; with every mode
        # global there is no internal relaxation at all.
        raise ValueError(
            f"iRED needs more residues ({n_res}) than global modes "
            f"({n_global}) to separate internal motion"
        )
    # Internal modes: all but the n_global largest.
    lam_int = vals[: n_res - n_global]
    psi_int = vecs_e[:, : n_res - n_global]  # (nRes, nInternal)
    s2 = 1.0 - jnp.sum(lam_int[None, :] * psi_int**2, axis=1)
    return s2, vals[::-1], vecs_e[:, ::-1]


@partial(jax.jit, static_argnames=("n_global",))
def ired_block_s2(vecs, n_global: int = 5):
    """S2 from one time block. vecs (nFrames, nRes, 3)."""
    return _eig_s2(_ired_matrix(vecs), n_global)


def calculate_s2_ired(
    vecs, delta_t: float, tau: float, window_factor: float = 5.0, n_global: int = 5
) -> IredResult:
    """iRED S2 with block statistics.

    vecs : (nFrames, nRes, 3) lab-frame unit vectors (NOT superposed —
        iRED separates global from internal motion spectrally).
    tau  : isotropic tumbling time estimate; block length =
        window_factor * tau (5 for iRED, 2 for wiRED).
    """
    vecs = jnp.asarray(vecs)
    n_frames, n_res = vecs.shape[0], vecs.shape[1]
    n_per_block = max(int(window_factor * tau / delta_t), 2)
    n_blocks = n_frames // n_per_block
    if n_blocks < 1:
        raise ValueError(
            f"trajectory too short: {n_frames} frames < one window of "
            f"{n_per_block}"
        )
    v = vecs[: n_blocks * n_per_block].reshape(n_blocks, n_per_block, n_res, 3)
    s2, vals, modes = jax.vmap(lambda x: ired_block_s2(x, n_global=n_global))(v)
    S2 = jnp.mean(s2, axis=0)
    denom = jnp.sqrt(jnp.asarray(float(n_blocks), vecs.dtype)) - 1.0
    # n_blocks == 1 -> NaN, matching the repo-wide Palmer block-stats
    # convention (core.stats.palmer_pooled_stats): a single block has no
    # spread estimate, and a silent 0.0 would give that S2 infinite
    # weight in any chi-square.
    dS2 = jnp.where(
        denom > 0,
        jnp.std(s2, axis=0) / jnp.where(denom > 0, denom, 1.0),
        jnp.nan,
    )
    return IredResult(S2, dS2, vals, modes)


def calculate_s2_wired(vecs, delta_t: float, tau: float, n_global: int = 5) -> IredResult:
    """windowed iRED: 2*tau windows (reference stub :156-167)."""
    return calculate_s2_ired(vecs, delta_t, tau, window_factor=2.0, n_global=n_global)


@jax.jit
def _q_sum_update(acc, seg):
    """acc += sum_t Q_t Q_t^T for one zero-padded segment (P, nRes, 3).

    Zero-padded frames contribute exactly zero (Q of the zero vector is
    zero), so every update can run at ONE fixed shape regardless of
    where block boundaries fall."""
    P = seg.shape[0]
    Q = (seg[:, :, :, None] * seg[:, :, None, :]).reshape(P, seg.shape[1], 9)
    return acc + jnp.einsum(
        "tic,tjc->ij", Q, Q, precision=jax.lax.Precision.HIGHEST
    )


@partial(jax.jit, static_argnames=("n_global",))
def _block_finish(acc, n_per_block: float, n_global: int):
    s2, vals, modes = _eig_s2((1.5 / n_per_block) * acc - 0.5, n_global)
    return s2, vals, modes


class IredStream:
    """Streaming iRED/wiRED: per-block M accumulation over chunked
    lab-frame vector streams (constant memory in the frame axis).

    The in-memory path (:func:`calculate_s2_ired`) slices the trajectory
    into nFrames // W whole blocks of W frames and eigendecomposes each
    block's M_ij = <P2(v_i . v_j)>.  This class accumulates the same
    per-block sum incrementally — an (nRes, nRes) running Q-outer-product
    accumulator, finished with one eigh per completed block — so the
    streamed C(t) stage (>HBM trajectories) gets iRED eigenmode S2 too,
    closing the round-3 capability cliff (``--S2mode ired/wired``
    previously required the in-memory path).  Matches the in-memory
    result to float tolerance (the only difference is summation order).

    Trailing frames short of a full block are dropped, exactly like the
    in-memory ``n_frames // W``.  ``keep_modes=False`` (default) drops
    the (nBlocks, nRes, nRes) eigenvector stacks — unbounded over a long
    stream — and returns an empty modes array.
    """

    def __init__(self, n_res: int, n_per_block: int, n_global: int = 5,
                 keep_modes: bool = False):
        if n_per_block < 2:
            raise ValueError(f"block length must be >= 2, got {n_per_block}")
        self.n_res = int(n_res)
        self.W = int(n_per_block)
        self.n_global = int(n_global)
        self.keep_modes = keep_modes
        self._acc = None  # lazily dtyped from the first chunk
        self._in_block = 0
        self._pad = None  # fixed segment shape (first update's length)
        self._s2 = []
        self._vals = []
        self._modes = []

    def update(self, vecs):
        """Feed (c, nRes, 3) lab-frame vectors (any chunk length)."""
        vecs = jnp.asarray(vecs)
        c = vecs.shape[0]
        if self._pad is None:
            # Segment shape = min(first chunk, block length): a segment
            # never exceeds W frames (the take below), so padding to the
            # full chunk length would zero-pad every W-frame slice of a
            # multi-block chunk to the whole group — ~chunk/W x wasted
            # einsum FLOPs on exactly the >HBM streams this class is for.
            self._pad = max(min(int(c), self.W), 1)
        if self._acc is None:
            self._acc = jnp.zeros((self.n_res, self.n_res), vecs.dtype)
        off = 0
        while off < c:
            take = min(self.W - self._in_block, c - off, self._pad)
            seg = vecs[off : off + take]
            if take < self._pad:
                seg = jnp.concatenate(
                    [seg, jnp.zeros((self._pad - take,) + seg.shape[1:],
                                    seg.dtype)], axis=0
                )
            self._acc = _q_sum_update(self._acc, seg)
            self._in_block += take
            off += take
            if self._in_block == self.W:
                s2, vals, modes = _block_finish(
                    self._acc, float(self.W), self.n_global
                )
                self._s2.append(s2)
                self._vals.append(vals)
                if self.keep_modes:
                    self._modes.append(modes)
                self._acc = jnp.zeros_like(self._acc)
                self._in_block = 0

    def result(self) -> IredResult:
        """Block statistics, identical conventions to calculate_s2_ired
        (sqrt(nBlocks)-1 SEM; single block -> NaN dS2)."""
        n_blocks = len(self._s2)
        if n_blocks < 1:
            raise ValueError(
                f"stream too short: no complete iRED window of "
                f"{self.W} frames"
            )
        s2 = jnp.stack(self._s2)
        vals = jnp.stack(self._vals)
        S2 = jnp.mean(s2, axis=0)
        denom = jnp.sqrt(jnp.asarray(float(n_blocks), s2.dtype)) - 1.0
        dS2 = jnp.where(
            denom > 0,
            jnp.std(s2, axis=0) / jnp.where(denom > 0, denom, 1.0),
            jnp.nan,
        )
        modes = (
            jnp.stack(self._modes) if self._modes
            else jnp.zeros((0, self.n_res, self.n_res), s2.dtype)
        )
        return IredResult(S2, dS2, vals, modes)
