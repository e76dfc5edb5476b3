"""Delta-q rotational-diffusion statistics: q(t) -> D tensor + PAF.

Accelerator-native replacement for ``calculate-dq-distribution.py``'s main loop
(:554-650), which computes, for each lag delta on a grid:

    dq(t) = reduce( q^-1(t) * q(t+delta) )          [vectorised quat ops]
    iso(delta)  = < 1 - 2|dq_v|^2 >                 [= <cos theta>]
    M(delta)    = < dq_v (x) dq_v >                 [3x3 'MoI' tensor]

then eigendecomposes M, locks the principal-axis frame (PAF) quaternion at
the FIRST lag, and fits single exponentials per axis to obtain D.

Key idiomatic shifts vs the reference:
- all lags are evaluated in one jitted, lag-vmapped pass with masking
  (no Python loop over ~100 lags);
- the 'rotated' tensor is obtained algebraically as R M R^T instead of
  re-averaging rotated vectors (a second pass over all data in the
  reference, :565-607);
- the scalar Powell exponential fit (:152-207, a per-point Python loop)
  becomes a vectorised Gauss-Newton on all (axis, chunk) series at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# The M-tensor contractions run over up to 10^6 frames: a reduced-precision
# f32 einsum (TF32) loses ~1e-3 there — pin exact.
_HI = jax.lax.Precision.HIGHEST
import numpy as np

from ..core import quaternion as qt

# Frame-axis sums run in two levels: within blocks of this many frames,
# then over the per-block partials.  One f32 sweep over 10^6 frames
# loses ~5e-4 relative on M (the per-frame vectors themselves are good
# to ~1e-9); blocked, the rounding is bounded by the block length.
_FRAME_BLOCK = 1024


def _frame_sum(spec: str, *xs):
    """``jnp.einsum(spec, *xs)`` for a spec whose operands all lead with
    the frame axis ``i`` and whose output drops it, summed blockwise."""
    n = xs[0].shape[0]
    nb = -(-n // _FRAME_BLOCK)
    blocks = [
        jnp.pad(x, [(0, nb * _FRAME_BLOCK - n)] + [(0, 0)] * (x.ndim - 1))
        .reshape((nb, _FRAME_BLOCK) + x.shape[1:])
        for x in xs
    ]
    ins, out = spec.split("->")
    spec_b = ",".join("z" + s for s in ins.split(",")) + "->z" + out
    return jnp.sum(jnp.einsum(spec_b, *blocks, precision=_HI), axis=0)


class DqStats(NamedTuple):
    lag_frames: jnp.ndarray  # (L,) integer lags in frames
    iso: jnp.ndarray  # (L,) <1 - 2|v|^2>
    M: jnp.ndarray  # (L, 3, 3) <v (x) v>
    iso_chunks: jnp.ndarray  # (L, nChunk) or empty
    M_chunks: jnp.ndarray  # (L, nChunk, 3, 3) or empty


def _dq_vectors(q, delta, n_data):
    """v-part of reduce(q^-1(t) q(t+delta)) for all t, masked beyond
    n_data - delta.  q: (N, 4); returns (N, 3), mask (N,)."""
    n = q.shape[0]
    q_inv = qt.qconj(q)
    q_shift = jnp.roll(q, -delta, axis=0)
    dq = qt.qreduce(qt.qmult(q_inv, q_shift))
    idx = jnp.arange(n)
    mask = (idx < (n_data - delta)).astype(q.dtype)
    return dq[..., 1:4] * mask[:, None], mask


def _np_dq_pairs(qa, qb) -> np.ndarray:
    """reduce(qa^-1 * qb).v in plain numpy — shared by the in-memory and
    streamed histogram paths so their vectors are BITWISE equal (XLA
    compiles the same elementwise chain differently for different shapes,
    perturbing the last ulp, which can flip a histogram bin)."""
    w1, x1, y1, z1 = qa[:, 0], -qa[:, 1], -qa[:, 2], -qa[:, 3]
    w2, x2, y2, z2 = qb[:, 0], qb[:, 1], qb[:, 2], qb[:, 3]
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    v = np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    )
    return v * np.where(w >= 0, 1.0, -1.0)[:, None]


def dq_vectors(q, delta: int) -> np.ndarray:
    """Host-facing helper: the valid delta-q vector parts for one lag
    (used for the 3D histogram output, calculate-dq-distribution.py:632-647).
    """
    q = np.asarray(q, dtype=np.float64)
    return _np_dq_pairs(q[: q.shape[0] - delta], q[delta:])


@partial(jax.jit, static_argnames=("n_chunks",))
def dq_statistics(q, lag_frames, n_chunks: int = 0) -> DqStats:
    """Compute iso decay and anisotropy tensors for all lags at once.

    q          : (N, 4) orientation quaternions (unit).
    lag_frames : (L,) int32 lags (frames).
    n_chunks   : if >0, also return per-subchunk statistics for
                 uncertainty estimation
                 (calculate-dq-distribution.py:128-144,613-630).
    """
    q = jnp.asarray(q)
    n = q.shape[0]
    lag_frames = jnp.asarray(lag_frames)

    def per_lag(delta):
        v, mask = _dq_vectors(q, delta, n)
        cnt = jnp.sum(mask)
        v2 = jnp.sum(v * v, axis=-1)
        iso = _frame_sum("i,i->", 1.0 - 2.0 * v2, mask) / cnt
        M = _frame_sum("ij,ik->jk", v, v) / cnt
        if n_chunks > 0:
            # Reference chunking: nblock = ceil(ndat/nchunk) over the
            # *valid* length ndat = n - delta (:128-144).  Chunk membership
            # idx // nblock over the fixed-length array with mask-derived
            # counts reproduces that blocking EXACTLY: valid indices
            # (idx < ndat) satisfy idx // nblock <= n_chunks - 1, and each
            # chunk mean divides by the masked count, matching the
            # reference's mean over [nblock*i, min(ndat, nblock*(i+1))).
            # (When ndat < nblock*i a chunk is empty; the reference takes
            # np.mean of an empty slice -> NaN, and the masked 0/0 here
            # yields the same NaN.)
            ndat = n - delta
            nblock = jnp.ceil(ndat / n_chunks).astype(jnp.int32)
            idx = jnp.arange(n)
            chunk_id = jnp.clip(idx // jnp.maximum(nblock, 1), 0, n_chunks - 1)
            one_hot = (chunk_id[:, None] == jnp.arange(n_chunks)[None, :]).astype(q.dtype)
            w = one_hot * mask[:, None]  # (N, nChunk)
            cnts = jnp.sum(w, axis=0)
            iso_c = _frame_sum("i,ic->c", 1.0 - 2.0 * v2, w) / cnts
            M_c = _frame_sum("ij,ik,ic->cjk", v, v, w) / cnts[:, None, None]
            return iso, M, iso_c, M_c
        zero_i = jnp.zeros((0,), q.dtype)
        zero_m = jnp.zeros((0, 3, 3), q.dtype)
        return iso, M, zero_i, zero_m

    iso, M, iso_c, M_c = jax.vmap(per_lag)(lag_frames)
    return DqStats(lag_frames, iso, M, iso_c, M_c)


class DqFrame(NamedTuple):
    q_frame: jnp.ndarray  # (4,) PAF quaternion (locked at first lag)
    eigvals: jnp.ndarray  # (L, 3) eigenvalues per lag
    aniso_decay: jnp.ndarray  # (L, 3): 1 - 2 * diag(R M R^T) per lag
    aniso_chunks: jnp.ndarray  # (L, nChunk, 3) or empty
    q_per_lag: jnp.ndarray  # (L, 4) per-lag PAF quaternions
    axes_per_lag: jnp.ndarray  # (L, 3, 3) eigenvector rows per lag


def principal_frame(stats: DqStats) -> DqFrame:
    """Diagonalise M per lag, lock the PAF at the first lag, and project
    every lag's tensor into that frame algebraically
    (calculate-dq-distribution.py:575-611)."""
    eigvals, eigvecs = jnp.linalg.eigh(stats.M)  # vecs columns
    axes = jnp.swapaxes(eigvecs, -1, -2)  # rows = axes
    q_all = qt.frame_transform_min(axes)  # (L, 4)
    q_frame = q_all[0]
    R = qt.quat_to_mat(q_frame)  # rotation applied to vectors
    # <(Rv)(Rv)^T> = R M R^T
    MR = jnp.einsum("ab,lbc,dc->lad", R, stats.M, R, precision=_HI)
    aniso = 1.0 - 2.0 * jnp.stack([MR[:, 0, 0], MR[:, 1, 1], MR[:, 2, 2]], axis=-1)
    if stats.M_chunks.size:
        MRc = jnp.einsum("ab,lcbe,de->lcad", R, stats.M_chunks, R, precision=_HI)
        aniso_c = 1.0 - 2.0 * jnp.stack(
            [MRc[..., 0, 0], MRc[..., 1, 1], MRc[..., 2, 2]], axis=-1
        )
    else:
        aniso_c = jnp.zeros((stats.M.shape[0], 0, 3), stats.M.dtype)
    return DqFrame(q_frame, eigvals, aniso, aniso_c, q_all, axes)


# ---------------------------------------------------------------------------
# Exponential decay fits: y = C0 exp(-x/A) + C1, solve for A > 0
# (replaces conduct_exponential_fit + powell_expdecay,
# calculate-dq-distribution.py:152-207)
# ---------------------------------------------------------------------------


def _expdecay_guess(x, y, c1):
    """Two-point initial guess (calculate-dq-distribution.py:195-196)."""
    ratio = (y[1] - c1) / (y[0] - c1)
    safe = jnp.where(ratio > 0, ratio, 0.5)
    return (x[0] - x[1]) / jnp.log(safe)


@jax.jit
def fit_exp_decay(x, y, c0, c1, n_iter: int = 60):
    """Vectorised 1-parameter exponential fit by damped Newton on the
    chi-square gradient.  x: (T,); y: (..., T).  Returns tau (...,)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)

    def chi2(logA, yv):
        A = jnp.exp(logA)
        model = c0 * jnp.exp(-x / A) + c1
        return jnp.mean((model - yv) ** 2)

    dchi = jax.grad(chi2)
    d2chi = jax.grad(lambda la, yv: dchi(la, yv))

    def fit_one(yv):
        la0 = jnp.log(jnp.clip(_expdecay_guess(x, yv, c1), x[0] * 1e-3, x[-1] * 1e3))

        def body(i, la):
            g = dchi(la, yv)
            h = d2chi(la, yv)
            step = jnp.where(jnp.abs(h) > 1e-30, g / h, 0.0)
            # Damped Newton with fallback to gradient descent direction.
            step = jnp.where((h > 0) & jnp.isfinite(step), step, jnp.sign(g) * 0.1)
            step = jnp.clip(step, -0.5, 0.5)
            la_new = la - step
            better = chi2(la_new, yv) <= chi2(la, yv)
            return jnp.where(better, la_new, la - 0.1 * jnp.clip(g, -1, 1))

        la = jax.lax.fori_loop(0, n_iter, body, la0)
        return jnp.exp(la)

    flat = y.reshape(-1, y.shape[-1])
    taus = jax.vmap(fit_one)(flat)
    return taus.reshape(y.shape[:-1])


def isotropic_decay(x, tau):
    """1.5 exp(-x/tau) - 0.5 (calculate-dq-distribution.py:146-147)."""
    return 1.5 * jnp.exp(-x / tau) - 0.5


def anisotropic_decay(x, tau):
    """0.5 exp(-x/tau) + 0.5 (calculate-dq-distribution.py:149-150)."""
    return 0.5 * jnp.exp(-x / tau) + 0.5


def tau_to_D(tau_ps):
    """D [s^-1] = 0.5e12 / tau[ps] (calculate-dq-distribution.py:230)."""
    return 0.5e12 / tau_ps


# ---------------------------------------------------------------------------
# Anisotropy conversions (calculate-dq-distribution.py:30-91)
# ---------------------------------------------------------------------------


def aniso_of(D):
    return 2 * D[..., 2] / (D[..., 1] + D[..., 0])


def rhomb_of(D):
    return 3 * (D[..., 1] - D[..., 0]) / (2 * D[..., 2] - D[..., 1] - D[..., 0])


def calculate_anisotropies(D):
    """(Diso, aniL, rhomL, aniS, rhomS) from sorted Dx<=Dy<=Dz."""
    D = jnp.asarray(D)
    Drev = D[..., ::-1]
    return (
        jnp.mean(D, axis=-1),
        aniso_of(D),
        rhomb_of(D),
        aniso_of(Drev),
        rhomb_of(Drev),
    )


# ---------------------------------------------------------------------------
# High-level driver
# ---------------------------------------------------------------------------


class DqResult(NamedTuple):
    lag_times: np.ndarray
    iso: np.ndarray
    iso_tau: float
    iso_tau_chunks: np.ndarray
    aniso: np.ndarray  # (3, L)
    aniso_taus: np.ndarray  # (3,)
    aniso_tau_chunks: np.ndarray  # (nChunk, 3)
    aniso_chunks: np.ndarray  # (nChunk, 3, L)
    iso_chunks: np.ndarray  # (nChunk, L)
    q_frame: np.ndarray
    q_per_lag: np.ndarray
    axes_per_lag: np.ndarray
    D_iso: float
    D_axes: np.ndarray  # (3,) in s^-1
    anisotropies: tuple  # (Diso, aniL, rhomL, aniS, rhomS) of D_axes
    M: Optional[np.ndarray] = None  # (L, 3, 3) raw <v v^T> per lag
    hist: Optional[np.ndarray] = None  # (L, B, B, B) per-lag dq histograms
    # (density-normalised like np.histogramdd(density=True) over (-1,1)^3;
    # populated only by the streamed path when hist_bins > 0 — the
    # in-memory stage computes histograms directly from dq_vectors)
    anis_chunk_samples: Optional[np.ndarray] = None  # (nChunk, 5) per-chunk
    # (Diso, aniL, rhomL, aniS, rhomS) in the MAIN fit's axis order
    iso_models: Optional[np.ndarray] = None  # (1+nChunk, L) fitted curves
    aniso_models: Optional[np.ndarray] = None  # (1+nChunk, 3, L)


def _lag_grid(delta_t: float, min_dt: float, max_dt: float, skip_dt: float,
              n: Optional[int] = None, what: str = "trajectory") -> np.ndarray:
    """The reference's lag-grid construction (:509-523), shared by every
    analyse_dq* entry point: lags from max(skip, min) to max in steps of
    skip (frames).  ``n`` (frame count) enables the half-length check;
    pass None when the stream length is only known afterwards."""
    skip_int = max(1, int(skip_dt / delta_t))
    min_int = max(skip_int, int(min_dt / delta_t))
    max_int = int(max_dt / delta_t)
    if n is not None and max_int * delta_t > (n - 1) * delta_t / 2.0:
        raise ValueError(
            f"max_dt ({max_dt}) exceeds half the {what} length "
            f"({(n - 1) * delta_t / 2.0})"
        )
    lags = np.arange(min_int, max_int + 1, skip_int, dtype=np.int32)
    if len(lags) < 2:
        # The exp-decay initial guess reads (x[1], y[1]) — on a 1-point
        # grid JAX would silently clamp the index and produce NaN taus /
        # NaN D with no error (the reference fails loudly with an
        # IndexError at the same spot).
        raise ValueError(
            f"lag grid needs >= 2 points, got {len(lags)}: min_dt={min_dt}, "
            f"max_dt={max_dt}, skip_dt={skip_dt} at delta_t={delta_t}"
        )
    return lags


def analyse_dq_multi(
    q_trajs,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
) -> "DqResult":
    """Multi-replica Delta-q analysis: per-replica dq samples are pooled at
    each lag (the capability of calculate-dq-distribution-multi.py:529-539,
    which as shipped crashes on a missing import — SURVEY §2.7).

    All replicas must have equal length; uncertainty chunks group whole
    replicas (nReplicas % n_chunks == 0, mirroring the reference's
    subchunks-divide-replicas requirement :481-483).
    """
    q_list = [np.asarray(q, dtype=np.float64) for q in q_trajs]
    n_rep = len(q_list)
    n_min = min(q.shape[0] for q in q_list)
    if n_chunks > 0 and n_rep % n_chunks != 0:
        raise ValueError(
            f"n_chunks ({n_chunks}) must divide nReplicas ({n_rep})"
        )
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, n_min,
                     what="shortest replica trajectory")
    lags_j = jnp.asarray(lags)

    # The reference pools the delta-q SAMPLES of all replicas at each lag
    # (calculate-dq-distribution-multi.py:529-539); per-replica means must
    # therefore be recombined weighted by their sample counts n_r - delta,
    # which also handles replicas of unequal length.
    per_rep = [dq_statistics(jnp.asarray(q), lags_j, n_chunks=0) for q in q_list]
    counts = np.stack(
        [q.shape[0] - lags.astype(np.int64) for q in q_list]
    )  # (nRep, L)
    w = jnp.asarray(counts / counts.sum(axis=0, keepdims=True))

    def pool(items, weights):
        stacked = jnp.stack(items)  # (nRep, L, ...)
        wshaped = weights.reshape(weights.shape + (1,) * (stacked.ndim - 2))
        return jnp.sum(stacked * wshaped, axis=0)

    iso = pool([s.iso for s in per_rep], w)
    M = pool([s.M for s in per_rep], w)
    if n_chunks > 0:
        group = n_rep // n_chunks
        iso_cs, M_cs = [], []
        for g in range(n_chunks):
            sel = slice(g * group, (g + 1) * group)
            wg = jnp.asarray(
                counts[sel] / counts[sel].sum(axis=0, keepdims=True)
            )
            iso_cs.append(pool([s.iso for s in per_rep[sel]], wg))
            M_cs.append(pool([s.M for s in per_rep[sel]], wg))
        iso_c = jnp.stack(iso_cs, axis=1)  # (L, nChunk)
        M_c = jnp.stack(M_cs, axis=1)  # (L, nChunk, 3, 3)
    else:
        iso_c = jnp.zeros((len(lags), 0))
        M_c = jnp.zeros((len(lags), 0, 3, 3))
    stats = DqStats(lags_j, iso, M, iso_c, M_c)
    return _finalise_dq(stats, lags, delta_t, n_chunks)


@partial(jax.jit, static_argnames=("n_chunks",))
def _finalise_device(iso, M, iso_c, M_c, x, n_chunks: int):
    """Everything after dq_statistics in ONE compiled program returning
    ONE packed vector: PAF frame, exponential-fit taus (main + chunks,
    batched), anisotropy conversions (main + per-chunk in the main
    order, calculate-dq-distribution.py:230-272) and the fitted model
    curves for the artefact graphs: one dispatch and one fetch where an
    eager finalise would pay ~70 of each."""
    dt = iso.dtype
    L = iso.shape[0]
    # principal frame (principal_frame, kept callable standalone)
    eigvals, eigvecs = jnp.linalg.eigh(M)
    axes = jnp.swapaxes(eigvecs, -1, -2)
    q_all = qt.frame_transform_min(axes)
    q_frame = q_all[0]
    R = qt.quat_to_mat(q_frame)
    MR = jnp.einsum("ab,lbc,dc->lad", R, M, R, precision=_HI)
    aniso = 1.0 - 2.0 * jnp.stack(
        [MR[:, 0, 0], MR[:, 1, 1], MR[:, 2, 2]], axis=-1
    )  # (L, 3)
    if n_chunks > 0:
        MRc = jnp.einsum("ab,lcbe,de->lcad", R, M_c, R, precision=_HI)
        aniso_c = 1.0 - 2.0 * jnp.stack(
            [MRc[..., 0, 0], MRc[..., 1, 1], MRc[..., 2, 2]], axis=-1
        )  # (L, C, 3)
    else:
        aniso_c = jnp.zeros((L, 0, 3), dt)
    # batched exponential fits: row 0 = the full series, rows 1.. chunks
    iso_stack = jnp.concatenate([iso[None, :], iso_c.T], axis=0)
    tau_iso_all = fit_exp_decay(x, iso_stack, 1.5, -0.5)  # (1+C,)
    aniso_stack = jnp.concatenate(
        [aniso.T[None], jnp.moveaxis(aniso_c, 0, -1)], axis=0
    )  # (1+C, 3, L)
    tau_aniso_all = fit_exp_decay(x, aniso_stack, 0.5, 0.5)  # (1+C, 3)
    # anisotropy conversions; chunks use the MAIN fit's axis order
    # (stage header semantics, calculate-dq-distribution.py:241-268)
    D_axes = tau_to_D(tau_aniso_all[0])
    order = jnp.argsort(D_axes)
    anis_main = jnp.stack(calculate_anisotropies(D_axes[order]))  # (5,)
    D_ch = tau_to_D(tau_aniso_all[1:])  # (C, 3)
    anis_ch = jnp.stack(
        calculate_anisotropies(D_ch[:, order]), axis=-1
    )  # (C, 5)
    # fitted model curves for the artefact graphs
    iso_models = isotropic_decay(x[None, :], tau_iso_all[:, None])
    aniso_models = anisotropic_decay(
        x[None, None, :], tau_aniso_all[..., None]
    )  # (1+C, 3, L)
    parts = [iso, M, iso_c, aniso, aniso_c, q_frame, q_all, axes,
             tau_iso_all, tau_aniso_all, anis_main, anis_ch,
             iso_models, aniso_models]
    return jnp.concatenate([p.reshape(-1).astype(dt) for p in parts])


def _finalise_dq(stats: DqStats, lags, delta_t: float, n_chunks: int) -> "DqResult":
    x = np.asarray(lags, dtype=float) * delta_t
    L = len(x)
    C = int(stats.iso_chunks.shape[1]) if stats.iso_chunks.size else 0
    packed = np.asarray(
        _finalise_device(stats.iso, stats.M, stats.iso_chunks,
                         stats.M_chunks, jnp.asarray(x), n_chunks)
    ).astype(np.float64)
    sizes = [L, 9 * L, L * C, 3 * L, 3 * L * C, 4, 4 * L, 9 * L,
             1 + C, 3 * (1 + C), 5, 5 * C, (1 + C) * L, (1 + C) * 3 * L]
    (iso, M, iso_c, aniso, aniso_c, q_frame, q_all, axes,
     tau_iso_all, tau_aniso_all, anis_main, anis_ch,
     iso_models, aniso_models) = np.split(packed, np.cumsum(sizes)[:-1])
    tau_aniso_all = tau_aniso_all.reshape(1 + C, 3)
    return DqResult(
        M=M.reshape(L, 3, 3),
        lag_times=x,
        iso=iso,
        iso_tau=float(tau_iso_all[0]),
        iso_tau_chunks=tau_iso_all[1:],
        aniso=aniso.reshape(L, 3).T,
        aniso_taus=tau_aniso_all[0],
        aniso_tau_chunks=tau_aniso_all[1:],
        aniso_chunks=np.moveaxis(aniso_c.reshape(L, C, 3), 0, -1),
        iso_chunks=iso_c.reshape(L, C).T,
        q_frame=q_frame,
        q_per_lag=q_all.reshape(L, 4),
        axes_per_lag=axes.reshape(L, 3, 3),
        D_iso=float(tau_to_D(tau_iso_all[0])),
        D_axes=tau_to_D(tau_aniso_all[0]),
        anisotropies=tuple(float(v) for v in anis_main),
        anis_chunk_samples=anis_ch.reshape(C, 5),
        iso_models=iso_models.reshape(1 + C, L),
        aniso_models=aniso_models.reshape(1 + C, 3, L),
    )


def analyse_dq(
    q_traj: np.ndarray,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
) -> DqResult:
    """Full Delta-q analysis of one quaternion trajectory.

    Mirrors the lag-grid construction of the reference (:509-523): lags
    from max(skip, min) to max in steps of skip (in frames).
    """
    q_traj = np.asarray(q_traj)
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, q_traj.shape[0])
    stats = dq_statistics(jnp.asarray(q_traj), jnp.asarray(lags), n_chunks=n_chunks)
    return _finalise_dq(stats, lags, delta_t, n_chunks)


# ---------------------------------------------------------------------------
# Streaming Delta-q: constant-memory statistics over chunked q(t) streams
# (capability beyond the reference, which loads the full colvar into RAM,
# calculate-dq-distribution.py:525-536)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("max_lag", "chunk_len", "n_chunks"))
def _dq_chunk_sums(buf, buf_len, chunk, chunk_valid, lags, max_lag: int,
                   chunk_len: int, n_chunks: int = 0, nblock=None,
                   global_start=0):
    """Per-lag partial sums contributed by one chunk of the stream.

    buf   : (max_lag, 4) previous tail, RIGHT-aligned valid region of
            length buf_len (garbage before it is masked out).
    chunk : (chunk_len, 4) new frames, valid prefix of length chunk_valid.

    A pair (t, t+d) is attributed to the chunk containing t+d, so each
    pair is counted exactly once across the stream.

    With n_chunks > 0 the per-lag sums are additionally split over the
    reference's uncertainty sub-chunks (calculate-dq-distribution.py:
    128-144): block id = t // nblock[lag] of the pair's FIRST frame, with
    nblock = ceil((n_total - lag)/n_chunks) precomputed on the host from
    the known total stream length; ``global_start`` is the global frame
    index of chunk[0].

    Returns (s_iso (L,), s_M (L,3,3), cnt (L,), s_iso_c (L,C),
    s_M_c (L,C,3,3), cnt_c (L,C), new_buf, new_buf_len).
    """
    ext = jnp.concatenate([buf, chunk], axis=0)
    idx = jnp.arange(max_lag + chunk_len)
    q_inv = qt.qconj(ext)
    if nblock is None:
        nblock = jnp.zeros_like(lags)

    def per_lag(d, nb):
        v = qt.qreduce(qt.qmult(q_inv, jnp.roll(ext, -d, axis=0)))[..., 1:4]
        lo = jnp.maximum(max_lag - buf_len, max_lag - d)
        hi = max_lag + chunk_valid - d
        m = ((idx >= lo) & (idx < hi)).astype(ext.dtype)
        v2 = jnp.sum(v * v, axis=-1)
        s_iso = _frame_sum("i,i->", 1.0 - 2.0 * v2, m)
        s_M = _frame_sum("ij,ik,i->jk", v, v, m)
        if n_chunks > 0:
            t_glob = global_start - max_lag + idx
            cid = jnp.clip(t_glob // jnp.maximum(nb, 1), 0, n_chunks - 1)
            oh = (cid[:, None] == jnp.arange(n_chunks)[None, :]).astype(
                ext.dtype
            ) * m[:, None]
            s_iso_c = _frame_sum("i,ic->c", 1.0 - 2.0 * v2, oh)
            s_M_c = _frame_sum("ij,ik,ic->cjk", v, v, oh)
            cnt_c = jnp.sum(oh, axis=0)
        else:
            s_iso_c = jnp.zeros((0,), ext.dtype)
            s_M_c = jnp.zeros((0, 3, 3), ext.dtype)
            cnt_c = jnp.zeros((0,), ext.dtype)
        return s_iso, s_M, jnp.sum(m), s_iso_c, s_M_c, cnt_c

    s_iso, s_M, cnt, s_iso_c, s_M_c, cnt_c = jax.vmap(per_lag)(lags, nblock)
    # New tail = last max_lag valid frames of ext: valid region ends at
    # max_lag + chunk_valid, so the tail slice starts at chunk_valid.
    new_buf = jax.lax.dynamic_slice(ext, (chunk_valid, 0), (max_lag, 4))
    new_buf_len = jnp.minimum(max_lag, buf_len + chunk_valid)
    return s_iso, s_M, cnt, s_iso_c, s_M_c, cnt_c, new_buf, new_buf_len




def dq_statistics_streamed(chunk_iter, lags, chunk_len: int,
                           n_chunks: int = 0, n_total: Optional[int] = None,
                           hist_bins: int = 0) -> tuple:
    """Accumulate DqStats over an iterator of (n, 4) quaternion chunks
    without ever materialising the full trajectory.  Exact: matches
    dq_statistics on the concatenated stream to float tolerance.

    n_chunks > 0 additionally accumulates the reference's per-sub-chunk
    statistics for uncertainty estimation
    (calculate-dq-distribution.py:128-144,613-630); this requires the
    total stream length ``n_total`` up front (the reference knows it
    because it loads everything; a streaming caller counts frames with
    one cheap pre-pass).

    hist_bins > 0 accumulates per-lag 3D histogram COUNTS of the delta-q
    vectors over (-1, 1)^3 (the stage's -hist output, :632-647); the
    vectors are bitwise identical to the in-memory path's, so the counts
    match np.histogramdd exactly.

    Returns (DqStats, total_frames, hist_counts or None)."""
    lags = np.asarray(lags, dtype=np.int32)
    L = len(lags)
    max_lag = int(lags.max())
    lags_j = jnp.asarray(lags)
    buf = jnp.zeros((max_lag, 4))
    buf_len = jnp.asarray(0)
    s_iso = jnp.zeros((L,))
    s_M = jnp.zeros((L, 3, 3))
    cnt = jnp.zeros((L,))
    if n_chunks > 0:
        if n_total is None:
            raise ValueError(
                "streamed sub-chunk uncertainties need n_total (count the "
                "stream first)"
            )
        nblock_j = jnp.asarray(
            np.ceil((n_total - lags.astype(np.int64)) / n_chunks).astype(
                np.int64
            )
        )
        s_iso_c = jnp.zeros((L, n_chunks))
        s_M_c = jnp.zeros((L, n_chunks, 3, 3))
        cnt_c = jnp.zeros((L, n_chunks))
    else:
        nblock_j = None
    hist = (
        np.zeros((L, hist_bins, hist_bins, hist_bins), dtype=np.int64)
        if hist_bins > 0 else None
    )
    # Host-side tail mirror for the histogram path: the per-pair vectors
    # are computed with the SAME numpy elementwise chain as the in-memory
    # dq_vectors, so the accumulated counts are bitwise identical.
    np_tail = np.zeros((0, 4))
    total = 0
    global_pos = 0
    for chunk in chunk_iter:
        chunk = np.asarray(chunk, dtype=np.float64)
        total += chunk.shape[0]
        for off in range(0, chunk.shape[0], chunk_len):
            part = chunk[off : off + chunk_len]
            nv = part.shape[0]
            if hist is not None:
                B = np_tail.shape[0]
                ext_np = np.concatenate([np_tail, part], axis=0)
                for i, d in enumerate(lags):
                    lo = max(0, B - int(d))
                    hi = B + nv - int(d)
                    if hi <= lo:
                        continue
                    vv = _np_dq_pairs(
                        ext_np[lo:hi], ext_np[lo + int(d) : hi + int(d)]
                    )
                    h, _ = np.histogramdd(
                        vv, bins=(hist_bins,) * 3, range=((-1, 1),) * 3
                    )
                    hist[i] += h.astype(np.int64)
                np_tail = ext_np[-max_lag:]
            out = _padded_chunk_sums(
                buf, buf_len, part, lags_j, max_lag, chunk_len,
                n_chunks=n_chunks, nblock=nblock_j,
                global_start=jnp.asarray(global_pos),
            )
            d_iso, d_M, d_cnt, d_iso_c, d_M_c, d_cnt_c, buf, buf_len = out
            s_iso = s_iso + d_iso
            s_M = s_M + d_M
            cnt = cnt + d_cnt
            if n_chunks > 0:
                s_iso_c = s_iso_c + d_iso_c
                s_M_c = s_M_c + d_M_c
                cnt_c = cnt_c + d_cnt_c
            global_pos += nv
    if n_chunks > 0 and total != n_total:
        raise ValueError(
            f"streamed frame count ({total}) != pre-counted n_total "
            f"({n_total}): the sub-chunk blocking would be wrong (did the "
            f"input change between the counting pre-pass and this pass?)"
        )
    iso = s_iso / cnt
    M = s_M / cnt[:, None, None]
    if n_chunks > 0:
        iso_c = s_iso_c / cnt_c
        M_c = s_M_c / cnt_c[..., None, None]
    else:
        iso_c = jnp.zeros((L, 0))
        M_c = jnp.zeros((L, 0, 3, 3))
    stats = DqStats(lags_j, iso, M, iso_c, M_c)
    return stats, total, hist


def _padded_chunk_sums(buf, buf_len, part, lags_j, max_lag: int,
                       chunk_len: int, n_chunks: int = 0, nblock=None,
                       global_start=0):
    """Zero-pad one sub-chunk to the fixed ``chunk_len`` shape and run
    :func:`_dq_chunk_sums` — the single home of the pad-and-invoke step
    both streamed drivers (single-colvar and multi-replica) share."""
    nv = part.shape[0]
    if nv < chunk_len:
        part = np.pad(part, ((0, chunk_len - nv), (0, 0)))
    return _dq_chunk_sums(
        buf, buf_len, jnp.asarray(part), jnp.asarray(nv), lags_j,
        max_lag, chunk_len, n_chunks=n_chunks, nblock=nblock,
        global_start=global_start,
    )


def dq_statistics_streamed_multi(rep_chunk_iter, lags, chunk_len: int,
                                 min_rep_len: int = 0,
                                 short_replica_msg=None):
    """Per-REPLICA streamed Delta-q sums over an iterator of
    (replica_index, (n, 4) quaternion chunk) pairs (constant memory).

    The tail buffer resets at every replica boundary, so no pair spans
    two replicas — exactly the in-memory multi path's per-replica
    dq_statistics.  Only per-replica SUMS are kept (O(nRep * L) floats):
    the pooled means and the whole-replica uncertainty grouping
    (analyse_dq_multi) are formed from them afterwards, which is why no
    counting pre-pass is needed (unlike the single-stream sub-chunk
    blocking, whose nblock depends on the total length up front).

    ``min_rep_len`` > 0 fails FAST at the first replica flush shorter
    than that many frames (message from ``short_replica_msg(n_frames)``
    when given): the in-memory path errors on a too-large max_dt before
    any work via _lag_grid, but this path targets aggregate colvars
    whose full streaming pass costs minutes of I/O — validating only
    after the stream is consumed burned all of it before erroring.

    Returns (rep_sums, rep_lengths) where rep_sums is a list of
    (s_iso (L,), s_M (L,3,3), cnt (L,)) numpy triples per replica.
    """
    lags = np.asarray(lags, dtype=np.int32)
    L = len(lags)
    max_lag = int(lags.max())
    lags_j = jnp.asarray(lags)

    rep_sums = []
    rep_lengths = []
    cur_rep = None
    buf = s_iso = s_M = cnt = buf_len = None
    n_frames = 0

    def _reset():
        nonlocal buf, buf_len, s_iso, s_M, cnt, n_frames
        buf = jnp.zeros((max_lag, 4))
        buf_len = jnp.asarray(0)
        s_iso = jnp.zeros((L,))
        s_M = jnp.zeros((L, 3, 3))
        cnt = jnp.zeros((L,))
        n_frames = 0

    def _flush():
        if n_frames < min_rep_len:
            raise ValueError(
                short_replica_msg(n_frames) if short_replica_msg
                else f"replica {cur_rep} has {n_frames} frames; the lag "
                     f"grid needs >= {min_rep_len}"
            )
        rep_sums.append(
            (np.asarray(s_iso), np.asarray(s_M), np.asarray(cnt))
        )
        rep_lengths.append(n_frames)

    for rep, chunk in rep_chunk_iter:
        if rep != cur_rep:
            if cur_rep is not None:
                _flush()
            _reset()
            cur_rep = rep
        chunk = np.asarray(chunk, dtype=np.float64)
        n_frames += chunk.shape[0]
        for off in range(0, chunk.shape[0], chunk_len):
            out = _padded_chunk_sums(
                buf, buf_len, chunk[off : off + chunk_len], lags_j,
                max_lag, chunk_len,
            )
            d_iso, d_M, d_cnt, _ic, _mc, _cc, buf, buf_len = out
            s_iso = s_iso + d_iso
            s_M = s_M + d_M
            cnt = cnt + d_cnt
    if cur_rep is None:
        raise ValueError("empty multi-replica stream (no chunks)")
    _flush()
    return rep_sums, rep_lengths


def analyse_dq_multi_streamed(
    rep_chunk_iter,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    chunk_frames: int = 65536,
    n_chunks: int = 0,
) -> DqResult:
    """analyse_dq_multi over a lazy (replica_index, quaternion chunk)
    stream (constant memory) — the aggregate multi-replica colvar is
    precisely the input that outgrows RAM first (the reference's run-all
    concatenates every replica's colvar, run-all.bash:312-367).

    Pooling follows analyse_dq_multi exactly: per-replica means are
    recombined weighted by sample counts (equivalently, per-replica sums
    and counts add), and ``n_chunks`` uncertainty sub-chunks group WHOLE
    replicas (nReplicas % n_chunks == 0).  Matches the in-memory path to
    float tolerance on identical input."""
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, None)
    max_int = int(max_dt / delta_t)

    def _short_msg(n):
        # Same wording as the post-stream backstop below (the half-length
        # quoted is the FIRST short replica's, detected at its flush).
        return (
            f"max_dt ({max_dt}) exceeds half the shortest replica "
            f"trajectory length ({(n - 1) * delta_t / 2.0})"
        )

    # max_int*dt > (n-1)*dt/2  <=>  n < 2*max_int + 1: fail at the first
    # short replica FLUSH instead of after the whole (minutes-long)
    # streaming pass (the in-memory path errors up front via _lag_grid).
    rep_sums, rep_lengths = dq_statistics_streamed_multi(
        rep_chunk_iter, lags, chunk_frames,
        min_rep_len=2 * max_int + 1, short_replica_msg=_short_msg,
    )
    n_rep = len(rep_sums)
    n_min = min(rep_lengths)
    if int(max_dt / delta_t) * delta_t > (n_min - 1) * delta_t / 2.0:
        raise ValueError(
            f"max_dt ({max_dt}) exceeds half the shortest replica "
            f"trajectory length ({(n_min - 1) * delta_t / 2.0})"
        )
    if n_chunks > 0 and n_rep % n_chunks != 0:
        raise ValueError(
            f"n_chunks ({n_chunks}) must divide nReplicas ({n_rep})"
        )
    L = len(lags)
    S_iso = np.sum([s for s, _m, _c in rep_sums], axis=0)
    S_M = np.sum([m for _s, m, _c in rep_sums], axis=0)
    CNT = np.sum([c for _s, _m, c in rep_sums], axis=0)
    iso = jnp.asarray(S_iso / CNT)
    M = jnp.asarray(S_M / CNT[:, None, None])
    if n_chunks > 0:
        group = n_rep // n_chunks
        iso_cs, M_cs = [], []
        for g in range(n_chunks):
            sel = rep_sums[g * group : (g + 1) * group]
            sc = np.sum([c for _s, _m, c in sel], axis=0)
            iso_cs.append(np.sum([s for s, _m, _c in sel], axis=0) / sc)
            M_cs.append(
                np.sum([m for _s, m, _c in sel], axis=0)
                / sc[:, None, None]
            )
        iso_c = jnp.asarray(np.stack(iso_cs, axis=1))  # (L, C)
        M_c = jnp.asarray(np.stack(M_cs, axis=1))  # (L, C, 3, 3)
    else:
        iso_c = jnp.zeros((L, 0))
        M_c = jnp.zeros((L, 0, 3, 3))
    stats = DqStats(jnp.asarray(lags), iso, M, iso_c, M_c)
    return _finalise_dq(stats, lags, delta_t, n_chunks)


def analyse_dq_streamed(
    chunk_iter,
    delta_t: float,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    chunk_frames: int = 65536,
    n_chunks: int = 0,
    n_total: Optional[int] = None,
    hist_bins: int = 0,
) -> DqResult:
    """analyse_dq over a lazy stream of quaternion chunks (constant memory).

    ``n_chunks`` > 0 adds the reference's sub-chunk uncertainty estimates
    (requires ``n_total``, the total frame count, known up front — count
    the stream with one cheap pre-pass).  ``hist_bins`` > 0 additionally
    accumulates the per-lag delta-q histograms into ``DqResult.hist``
    (density-normalised like np.histogramdd(density=True))."""
    lags = _lag_grid(delta_t, min_dt, max_dt, skip_dt, None)
    stats, n, hist = dq_statistics_streamed(
        chunk_iter, lags, chunk_frames, n_chunks=n_chunks, n_total=n_total,
        hist_bins=hist_bins,
    )
    if int(max_dt / delta_t) * delta_t > (n - 1) * delta_t / 2.0:
        raise ValueError(
            f"max_dt ({max_dt}) exceeds half the streamed trajectory length "
            f"({(n - 1) * delta_t / 2.0})"
        )
    res = _finalise_dq(stats, lags, delta_t, n_chunks)
    if hist is not None:
        # Density normalisation replicating np.histogramdd(density=True)
        # OPERATION-FOR-OPERATION (divide by each dimension's bin-width
        # array, then by the total count): the counts are bitwise equal
        # to the in-memory path's, so this makes the densities bitwise
        # equal too (a mathematically equivalent counts/(n*vol) differs
        # in the last ulp).
        edges = np.linspace(-1.0, 1.0, hist_bins + 1)
        dens = hist.astype(np.float64)
        s = dens.sum(axis=(1, 2, 3))
        for i in range(3):
            shape = [1, 1, 1, 1]
            shape[1 + i] = hist_bins
            dens = dens / np.diff(edges).reshape(shape)
        dens = dens / s[:, None, None, None]
        res = res._replace(hist=dens)
    return res
