"""P2 orientational autocorrelation C(t) and order parameters S^2.

This is the #1 compute sink of the reference workflow
(``calculate-Ct-from-traj.py:200-238``): an O(nDeltas * nFrames) explicit
lag loop of einsums.  Here the lag profile comes from correlation
theorems over the frame axis — production dispatch (``_acf_sums``) is a
matmul-form Cooley-Tukey DFT (``_acf_sums_xla``); ``_acf_sums_fft`` is
the straight O(N log N) ``jnp.fft`` form, kept as an
independently-derived parity oracle (test_autocorr).  Both rest on the
tensor-component identity

    P2(v(t).v(t+dt)) = 1.5 * (v.v')^2 - 0.5
    (v.v')^2 = sum_ab [v_a v_b](t) * [v_a v_b](t+dt)

so the full lag profile is six real autocorrelations of the unique
outer-product components w_ab = v_a v_b.  Palmer's chunk statistics
(replicate mean +- SEM with the reference's sqrt(n)-1 denominator,
calculate-Ct-from-traj.py:228) are reproduced exactly.

Two drivers are provided:
- :func:`ct_palmer`       -- one fused jit for data that fits in device
  memory.
- :func:`ct_palmer_scan`  -- lax.scan over the replicate axis with
  sum/sum-of-squares accumulators for arbitrarily many replicates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Index pairs of the 6 unique outer-product components and their weights.
# Off-diagonals count twice in sum_ab; the weight enters the *component*
# (which is auto-correlated with itself), so it must be sqrt(2) to
# contribute a factor 2 in the correlation product.
_PAIR_I = (0, 1, 2, 0, 0, 1)
_PAIR_J = (0, 1, 2, 1, 2, 2)
_SQRT2 = 2.0**0.5
_PAIR_W = (1.0, 1.0, 1.0, _SQRT2, _SQRT2, _SQRT2)


def _fft_len(n_min: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) length >= n_min — linear correlation
    needs nfft >= nFrames + nDeltas; smooth composites keep the FFT fast
    without rounding all the way up to a power of two."""
    best = 1
    while best < n_min:
        best *= 2
    m5 = 1
    while m5 < 8 * n_min:
        m3 = m5
        while m3 < 8 * n_min:
            m = m3
            while m < n_min:
                m *= 2
            if m < best:
                best = m
            m3 *= 3
        m5 *= 5
    return best


def _acf_sums_fft(vecs, n_deltas: int):
    """Sum_t (v(t).v(t+delta))^2 for delta = 1..n_deltas via FFT.

    The six outer-product components share one inverse transform: by
    linearity their power spectra are summed BEFORE the irfft, so the
    kernel runs six forward rffts but a single irfft instead of six.

    vecs : (..., nFrames, 3) -> (..., n_deltas)
    """
    n_frames = vecs.shape[-2]
    nfft = _fft_len(n_frames + n_deltas)
    comps = [
        w * vecs[..., i] * vecs[..., j]
        for i, j, w in zip(_PAIR_I, _PAIR_J, _PAIR_W)
    ]
    w6 = jnp.stack(comps, axis=-2)  # (..., 6, nF)
    W = jnp.fft.rfft(w6, n=nfft, axis=-1)
    power = jnp.sum(W.real**2 + W.imag**2, axis=-2)  # (..., nfft//2+1)
    acf = jnp.fft.irfft(power, n=nfft, axis=-1)
    return acf[..., 1 : n_deltas + 1]


@functools.lru_cache(maxsize=16)
def _dft_constants(n_frames: int, n_deltas: int, dtype_name: str):
    """Cooley-Tukey factor matrices for the matmul-DFT correlation path.

    NFFT = N1*N2 >= nFrames + nDeltas (power of two, near-square split so
    both matmul contractions stay well shaped).  Returns real/imag parts
    of the radix matrices, the twiddle factors, and the cosine inverse
    matrix that maps the power spectrum straight to lags 1..n_deltas.
    """
    import numpy as np

    # The matmul DFT needs no smoothness — any nfft >= nFrames + nDeltas
    # avoids circular aliasing in lags 1..nDeltas.  Round up to a multiple
    # of 128 and take the most-square factorisation: smaller nfft directly
    # cuts the memory traffic of every intermediate.
    n_min = n_frames + n_deltas
    nfft = ((n_min + 127) // 128) * 128
    N1 = int(np.sqrt(nfft))
    while nfft % N1 != 0:
        N1 += 1
    N2 = nfft // N1
    if N1 < N2:
        N1, N2 = N2, N1
    dt = np.dtype(dtype_name)
    # Stage-1 truncation: with the row-major (n1, n2) split the zero
    # padding fills whole trailing n1 rows, so the first contraction
    # only needs K1 = ceil(F/N2) of its N1 terms (1/3 less matmul work
    # at the canonical 1000-frame chunk).
    K1 = int(np.ceil(n_frames / N2))
    k1 = np.arange(N1)
    W1 = np.exp(-2j * np.pi * np.outer(k1, np.arange(K1)) / N1)
    W2 = np.exp(-2j * np.pi * np.outer(np.arange(N2), np.arange(N2)) / N2)
    TW = np.exp(-2j * np.pi * np.outer(k1, np.arange(N2)) / nfft)
    d = np.arange(1, n_deltas + 1)
    kk = (k1[:, None] + N1 * np.arange(N2)[None, :]).reshape(-1)
    CINV = (np.cos(2 * np.pi * np.outer(d, kk) / nfft) / nfft).astype(dt)
    # Return host numpy arrays: they embed as fresh constants in each
    # trace (caching device arrays created inside a trace leaks tracers).
    return (
        nfft, N1, N2, K1,
        W1.real.astype(dt), W1.imag.astype(dt),
        TW.real.astype(dt), TW.imag.astype(dt),
        W2.real.astype(dt), W2.imag.astype(dt),
        CINV,
    )


def _acf_sums(vecs, n_deltas: int):
    """Sum_t (v(t).v(t+delta))^2 for delta = 1..n_deltas — the production
    entry point every C(t) driver calls (currently the matmul-DFT form)."""
    return _acf_sums_xla(vecs, n_deltas)


def _acf_sums_xla(vecs, n_deltas: int):
    """Sum_t (v(t).v(t+delta))^2 for delta = 1..n_deltas — matmul-DFT path.

    Implements the correlation as a two-stage Cooley-Tukey DFT expressed
    as dense matmuls (radix ~sqrt(NFFT) each) plus a cosine-matrix inverse
    that lands directly on the lag grid.  Every contraction is pinned to
    HIGHEST precision: a reduced-precision f32 matmul (bf16 passes or
    TF32) loses ~1e-3 on the DC-heavy outer-product signals.

    The DFT runs on the CENTRED components u = w - mean(w); the mean's
    share of each lag sum is added back in closed form from prefix sums
    of u.  With the DC left in, the f32 rounding of the long contractions
    scales with the full signal power and the C(t) error grows with the
    chunk length (~1.5e-6 at 1000 frames, ~3e-6 at 3000-10000 against a
    float64 reference); centred, it stays near 3e-7 at every length.

    vecs : (..., nFrames, 3) -> (..., n_deltas)
    """
    n_frames = vecs.shape[-2]
    (nfft, N1, N2, K1, W1r, W1i, TWr, TWi, W2r, W2i, CINV) = _dft_constants(
        n_frames, n_deltas, jnp.dtype(vecs.dtype).name
    )
    ein = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    w6 = jnp.stack([
        w * vecs[..., i] * vecs[..., j]
        for i, j, w in zip(_PAIR_I, _PAIR_J, _PAIR_W)
    ], axis=-2)  # (..., 6, nF)
    # Per component, with w = m + u:
    #   sum_{t<F-d} w(t) w(t+d)
    #     = sum u(t) u(t+d) + m (U[F-d] + U[F] - U[d]) + (F-d) m^2,
    # U[n] = sum_{t<n} u(t) (U[F] ~ 0, kept for exactness).  Summed over
    # the components the middle term needs only the prefix sums Z of
    # z(t) = sum_c m_c u_c(t): one scan per signal instead of six.
    mean = jnp.mean(w6, axis=-1, keepdims=True)
    u = w6 - mean
    Z = jnp.cumsum(jnp.sum(mean * u, axis=-2), axis=-1)  # Z[n] at n-1
    head = jnp.flip(Z[..., n_frames - 1 - n_deltas:n_frames - 1], -1)
    tail = Z[..., -1:] - Z[..., :n_deltas]  # Z[F] - Z[d]
    lag_count = n_frames - jnp.arange(1, n_deltas + 1, dtype=w6.dtype)
    dc = head + tail + lag_count * jnp.sum(mean * mean, axis=-2)
    comps = [u[..., c, :] for c in range(6)]
    # Pack the 6 real signals into 3 complex ones (classic 2-for-1 real
    # FFT packing): for z = a + ib, |A[k]|^2 + |B[k]|^2 =
    # (|Z[k]|^2 + |Z[-k]|^2)/2, and the cosine inverse matrix is
    # symmetric under k -> nfft-k, so summing CINV against |Z|^2 directly
    # yields the same lag sums while HALVING every DFT intermediate
    # (the chain is memory-bound).
    xr = jnp.stack(comps[0::2], axis=-2)  # (..., 3, nF)
    xi = jnp.stack(comps[1::2], axis=-2)

    def pad_split(t):
        t = jnp.concatenate(
            [t, jnp.zeros(t.shape[:-1] + (K1 * N2 - n_frames,), t.dtype)],
            axis=-1,
        )
        return t.reshape(t.shape[:-1] + (K1, N2))  # n = N2*n1 + n2

    xr, xi = pad_split(xr), pad_split(xi)
    Ar = ein("kn,...ns->...ks", W1r, xr) - ein("kn,...ns->...ks", W1i, xi)
    Ai = ein("kn,...ns->...ks", W1i, xr) + ein("kn,...ns->...ks", W1r, xi)
    Br = Ar * TWr - Ai * TWi
    Bi = Ar * TWi + Ai * TWr
    Xr = ein("...ks,sm->...km", Br, W2r) - ein("...ks,sm->...km", Bi, W2i)
    Xi = ein("...ks,sm->...km", Br, W2i) + ein("...ks,sm->...km", Bi, W2r)
    power = jnp.sum(Xr**2 + Xi**2, axis=-3)  # sum over the 3 packed signals
    Pf = power.reshape(power.shape[:-2] + (nfft,))
    flat = Pf.reshape((-1, nfft))
    out = jnp.matmul(flat, CINV.T, precision=jax.lax.Precision.HIGHEST)
    return out.reshape(Pf.shape[:-1] + (n_deltas,)) + dc


def ct_palmer(vecs):
    """C(t) with Palmer chunk statistics, one fused computation.

    Parameters
    ----------
    vecs : (nReplicates, nFrames, nResidues, 3) unit bond vectors, already
        reshaped into memory-time chunks (reference
        ``reformat_vecs_by_tau``, calculate-Ct-from-traj.py:245-275).

    Returns
    -------
    Ct, dCt : (nDeltas, nResidues) with nDeltas = nFrames // 2, matching
        calculate_Ct_Palmer (calculate-Ct-from-traj.py:200-238) exactly:
        per-replicate lag means, then mean / std/(sqrt(nRep)-1) across
        replicates.
    """
    vecs = jnp.asarray(vecs)
    n_rep, n_frames, n_res = vecs.shape[0], vecs.shape[1], vecs.shape[2]
    n_deltas = n_frames // 2
    # (nRep, nRes, nF, 3) for the DFT along a trailing-adjacent axis
    v = jnp.swapaxes(vecs, 1, 2)
    n_vals = n_frames - jnp.arange(1, n_deltas + 1, dtype=vecs.dtype)
    s = _acf_sums(v, n_deltas)  # (nRep, nRes, nDeltas)
    per_rep = -0.5 + 1.5 * s / n_vals  # (nRep, nRes, nDeltas)
    Ct = jnp.mean(per_rep, axis=0)
    dCt = jnp.std(per_rep, axis=0) / (jnp.sqrt(jnp.asarray(n_rep, vecs.dtype)) - 1.0)
    return Ct.T, dCt.T


def palmer_pooled_stats(acc_s, acc_s2, count):
    """(running shifted sum, shifted sum-of-squares, chunk count) ->
    (mean, dCt), in the accumulator's own (..., nDeltas) orientation.

    SHIFTED-BY-ONE convention: producers accumulate e = x - 1 and e**2,
    NOT x and x**2.  The variance is shift-invariant, and per-chunk
    C(t)/S2 values sit near 1 exactly where their spread is tiny (early
    lags, rigid bonds) — with raw sums the f32 E[x^2]-E[x]^2 subtraction
    cancels to the rounding floor of x^2 (~6e-8), the same order as the
    variance itself (a few per cent of dCt on the f32 streamed path);
    with the shift the squares are variance-sized and the cancellation
    disappears.

    Trade-off (documented, accepted): for per-chunk values clustered
    near a constant c the f32 noise floor on the variance is
    ~eps*(c-shift)^2, so shift=1 is better than raw sums whenever
    c > 0.5 — which covers the regime that matters (early lags / rigid
    bonds, where C(t) ~ 1 and genuine variance is smallest).  For
    c < 0.5 (decorrelated lags) the shifted floor is higher than raw,
    but there the chunk means carry sampling noise ~1/sqrt(n_vals), so
    genuinely tiny variances do not occur in practice; a per-lag
    provisional-mean shift would cover both regimes at the cost of the
    plain-sum associativity the multi-host pooling relies on.

    THE single home of the pooled Palmer statistics — in particular the
    reference's sqrt(n)-1 SEM denominator (calculate-Ct-from-traj.py:228,
    a quirk we replicate deliberately; see CLAUDE.md).  Every streamed /
    sharded / multi-host producer must accumulate the SAME shifted
    quantities (grep "palmer_pooled_stats convention") and pool through
    this helper so a parity adjustment happens in exactly one place.
    """
    count = jnp.asarray(count, jnp.result_type(acc_s))
    e_mean = acc_s / count
    mean = 1.0 + e_mean
    var = jnp.maximum(acc_s2 / count - e_mean**2, 0.0)
    denom = jnp.sqrt(count) - 1.0
    safe = jnp.where(denom > 0, denom, 1.0)
    # count == 1: the reference's 0/0 gives NaN dCt
    # (calculate-Ct-from-traj.py:228) and ct_palmer reproduces that —
    # the pooled path must agree, not silently report zero error bars.
    dct = jnp.where(
        denom > 0, jnp.sqrt(var) / safe, jnp.full_like(var, jnp.nan)
    )
    return mean, dct


def ct_palmer_scan(vecs, batch: int = 1, mesh=None):
    """Replicate-streamed variant for trajectories too large for one fused
    FFT buffer.  Scans over the replicate axis, accumulating per-lag sum and
    sum-of-squares; numerically equivalent to :func:`ct_palmer` (population
    std via E[x^2]-E[x]^2).

    vecs : (nReplicates, nFrames, nResidues, 3); nReplicates % batch == 0.
    mesh : optional ("rep", "res") jax Mesh — shards each replicate group
        over the mesh via the production sharded stream
        (parallel/streamed.py) instead of the single-device scan.
    """
    vecs = jnp.asarray(vecs)
    if mesh is not None:
        from ..parallel.streamed import ShardedCtStream

        n_rep_m, n_frames_m, n_res_m, _ = vecs.shape
        stream = ShardedCtStream(mesh, n_frames_m, n_res_m, dtype=vecs.dtype)
        for off in range(0, n_rep_m, batch):
            stream.update(vecs[off : off + batch])
        return stream.finalize()
    n_rep, n_frames, n_res, _ = vecs.shape
    n_deltas = n_frames // 2
    if n_rep % batch != 0:
        raise ValueError(f"nReplicates ({n_rep}) must be divisible by batch ({batch})")
    groups = vecs.reshape(n_rep // batch, batch, n_frames, n_res, 3)
    n_vals = n_frames - jnp.arange(1, n_deltas + 1, dtype=vecs.dtype)

    def body(carry, chunk):
        acc_s, acc_s2 = carry
        v = jnp.swapaxes(chunk, 1, 2)  # (batch, nRes, nF, 3)
        s = _acf_sums(v, n_deltas)
        # palmer_pooled_stats convention: accumulate e = per - 1, e**2.
        e = -1.5 + 1.5 * s / n_vals  # (batch, nRes, nDeltas)
        acc_s = acc_s + jnp.sum(e, axis=0)
        acc_s2 = acc_s2 + jnp.sum(e**2, axis=0)
        return (acc_s, acc_s2), None

    init = (
        jnp.zeros((n_res, n_deltas), vecs.dtype),
        jnp.zeros((n_res, n_deltas), vecs.dtype),
    )
    (acc_s, acc_s2), _ = jax.lax.scan(body, init, groups)
    mean, dCt = palmer_pooled_stats(acc_s, acc_s2, n_rep)
    return mean.T, dCt.T


def ct_palmer_streamed(chunk_iter, n_frames_per_chunk: int, mesh=None):
    """Streaming C(t): consume an iterator of Palmer-chunk groups without
    ever holding the full trajectory (the larger-than-device-memory path
    used by the north-star driver, tools/bench_northstar.py).

    chunk_iter yields (g, n_frames_per_chunk, nRes, 3) arrays (g may vary);
    per-chunk lag means accumulate into running sum / sum-of-squares so
    the result equals :func:`ct_palmer` over the concatenated chunks.

    mesh : optional ("rep", "res") jax Mesh — shard each group's chunk
        axis over "rep" and the residue axis over "res"
        (parallel/streamed.ShardedCtStream; one psum per group, NCCL over NVLink).
    """
    if mesh is not None:
        from ..parallel.streamed import ShardedCtStream

        stream = None
        for group in chunk_iter:
            if stream is None:
                stream = ShardedCtStream(
                    mesh, n_frames_per_chunk, group.shape[2],
                    dtype=jnp.asarray(group).dtype,
                )
            stream.update(group)
        if stream is None:
            raise ValueError("empty chunk iterator")
        return stream.finalize()

    acc_s, acc_s2, n_rep = stream_accumulate(chunk_iter, n_frames_per_chunk)
    mean, dCt = palmer_pooled_stats(acc_s, acc_s2, float(n_rep))
    return mean.T, dCt.T


def stream_accumulate(chunk_iter, n_frames_per_chunk: int):
    """Shared per-host streaming accumulation: chunk groups ->
    (acc_s, acc_s2, count) running sums of the SHIFTED per-chunk Palmer
    C(t) means (e = per - 1 and e**2; see palmer_pooled_stats).

    THE single implementation behind both ct_palmer_streamed and the
    multi-host ingest loop (parallel.ingest.host_stream) — the
    associative (sum, sumsq, count) triple both reductions pool must be
    produced by byte-identical code or the multi-host parity guarantee
    silently breaks."""
    n_deltas = n_frames_per_chunk // 2
    update = _stream_update_jit(n_frames_per_chunk, n_deltas)

    acc_s = acc_s2 = None
    n_rep = 0
    for group in chunk_iter:
        group = jnp.asarray(group)
        if group.shape[1] != n_frames_per_chunk:
            raise ValueError(
                f"chunk group has {group.shape[1]} frames, expected {n_frames_per_chunk}"
            )
        if acc_s is None:
            acc_s = jnp.zeros((group.shape[2], n_deltas), group.dtype)
            acc_s2 = jnp.zeros((group.shape[2], n_deltas), group.dtype)
        acc_s, acc_s2 = update(group, acc_s, acc_s2)
        n_rep += group.shape[0]
    if acc_s is None:
        raise ValueError("empty chunk iterator")
    return acc_s, acc_s2, n_rep


@functools.lru_cache(maxsize=None)
def _stream_update_jit(n_frames_per_chunk: int, n_deltas: int):
    """ONE dispatch per group: ACF + per-chunk statistics + accumulator
    update fused into a single jitted program (one launch per group, no
    eager intermediates).  Cached at module level: jax.jit keys its trace
    cache on the wrapper OBJECT, so a fresh closure per stream_accumulate
    call would recompile the identical program for every stream — e.g.
    the per-host ingest loop calls this once per host."""

    @jax.jit
    def update(v, acc_s, acc_s2):
        n_vals = n_frames_per_chunk - jnp.arange(
            1, n_deltas + 1, dtype=v.dtype
        )
        s = _acf_sums(jnp.swapaxes(v, 1, 2), n_deltas)  # (g, nRes, nDeltas)
        # palmer_pooled_stats convention: accumulate e = per - 1, e**2.
        e = -1.5 + 1.5 * s / n_vals
        return acc_s + jnp.sum(e, axis=0), acc_s2 + jnp.sum(e**2, axis=0)

    return update


def ct_palmer_direct(vecs):
    """O(N^2) lag-loop reference implementation (for parity tests against
    the FFT path; mirrors calculate-Ct-from-traj.py:222-228 literally)."""
    vecs = jnp.asarray(vecs)
    n_rep, n_frames, n_res, _ = vecs.shape
    n_deltas = n_frames // 2

    def one_delta(delta):
        n_vals = n_frames - delta
        # Use masking over a fixed-size slice so the shape is static.
        dots = jnp.einsum(
            "ijkl,ijkl->ijk", vecs[:, : n_frames - 1],
            jnp.roll(vecs, -delta, axis=1)[:, : n_frames - 1],
            precision=jax.lax.Precision.HIGHEST,
        )
        mask = (jnp.arange(n_frames - 1) < n_vals)[None, :, None]
        p2 = (-0.5 + 1.5 * dots**2) * mask
        per_rep = jnp.sum(p2, axis=1) / n_vals
        return per_rep  # (nRep, nRes)

    deltas = jnp.arange(1, n_deltas + 1)
    per_rep = jax.vmap(one_delta)(deltas)  # (nDeltas, nRep, nRes)
    Ct = jnp.mean(per_rep, axis=1)
    dCt = jnp.std(per_rep, axis=1) / (jnp.sqrt(jnp.asarray(n_rep, vecs.dtype)) - 1.0)
    return Ct, dCt


def lag_times(delta_t: float, tau_memory: float):
    """The lag-time grid matching calculate_dt
    (calculate-Ct-from-traj.py:240-243).

    Host float64, like the reference's Python floats: a device array
    would canonicalise to f32 in production (x64 off), and f32 lag
    times both mis-print the grid AND silently knock the C(t) artefact
    writers off the native fast path (print_sxylist requires f64 x),
    leaving a large stream in numpy's per-scalar formatter."""
    import numpy as np

    n_pts = int(0.5 * tau_memory / delta_t)
    return (np.arange(n_pts, dtype=np.float64) + 1.0) * delta_t


def reformat_by_tau(vec_list, delta_t: float, tau_memory: float):
    """Concatenate per-trajectory (nFrames, nBonds, 3) arrays and reshape
    into Palmer chunks (nChunks, framesPerChunk, nBonds, 3), dropping
    remainder frames per source (calculate-Ct-from-traj.py:245-275)."""
    import numpy as np

    frames_per_chunk = int(tau_memory / delta_t)
    used = []
    for v in vec_list:
        n = (v.shape[0] // frames_per_chunk) * frames_per_chunk
        used.append(np.asarray(v[:n]))
    out = np.concatenate(used, axis=0)
    n_chunks = out.shape[0] // frames_per_chunk
    return out.reshape(n_chunks, frames_per_chunk, out.shape[-2], out.shape[-1])


# ---------------------------------------------------------------------------
# S^2 order parameters (calculate-Ct-from-traj.py:96-145)
# ---------------------------------------------------------------------------

def s2_outer(vecs):
    """S2 = 1.5 * sum_ab <v_a v_b>^2 - 0.5 with no block averaging.

    vecs : (nFrames, nResidues, 3) or (nFrames, 3).
    Returns (nResidues,) or scalar.
    """
    vecs = jnp.asarray(vecs)
    if vecs.ndim == 2:
        outer = jnp.einsum("ij,ik->jk", vecs, vecs,
                           precision=jax.lax.Precision.HIGHEST) / vecs.shape[0]
        return 1.5 * jnp.sum(outer**2) - 0.5
    outer = jnp.einsum("ijk,ijl->jkl", vecs, vecs,
                       precision=jax.lax.Precision.HIGHEST) / vecs.shape[0]
    return 1.5 * jnp.sum(outer**2, axis=(-2, -1)) - 0.5


def s2_outer_blocked(vecs, delta_t: float, tau_memory: float):
    """Block-averaged S2 with SEM using the reference's sqrt(n)-1
    denominator (calculate-Ct-from-traj.py:116-142).

    vecs : (nFrames, nResidues, 3).
    Returns (nResidues, 2) stacked [S2, dS2].
    """
    vecs = jnp.asarray(vecs)
    n_per_block = int(tau_memory / delta_t)
    n_blocks = vecs.shape[0] // n_per_block
    v = vecs[: n_blocks * n_per_block].reshape(
        n_blocks, n_per_block, vecs.shape[-2], vecs.shape[-1]
    )
    outer = jnp.einsum("ijkl,ijkm->iklm", v, v,
                       precision=jax.lax.Precision.HIGHEST) / n_per_block
    s2 = 1.5 * jnp.sum(outer**2, axis=(-2, -1)) - 0.5  # (nBlocks, nRes)
    S2 = jnp.mean(s2, axis=0)
    dS2 = jnp.std(s2, axis=0) / (jnp.sqrt(jnp.asarray(n_blocks, vecs.dtype)) - 1.0)
    return jnp.stack([S2, dS2], axis=-1)
