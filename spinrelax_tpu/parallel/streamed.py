"""Sharded STREAMING C(t) pipeline — the production multi-device path.

The real larger-than-device-memory workload (SURVEY §2.5 rows 1-2; reference scale target
BASELINE.md "10^4 x 10^6") streams groups of Palmer chunks through
running (sum, sum-of-squares, count) accumulators.  Here each group is
sharded over the ("rep", "res") device mesh:

- chunk axis  -> mesh axis "rep" (replica/data parallel; the reference's
  per-replica averaging, calculate-fitted-Ct.py:113-147)
- residue axis -> mesh axis "res" (the reference's broadcast axis,
  calculate-Ct-from-traj.py:225)

The per-group step is a ``shard_map``: every device runs the ACF on its
LOCAL (g/rep, F, res/res, 3) block, and the only communication is one
``psum`` of the (res_local, nDeltas) partial sums over "rep" (NCCL over
NVLink between the cards).  Accumulators live sharded over "res" and are
donated, so device memory stays constant for arbitrarily long streams.

The downstream "finish" (multi-exp fit -> J(omega) -> R1/R2/NOE) is a
single jit with residues sharded over ALL devices (residues are
embarrassingly parallel there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import autocorr
from ..ops import relaxation as rx
from ..ops.jomega import j_combine_isotropic
from ..fit.lm import fit_multiexp
from ..constants import NucleusPair


def _pad_to(n: int, mult: int) -> int:
    return (-(-n // mult)) * mult


# jax.jit's trace cache is keyed on the WRAPPER object, so wrapping a
# fresh closure per call retraces/recompiles every time.  Jitted helpers
# used by the
# call-per-invocation API (run_sharded_finish) are cached here instead.
_JIT_CACHE: dict = {}


def _cached_jit(key, make):
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = _JIT_CACHE[key] = make()
    return fn


_DEFAULT_PAIR: Optional[NucleusPair] = None


def _default_pair() -> NucleusPair:
    """Module-level default pair: a fresh NucleusPair per call would
    defeat the (pair, diffusion)-keyed jit cache for default callers."""
    global _DEFAULT_PAIR
    if _DEFAULT_PAIR is None:
        _DEFAULT_PAIR = NucleusPair(time_unit="ps")
    return _DEFAULT_PAIR


class ShardedCtStream:
    """Streaming Palmer C(t) accumulator over a ("rep", "res") mesh.

    Equivalent statistics to :func:`ops.autocorr.ct_palmer` /
    ``ct_palmer_streamed`` — per-chunk lag means pooled by running
    sum / sum-of-squares with the reference's sqrt(n)-1 SEM denominator
    (calculate-Ct-from-traj.py:228).

    Groups fed to :meth:`update` may have any chunk count g: they are
    zero-padded to a multiple of the "rep" mesh dim with zero WEIGHTS, so
    padding never contaminates the statistics.  The residue axis is
    zero-padded once to a multiple of the "res" dim and sliced off at
    :meth:`finalize`.
    """

    def __init__(self, mesh: Mesh, n_frames_per_chunk: int, n_res: int,
                 dtype=jnp.float32):
        self.mesh = mesh
        self.n_frames = int(n_frames_per_chunk)
        self.n_deltas = self.n_frames // 2
        self.n_res = int(n_res)
        ax = dict(zip(mesh.axis_names, mesh.devices.shape))
        self.rep_dim = ax["rep"]
        self.res_dim = ax["res"]
        self.n_res_pad = _pad_to(self.n_res, self.res_dim)
        self.dtype = dtype

        self.reset()
        # ONE jitted step shared ACROSS instances via _JIT_CACHE:
        # stage_ct_streamed builds two streams ("ext"/"int") per call and
        # fresh ones every call — a per-instance jax.jit would recompile
        # the identical shard_map program each time.  jax.jit's own cache
        # then
        # specialises per input shape, so no per-g_pad bookkeeping.
        self._step = _cached_jit(
            ("stream_step", mesh, self.n_frames, np.dtype(dtype).name),
            self._make_step,
        )
        self._ones_w = {}  # (g_pad, g) -> device weight vector
        self._g_canon = None  # first-seen padded group size (shape anchor)
        from .mesh import vecs_sharding

        self._group_sharding = vecs_sharding(mesh)
        self._w_sharding = NamedSharding(mesh, P("rep"))

    def reset(self) -> None:
        """Zero the accumulators (keeps compiled steps — used by warm-up
        loops that must not pollute the statistics)."""
        shard_res = NamedSharding(self.mesh, P("res", None))
        self._acc_s = jax.device_put(
            jnp.zeros((self.n_res_pad, self.n_deltas), self.dtype), shard_res
        )
        self._acc_s2 = jax.device_put(
            jnp.zeros((self.n_res_pad, self.n_deltas), self.dtype), shard_res
        )
        self._count = jax.device_put(
            jnp.zeros((), self.dtype), NamedSharding(self.mesh, P())
        )

    def _make_step(self):
        n_deltas = self.n_deltas
        n_vals = self.n_frames - jnp.arange(1, n_deltas + 1, dtype=self.dtype)

        def local_step(v_loc, w_loc, acc_s, acc_s2, count):
            # v_loc: (g/rep, F, res/res, 3); w_loc: (g/rep,)
            s = autocorr._acf_sums(jnp.swapaxes(v_loc, 1, 2), n_deltas)
            # palmer_pooled_stats convention: accumulate e = per - 1,
            # e**2 (shift kills the f32 E[x^2]-E[x]^2 cancellation).
            e = -1.5 + 1.5 * s / n_vals  # (g_loc, res_loc, nDeltas)
            w = w_loc[:, None, None]
            ps = jax.lax.psum(jnp.sum(w * e, axis=0), "rep")
            ps2 = jax.lax.psum(jnp.sum(w * e**2, axis=0), "rep")
            cnt = jax.lax.psum(jnp.sum(w_loc), "rep")
            return acc_s + ps, acc_s2 + ps2, count + cnt

        mapped = shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P("rep", None, "res", None), P("rep"),
                      P("res", None), P("res", None), P()),
            out_specs=(P("res", None), P("res", None), P()),
            check_vma=False,  # psum makes outputs rep-invariant.
        )
        return jax.jit(mapped, donate_argnums=(2, 3, 4))

    def update(self, group) -> None:
        """group: (g, n_frames_per_chunk, n_res, 3) host or device array.

        Device arrays NEVER round-trip to the host: chunk/residue padding
        (zero rows, zero WEIGHTS for padded chunks) happens with one
        device-side pad, then a reshard onto the mesh — this is how the
        streaming north-star driver and the ``--devices`` CLI stream feed
        device-generated groups."""
        g, F, N = group.shape[0], group.shape[1], group.shape[2]
        if F != self.n_frames:
            raise ValueError(f"group has {F} frames/chunk, expected {self.n_frames}")
        if N not in (self.n_res, self.n_res_pad):
            raise ValueError(f"group has {N} residues, expected {self.n_res}")
        g_pad = _pad_to(g, self.rep_dim)
        # Pad ragged (usually final) groups up to the first-seen group
        # size: a smaller g_pad would be a NEW shape for the shard_map
        # step — one full retrace + recompile to process a single tail
        # group.  Zero weights
        # keep the statistics exact; a LARGER group later re-anchors.
        if self._g_canon is not None:
            g_pad = max(g_pad, self._g_canon)
        self._g_canon = g_pad
        if isinstance(group, jax.Array):
            vd = group.astype(self.dtype)
            if g_pad != g or N != self.n_res_pad:
                vd = jnp.pad(
                    vd,
                    ((0, g_pad - g), (0, 0), (0, self.n_res_pad - N), (0, 0)),
                )
            vd = jax.device_put(vd, self._group_sharding)
            wd = self._ones_w.get((g_pad, g))
            if wd is None:
                w = (jnp.arange(g_pad) < g).astype(self.dtype)
                wd = self._ones_w[(g_pad, g)] = jax.device_put(
                    w, self._w_sharding
                )
        else:
            group = np.asarray(group, dtype=np.dtype(self.dtype))
            w = np.zeros(g_pad, dtype=group.dtype)
            w[:g] = 1.0
            if g_pad != g or self.n_res_pad != N:
                padded = np.zeros((g_pad, F, self.n_res_pad, 3), dtype=group.dtype)
                padded[:g, :, :N] = group
                group = padded
            vd = jax.device_put(jnp.asarray(group), self._group_sharding)
            wd = jax.device_put(jnp.asarray(w), self._w_sharding)
        self._acc_s, self._acc_s2, self._count = self._step(
            vd, wd, self._acc_s, self._acc_s2, self._count
        )

    @property
    def n_chunks(self) -> int:
        return int(self._count)

    def accumulators(self):
        """(acc_s, acc_s2, count) — padded residue rows included; the
        cross-host DCN reduction point (ARCHITECTURE.md 'Multi-host
        ingest': these sums are the ONLY state that crosses hosts)."""
        return self._acc_s, self._acc_s2, self._count

    def finalize(self):
        """-> (Ct, dCt) of shape (nDeltas, nRes), identical statistics to
        ct_palmer over the concatenated stream."""
        from .mesh import fetch

        acc_s, acc_s2, count = self.accumulators()
        mean, dct = autocorr.palmer_pooled_stats(
            jnp.asarray(acc_s)[: self.n_res],
            jnp.asarray(acc_s2)[: self.n_res],
            float(count),
        )
        return fetch(mean).T, fetch(dct).T


class StreamedRates(NamedTuple):
    Ct: jnp.ndarray  # (nRes, nDeltas)
    dCt: jnp.ndarray
    S2: jnp.ndarray  # (nRes,)
    C: jnp.ndarray
    tau: jnp.ndarray
    R1: jnp.ndarray
    R2: jnp.ndarray
    NOE: jnp.ndarray
    rho: jnp.ndarray


def make_sharded_finish(mesh: Mesh, delta_t: float = 1.0,
                        tau_iso: float = 4242.0, n_components: int = 2,
                        pair: Optional[NucleusPair] = None,
                        zeta: float = 1.0):
    """The post-stream stage as ONE jitted program with residues sharded
    over every device (both mesh axes): multi-exponential LM fit ->
    J(omega) -> R1/R2/NOE/rho.  Takes the streamed accumulators
    (acc_s, acc_s2, count) exactly as :meth:`ShardedCtStream.accumulators`
    produces them, so the whole production pipeline is stream -> finish
    with no host round-trip of the C(t) matrix."""
    pair = pair or NucleusPair(time_unit="ps")
    omega = jnp.asarray(pair.omega5())
    f_dd = pair.factor_dd()
    f_csa = pair.factor_csa()
    tf = pair.time_fact
    gr = pair.gamma_b / pair.gamma_a

    res_sharding = NamedSharding(mesh, P(("rep", "res"), None))

    def finish(acc_s, acc_s2, count):
        acc_s = jax.lax.with_sharding_constraint(acc_s, res_sharding)
        mean, dct = autocorr.palmer_pooled_stats(acc_s, acc_s2, count)  # (nResPad, nD)
        n_deltas = mean.shape[1]
        dt = (jnp.arange(n_deltas, dtype=mean.dtype) + 1.0) * delta_t
        # SEM-weighted like the reference pipeline (see
        # parallel/pipeline.py) — dct is available right here.
        sigma = jnp.where(dct > 0, dct, 1.0)
        fit = fit_multiexp(dt, mean, sigma, K=n_components, s2_free=True)
        J = j_combine_isotropic(
            omega.astype(mean.dtype), tau_iso, fit.S2, fit.C, fit.tau,
            zeta=zeta,
        )
        R1 = rx.r1_from_j(J, f_dd, f_csa, tf)
        R2 = rx.r2_from_j(J, f_dd, f_csa, tf)
        NOE = rx.noe_from_j(J, f_dd, tf, gr, R1)
        rho = rx.rho_from_j(J)
        return StreamedRates(mean, dct, fit.S2, fit.C, fit.tau, R1, R2, NOE, rho)

    return jax.jit(finish)


class FlagshipRates(NamedTuple):
    """Output of the PRODUCTION sharded finish: the quantities
    ``stage_fit_ct`` + ``stage_relax`` produce for the same stream."""

    Ct: jnp.ndarray   # (nRes, nDeltas) pooled C(t)
    dCt: jnp.ndarray  # (nRes, nDeltas) pooled SEM
    cts: object       # CtModelSet from the DoF-ladder selection
    R1: jnp.ndarray   # (nRes,) ensemble-averaged rates (legacy semantics)
    R2: jnp.ndarray
    NOE: jnp.ndarray
    rho: jnp.ndarray
    dR1: Optional[jnp.ndarray] = None
    dR2: Optional[jnp.ndarray] = None
    dNOE: Optional[jnp.ndarray] = None
    drho: Optional[jnp.ndarray] = None


def run_sharded_finish(
    mesh: Mesh,
    acc_s,
    acc_s2,
    count,
    *,
    n_res: int,
    delta_t: float,
    diffusion,
    pair: Optional[NucleusPair] = None,
    vecs=None,
    weights=None,
    csa=None,
    zeta: float = 1.0,
    use_s2fast: bool = True,
    n_components: Optional[int] = None,
    chisq_threshold: float = 0.5,
    names=None,
) -> FlagshipRates:
    """The FLAGSHIP post-stream physics, residues sharded over the mesh:

    pooled Palmer stats -> DoF-ladder model selection -> axisymmetric/
    ellipsoid/isotropic J with per-residue PAF vector ensembles +
    weights -> legacy-semantics ensemble rates — i.e. exactly what
    ``stage_fit_ct`` + ``stage_relax`` compute single-device (reference
    workhorse: spectral_densities.py:2057-2077 symmtop J,
    fitting_Ct_functions.py:278-304 ladder).

    The ladder's per-residue model SELECTION is ragged host logic
    (reference :283-304); everything numeric runs sharded: the pooled
    stats on the "res"-sharded accumulators, each ladder rung's dense
    batched LM over mesh-sharded residues (per-rung is the default;
    ``fit_ct_ladder(stacked=True)`` remains available), and the final ensemble-rate jit with residues +
    vector samples sharded over all devices.

    diffusion : models.Diffusion (any kind; anisotropic kinds need vecs).
    vecs      : (nRes, nSamp, 3) PAF vector ensemble (or (nRes, 3)).
    weights   : (nRes, nSamp) ensemble weights or None.
    """
    from ..fit.expfit import fit_ct_ladder
    from ..ops import observables as obs
    from .mesh import fetch

    pair = pair or _default_pair()

    # 1. Pooled statistics, computed where the accumulators live.
    # ``fetch`` (not np.asarray): on a mesh spanning several PROCESSES
    # the pooled matrices are not locally addressable and must be
    # all-gathered for the host-facing return (single-process: plain
    # np.asarray, no extra transfer).
    mean, dct = _cached_jit(
        "pooled_stats", lambda: jax.jit(autocorr.palmer_pooled_stats)
    )(acc_s, acc_s2, count)
    Ct = fetch(mean)[:n_res]
    dCt = fetch(dct)[:n_res]
    n_deltas = Ct.shape[1]
    dt = (np.arange(n_deltas, dtype=Ct.dtype) + 1.0) * delta_t

    # 2. DoF ladder, residue-sharded (SEM-weighted like stage_fit_ct).
    # NaN dCt columns (single-chunk streams, the count==1 sqrt(n)-1
    # quirk) are sanitised INSIDE fit_ct_ladder's sigma canonicalisation
    # — the single home of that guard.
    # The ladder is fed the DEVICE-resident slices (Ct/dCt were fetched
    # only for the host-facing return), so the (nRes, nDeltas) matrix is
    # not shipped back to the device.
    if names is None:
        names = [str(i) for i in range(n_res)]
    cts = fit_ct_ladder(
        names=names,
        dt=dt,
        decays=mean[:n_res],
        ddecays=dct[:n_res],
        use_s2fast=use_s2fast,
        n_components=n_components,
        chisq_threshold=chisq_threshold,
        zeta=zeta,
        mesh=mesh,
    )

    # 3. Ensemble rates with residues sharded over every device; the
    # sample axis stays local so the ensemble mean/sd needs no collective.
    # Residues pad to a device-count multiple (row-0 copies) and slice
    # back (parallel.mesh.pad_and_shard).
    from .mesh import pad_and_shard

    def put(a):
        if a is None:
            return None
        a = a if isinstance(a, jax.Array) else np.asarray(a)
        if a.ndim == 0:
            # predict_rates accepts a scalar csa; give it a residue axis
            # so it pads/shards like the per-residue arrays.
            a = jnp.full((n_res,), a)
        (out,), _ = pad_and_shard(mesh, [a])
        return out

    vecs_d = put(vecs)
    w_d = put(weights)
    csa_d = put(csa)
    pad = (-n_res) % int(mesh.devices.size)
    idx = np.concatenate([np.arange(n_res), np.zeros(pad, dtype=int)])
    cts_pad = cts.select(idx) if pad else cts

    # Cached per pair VALUE (NucleusPair is a frozen dataclass, hashable
    # by value): a fresh jax.jit wrapper each call would retrace the
    # whole ensemble-rates program on every invocation.
    # Diffusion is passed as a jit ARGUMENT, not closed over: it is a
    # registered pytree (kind static, tensor values dynamic), so a
    # global-fit loop feeding fresh Diffusion objects per trial reuses
    # ONE compiled program, and in-place mutation cannot serve stale
    # values out of a baked-in closure.
    def _make_rates():
        def _rates_fn(diffusion_, cts_, vecs_, w_, csa_):
            return obs.predict_rates(
                pair, diffusion_, cts_, vecs=vecs_, weights=w_, csa=csa_
            )

        return jax.jit(_rates_fn)

    rates = _cached_jit(("rates", pair), _make_rates)(
        diffusion, cts_pad, vecs_d, w_d, csa_d
    )
    return FlagshipRates(
        Ct, dCt, cts,
        *(None if x is None else fetch(x)[:n_res]
          for x in (rates.R1, rates.R2, rates.NOE, rates.rho,
                    rates.dR1, rates.dR2, rates.dNOE, rates.drho)),
    )


def run_streamed_pipeline(chunk_iter, mesh: Mesh, n_frames_per_chunk: int,
                          n_res: int, delta_t: float = 1.0,
                          tau_iso: float = 4242.0, n_components: int = 2,
                          dtype=None) -> StreamedRates:
    """End-to-end sharded streaming run: consume an iterator of
    (g, F, nRes, 3) Palmer-chunk groups, then fit + predict rates.
    dtype defaults to the first group's (f64 in CPU parity mode, f32 on
    the accelerator).  Returns host-ready StreamedRates sliced to the true n_res."""
    stream = None
    for group in chunk_iter:
        if stream is None:
            # np.result_type avoids device_put-ing the whole first
            # group unsharded onto one device just to read a dtype
            # (a production group can be ~1 GB).
            dt_eff = dtype or np.result_type(group)
            stream = ShardedCtStream(mesh, n_frames_per_chunk, n_res,
                                     dtype=dt_eff)
        stream.update(group)
    if stream is None:
        raise ValueError("empty chunk iterator")
    finish = make_sharded_finish(
        mesh, delta_t=delta_t, tau_iso=tau_iso, n_components=n_components
    )
    out = finish(*stream.accumulators())
    return StreamedRates(*(np.asarray(x)[:n_res] for x in out))
