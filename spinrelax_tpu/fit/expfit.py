"""Multi-exponential C(t) fitting with the reference's DoF-ladder model
selection — vectorised.

The reference fits each residue sequentially through increasing degrees of
freedom [2,3,5,7,9] (or [2,4,6,8] without S2_fast), stopping when quality
checks fail or chi-square stops improving by >2x
(fitting_Ct_functions.py:278-304).  Here every rung of the ladder is fit
for ALL residues as one batched LM call; the sequential selection rules
are then applied per-residue on the host (fixed shapes under jit, ragged
decisions outside).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..models.ctmodel import CtModelSet
from .lm import (  # noqa: F401 (fit_multiexp is part of the public surface)
    fit_multiexp, fit_multiexp_ladder, fit_multiexp_stacked,
    fit_multiexp_varpro, fit_multiexp_warm,
)

LADDER_WITH_FAST = (2, 3, 5, 7, 9)
LADDER_NO_FAST = (2, 4, 6, 8)

# jit cache for the pack-fit wrappers (one per (fit_fn, K, s2_free)).
_PACKED_CACHE: dict = {}


def _packed_fit(fit_fn, dt_arr, dec, sig, K: int, s2_free: bool,
                n_starts: int = 1):
    """Run one rung's batched fit and return ONE packed (B, 4K+6) device
    array [C | tau | dC | dtau | S2 dS2 chisq ok_fit ok_err ok_sum].

    Every ``np.asarray`` fetch is a blocking device round trip, so
    fetching the 10 MultiExpFit leaves separately costs ten of them;
    packing on device makes it one dispatch + one fetch."""
    import jax
    import jax.numpy as jnp

    key = (fit_fn, K, s2_free, n_starts)
    if key not in _PACKED_CACHE:
        kw = {"n_starts": n_starts} if n_starts > 1 else {}

        def run(dtv, d, s):
            f = fit_fn(dtv, d, s, K=K, s2_free=s2_free, **kw)
            cols = [f.C, f.tau, f.dC, f.dtau,
                    f.S2[:, None], f.dS2[:, None], f.chisq[:, None],
                    f.ok_fit[:, None].astype(d.dtype),
                    f.ok_err[:, None].astype(d.dtype),
                    f.ok_sum[:, None].astype(d.dtype)]
            return jnp.concatenate(cols, axis=1)

        _PACKED_CACHE[key] = jax.jit(run)
    return _PACKED_CACHE[key](dt_arr, dec, sig)


def _unpack_fit(packed, K: int) -> dict:
    """Host-side inverse of :func:`_packed_fit` (one fetch happens here).
    ``fetch`` (not ``np.asarray``) so a mesh spanning several PROCESSES
    (multi-host ladder, tools/multihost_worker.py --flagship) can gather
    the rung results each process's selection walk needs."""
    from ..parallel.mesh import fetch

    a = fetch(packed)
    return {
        "C": a[:, :K],
        "tau": a[:, K:2 * K],
        "dC": a[:, 2 * K:3 * K],
        "dtau": a[:, 3 * K:4 * K],
        "S2": a[:, 4 * K],
        "dS2": a[:, 4 * K + 1],
        "chisq": a[:, 4 * K + 2],
        "ok_fit": a[:, 4 * K + 3] > 0.5,
        "ok_err": a[:, 4 * K + 4] > 0.5,
        "ok_sum": a[:, 4 * K + 5] > 0.5,
    }


def _packed_fit_warm(dt_arr, dec, sig, C0, tau0, S20, K: int, s2_free: bool):
    """Warm-start analogue of :func:`_packed_fit` (same one-dispatch/
    one-fetch packing) over :func:`fit_multiexp_warm`."""
    import jax
    import jax.numpy as jnp

    key = ("warm", K, s2_free)
    if key not in _PACKED_CACHE:
        def run(dtv, d, s, c0, t0, s20):
            f = fit_multiexp_warm(dtv, d, s, c0, t0, s20, K=K, s2_free=s2_free)
            cols = [f.C, f.tau, f.dC, f.dtau,
                    f.S2[:, None], f.dS2[:, None], f.chisq[:, None],
                    f.ok_fit[:, None].astype(d.dtype),
                    f.ok_err[:, None].astype(d.dtype),
                    f.ok_sum[:, None].astype(d.dtype)]
            return jnp.concatenate(cols, axis=1)

        _PACKED_CACHE[key] = jax.jit(run)
    return _PACKED_CACHE[key](dt_arr, dec, sig, C0, tau0, S20)


def _warm_p0(prev_fit, retry, K_p: int, K: int, s2_free: bool,
             decays_np, step: float):
    """Initial parameters for the warm-start retry: the previous rung's
    accepted solution plus K-K_p fresh components at the FAST end of the
    timescale window (log-midpoints between the grid step and the
    fastest accepted tau).  The fresh amplitude is the unexplained
    zero-time residual (mean of the first 10 points minus the model's
    t->0 limit), capped so the pre-fit sum>1 quirk gate
    (fitting_Ct_functions.py:336-338 via _finalise_multiexp) cannot
    spuriously reject the restart."""
    Cp = prev_fit["C"][retry][:, :K_p]
    taup = prev_fit["tau"][retry][:, :K_p]
    S2p = prev_fit["S2"][retry]
    d = K - K_p
    if d > 0:
        tmin = np.maximum(taup.min(axis=1), step * 1.01)
        newtau = np.exp(
            np.linspace(np.log(np.full_like(tmin, step)), np.log(tmin),
                        d + 2, axis=-1)
        )[:, 1:-1]
        avg_beg = decays_np[retry, :10].mean(axis=1)
        resid = np.maximum(avg_beg - S2p - Cp.sum(axis=1), 1e-4)
        resid = np.minimum(resid, np.maximum(1.0 - S2p - Cp.sum(axis=1), 1e-6))
        newC = np.repeat((resid / d)[:, None], d, axis=1)
        C0 = np.concatenate([newC, Cp], axis=1)
        tau0 = np.concatenate([newtau, taup], axis=1)
    else:
        C0, tau0 = Cp, taup
    S20 = S2p if s2_free else 1.0 - C0.sum(axis=1)
    return C0, tau0, S20


def _chisq_outlier_rows(sel_chi: np.ndarray, cap: int) -> np.ndarray:
    """Rows whose selected chisq is a >5x-median outlier — the trigger of
    the post-walk escalation arm — subject to the same isolated-rows
    ceiling as the warm-retry arm: when MORE than ``cap`` rows are
    "outliers" the sigmas are systematically mis-scaled (heavy-tailed
    but converged chisq) rather than sparse local-minimum accidents, and
    retry_starts-sized refits of that many rows would reproduce the
    wall-time blowup the warm-retry cap exists to prevent, for adoptions
    that almost never fire — so nothing is flagged (ADVICE round 4)."""
    B = sel_chi.shape[0]
    finite = np.isfinite(sel_chi)
    if not np.any(finite):
        return np.zeros(B, bool)
    med = float(np.median(sel_chi[finite]))
    if med <= 0:
        return np.zeros(B, bool)
    flagged = finite & (sel_chi > 5.0 * med)
    if int(flagged.sum()) > cap:
        return np.zeros(B, bool)
    return flagged


def _rung_spec(n_params: int):
    """nParams -> (K, s2_free) following set_nParams
    (fitting_Ct_functions.py:376-382)."""
    return n_params // 2, (n_params % 2 == 1)


def fit_ct_ladder(
    names: Sequence[str],
    dt: np.ndarray,
    decays: np.ndarray,
    ddecays: Optional[np.ndarray] = None,
    use_s2fast: bool = True,
    chisq_threshold: float = 0.5,
    n_components: Optional[int] = None,
    zeta: float = 1.0,
    verbose: bool = False,
    mesh=None,
    stacked: bool = False,
    optimiser: str = "lm",
    early_stop: bool = True,
    warm_retry: bool = True,
    n_starts: int = 1,
    retry_starts: int = 8,
    pipeline_rungs: bool = False,
    in_graph="auto",
) -> CtModelSet:
    """Fit all residues' C(t) and select per-residue model complexity.

    Parameters
    ----------
    dt      : (T,) lag times.
    decays  : (B, T) decay curves.
    ddecays : (B, T) uncertainties or None.
    n_components : fix the number of transient components (bypasses the
        ladder), mirroring ``calculate-fitted-Ct.py --nc``.
    optimiser : "lm" (default; curve_fit-parity joint LM) or "varpro"
        (variable projection: closed-form amplitudes per tau step —
        faster, but unconstrained amplitudes; see fit_multiexp_varpro).
    n_starts : batched multi-start for the "lm" optimiser's rungs (see
        fit_multiexp): n_starts-1 deterministic extra tau starts per
        residue per rung, best cost wins, exact ties keep the cold
        start.  n_starts=1 (default) is the reference's single cold
        start; 8 beat scipy's TRF robustness on the hard-mix cohort at
        ~n_starts x the rung compute.  Not supported for "varpro".
    warm_retry : before ending a residue's walk at a rung whose fit
        FAILED ITS QUALITY CHECKS (collapsed components with
        dParam > param, non-finite params — NOT the natural chi-stall
        stop every walk ends with), refit that rung ONCE from the
        previous rung's accepted solution plus one fresh fast component.
        scipy's TRF escapes local minima the cold-started joint LM can
        fall into (two components collapsing onto one timescale while a
        barely-sampled fast component goes unmodelled); the retry is
        adopted only if it passes the SAME gates the cold fit faced, so
        it converges our selection TOWARD the reference's on exactly the
        rows where the optimisers disagreed, at zero cost on clean
        workloads (quality failures are rare; chi-stall breaks are not
        retried — measured ~10x ladder wall when they were).  ``False``
        restores the single-attempt walk.
    retry_starts : multi-start escalation for the SAME quality-failure
        gate (default-on robustness): the flagged rows are ALSO refit
        cold with ``retry_starts`` batched starts (see ``n_starts``) and
        the best gate-passing candidate of {warm retry, multi-start}
        wins.  A second arm re-fits rows whose SELECTED chisq is a
        >5x-median outlier (weighted fits only — unweighted chisq is not
        comparable across residues), adopted only on strict improvement
        at the same rung so selection never changes.  This buys the
        reference's scipy-TRF selection quality on adjacent-timescale
        mixes WITHOUT the ~retry_starts x rung cost of a global
        ``n_starts``: only ISOLATED flagged rows pay (quality failures
        affecting > max(256, B/8) rows are the ladder's natural
        complexity ceiling and are not escalated).  1 disables; no
        effect unless it exceeds ``n_starts``; "lm" optimiser only
        (ignored for varpro, whose amplitudes are closed-form per tau
        start already).
    early_stop : fit each rung only on the residues whose selection walk
        is still descending the ladder (exact reference semantics — a
        residue that has broken out never consults later rungs,
        fitting_Ct_functions.py:283-304 — so skipped fits can never be
        read).  The expensive high-K rungs then run on a shrinking
        batch; the selected models are identical because every LM lane
        is batch-composition-independent (lm_solve freezes converged
        lanes).  ``False`` forces the former fit-every-rung-for-everyone
        behaviour (the A/B hook for tests).
    in_graph : "auto" (default) / True / False.  When active (requires
        optimiser="lm", stacked=False), the ENTIRE ladder — every rung's
        cold batched LM and the per-residue selection walk — runs as ONE
        jitted device program with one packed fetch (fit.walk), instead
        of one dispatch + blocking fetch + host selection pass PER RUNG
        (five sequential device round trips).  Lanes whose walk has
        ended enter later rungs
        frozen.  The rare data-dependent escalations (warm retry /
        multi-start / chisq outliers) stay host-side: the walk flags
        quality-failure rows and the host re-runs the per-rung walk on
        just those rows with the full-cohort caps, reproducing the host
        path's semantics exactly (pinned by tests/test_walk.py).
        ``False`` forces the former per-rung host walk.
    pipeline_rungs : dispatch rung i+1 speculatively on rung i's active
        set before rung i's blocking fetch.  Selected models are
        identical (broken rows' speculative fits are discarded unread;
        LM lanes are batch-composition-independent) — but it defaults
        OFF: the device executes its queue in order, so rung i's packed
        fetch waits behind the whole speculative rung i+1 (and any
        retry dispatches queue behind that too); it was measured
        slower on the accelerator it was written for.  Not measured on
        a GPU.

    Returns a CtModelSet padded to the largest selected K.
    """
    if optimiser not in ("lm", "varpro"):
        raise ValueError(f"unknown optimiser {optimiser!r} (lm|varpro)")
    if optimiser == "varpro" and stacked:
        raise ValueError("optimiser='varpro' uses per-rung solves (stacked=False)")
    if n_starts > 1 and (optimiser != "lm" or stacked):
        raise ValueError("n_starts > 1 requires optimiser='lm', stacked=False")
    import jax.numpy as jnp

    # Commit the decay matrix to the device ONCE and reuse it for every
    # ladder rung (a numpy round-trip would re-ship the (B, T) decays AND
    # a same-shaped ones-sigma per rung).  ``dtype=float`` canonicalises
    # exactly like np.asarray(..., dtype=float): f64 under x64 (tests),
    # f32 in production.
    dec_d = jnp.asarray(decays, dtype=float)
    B = dec_d.shape[0]
    if ddecays is None:
        sig_d = jnp.ones_like(dec_d)
    else:
        # sg > 0 (not sg <= 0) so NaN sigmas ALSO fall back to weight 1:
        # a single-Palmer-chunk stream has dCt = NaN everywhere (the
        # deliberate count==1 sqrt(n)-1 quirk of palmer_pooled_stats),
        # and NaN passes a <=0 test — every caller would silently fit
        # all-NaN.  This is the single home of that guard (callers must
        # not pre-sanitise).
        sg = jnp.asarray(ddecays, dtype=float)
        sig_d = jnp.where(sg > 0, sg, jnp.ones((), dec_d.dtype))

    if n_components is not None:
        ladder = [2 * n_components + 1 if use_s2fast else 2 * n_components]
    else:
        ladder = list(LADDER_WITH_FAST if use_s2fast else LADDER_NO_FAST)

    # Each rung is a dense vmapped LM over all residues (reference fits
    # rungs sequentially PER RESIDUE, fitting_Ct_functions.py:278-304).
    # ``stacked=True`` instead solves every rung in ONE padded batched LM
    # (fit.lm.fit_multiexp_stacked) — slower for the ladder but the right
    # tool for heterogeneous per-residue model batches.
    specs = [(n_par, *_rung_spec(n_par)) for n_par in ladder]
    Kmax_l = max(K for _, K, _ in specs)
    R = len(specs)
    dt_arr = np.asarray(dt, dtype=float)

    use_walk = (
        in_graph is True
        or (in_graph == "auto" and optimiser == "lm" and not stacked)
    )
    if use_walk and in_graph is True and (optimiser != "lm" or stacked):
        raise ValueError("in_graph=True requires optimiser='lm', "
                         "stacked=False")
    if use_walk:
        return _ladder_via_walk(
            names, dt_arr, dec_d, sig_d, specs, Kmax_l,
            chisq_threshold=chisq_threshold, zeta=zeta, verbose=verbose,
            mesh=mesh, warm_retry=warm_retry, n_starts=n_starts,
            retry_starts=retry_starts, weighted=ddecays is not None,
        )
    if stacked:
        # tau0 grid / stack size: consumed only by the stacked solves
        # (host-side numpy: the stacked branches tile on the host).
        decays = np.asarray(dec_d)
        sigma = np.asarray(sig_d)
        step = float(np.mean(dt_arr[1:] - dt_arr[:-1]))
        tau0_rows = np.full((R, Kmax_l), dt_arr[-1])
        for i, (_, K, _) in enumerate(specs):
            tau0_rows[i, :K] = np.logspace(
                np.log10(step), np.log10(dt_arr[-1] * 2.0), K + 2
            )[1:-1]
        n_stack = R * B
    if not stacked:
        # DEFAULT: one dense vmapped LM per rung.  The all-rungs-stacked
        # solve pads every rung to Kmax params and gates the shared
        # while_loop on the globally slowest element, which cost far more
        # than the 4 saved dispatches where it was measured — it remains
        # available via ``stacked=True`` / fit.lm.fit_multiexp_stacked
        # for heterogeneous per-residue model batches.
        #
        # The reference's per-residue selection walk STOPS descending the
        # ladder once a rung fails its checks or stops improving chisq
        # (fitting_Ct_functions.py:283-304) — later rungs are never
        # consulted for that residue.  With ``early_stop`` each rung is
        # therefore fit only over the still-active residues: the
        # expensive high-K rungs (the P^2-scaling jacfwd + normal
        # equations dominate) run on a shrinking
        # batch, and a rung with no active residues is skipped outright.
        # Results are identical to fitting every rung for everyone
        # because each vmapped LM lane is batch-composition-independent
        # (lm_solve freezes converged lanes).
        if mesh is not None:
            from ..parallel.mesh import pad_and_shard

            sharded_full = pad_and_shard(mesh, [dec_d, sig_d])[0]
        fit_fn = fit_multiexp_varpro if optimiser == "varpro" else fit_multiexp
        sel_idx = np.full(B, -1, dtype=int)
        sel_chi = np.full(B, np.inf)
        active = np.arange(B)
        rungs = []

        def _gather_args(act):
            """(idx, dec_i, sig_i) for a rung fit over the rows in act.

            Active rows gather into a power-of-two bucket (copies of the
            first active row, discarded) so the jit cache stays bounded
            at ~log2(B) shapes per rung spec; the 256 floor keeps the
            deep-rung shapes STABLE between runs whose tail counts
            jitter (a fresh shape is a full recompile)."""
            if early_stop and act.size < B:
                bucket = 256
                while bucket < act.size:
                    bucket *= 2
                bucket = min(bucket, B)
                idx = np.concatenate(
                    [act, np.full(bucket - act.size, act[0])]
                )
                dec_i, sig_i = dec_d[idx], sig_d[idx]
                if mesh is not None:
                    (dec_i, sig_i), _ = pad_and_shard(mesh, [dec_i, sig_i])
            elif mesh is not None:
                idx = None
                dec_i, sig_i = sharded_full
            else:
                idx = None
                dec_i, sig_i = dec_d, sig_d
            return idx, dec_i, sig_i

        def _dispatch(j, act):
            """Enqueue rung j's batched LM over act (async: jax returns
            before the device finishes) -> (rows_covered, packed)."""
            _np, Kj, s2fj = specs[j]
            idx, dec_i, sig_i = _gather_args(act)
            packed = _packed_fit(fit_fn, dt_arr, dec_i, sig_i, Kj, s2fj,
                                 n_starts=n_starts)
            return (act.copy() if idx is not None else None), packed

        # Optional one-deep speculative pipeline over the sequential
        # rung walks (pipeline_rungs; DEFAULT OFF, see the docstring):
        # rung i+1
        # dispatched on rung i's active set before rung i's blocking
        # fetch.  Rows that break at rung i still get a speculative
        # rung-i+1 fit — discarded unread: the walk never consults
        # them, and every other row's fit is unchanged because each
        # vmapped LM lane is batch-composition-independent (the same
        # guarantee early_stop already relies on).
        pending = {}
        for i, (n_par, K, s2_free) in enumerate(specs):
            if early_stop and active.size == 0:
                # Every residue's walk has ended; this rung can never be
                # consulted (the selection below never reaches it).  A
                # speculative dispatch for it is dropped unfetched.
                pending.pop(i, None)
                rungs.append((n_par, K, s2_free, None))
                continue
            if i not in pending:
                pending[i] = _dispatch(i, active)
            if pipeline_rungs and i + 1 < R:
                pending[i + 1] = _dispatch(i + 1, active)
            rows_cov, packed = pending.pop(i)
            fit = _unpack_fit(packed, K)
            if rows_cov is None:
                fit = {k: v[:B] for k, v in fit.items()}
            else:
                # Scatter the covered-row results back to full-B arrays;
                # unfitted rows stay NaN/False and are unreachable by the
                # selection walk (they broke on an earlier rung).
                scat = {}
                for k, v in fit.items():
                    full = np.full(
                        (B,) + v.shape[1:],
                        False if v.dtype == np.bool_ else np.nan,
                        dtype=v.dtype,
                    )
                    full[rows_cov] = v[: rows_cov.size]
                    scat[k] = full
                fit = scat
            rungs.append((n_par, K, s2_free, fit))
            if verbose:
                chis_act = fit["chisq"][active]
                print(
                    f"    ...ladder rung nParams={n_par}: "
                    f"{active.size}/{B} residues active, median chisq "
                    f"{np.median(chis_act):.3g}"
                )
            # Incremental selection walk over the active rows — the exact
            # vectorisation of fitting_Ct_functions.py:283-304 (incl. the
            # NaN-chisq comparison semantics: NaN >= x is False, so a
            # finite-params/NaN-chisq rung is adopted, as the reference's
            # float comparison would).
            ok = (
                fit["ok_fit"][active]
                & fit["ok_err"][active]
                & fit["ok_sum"][active]
            )
            chi = fit["chisq"][active]
            unset = sel_idx[active] < 0
            brk = ~unset & (~ok | (chi >= sel_chi[active] * chisq_threshold))
            take = ok & ~brk
            # Warm-retry ONLY quality-failure breaks (~ok: the LM landed
            # in a rejected configuration — collapsed components with
            # dParam > param, non-finite params).  A chi-stall break is
            # the ladder's NATURAL stop: every residue ends its walk
            # with one, so retrying those would re-fit ~all residues one
            # extra rung per walk (extra rung-sized LM dispatches +
            # per-break-pattern bucket recompiles on fresh inputs, a
            # multiple of the ladder wall) for retries that almost
            # never halve chi — the cold fit already converged into the
            # same basin it would restart near.
            retriable = brk & ~ok
            # ... and only ISOLATED failures (<= max(256, B/8) rows).
            # When a large fraction of the cohort fails a rung's gates
            # the data has hit its natural complexity ceiling (e.g.
            # every 2-exp residue collapsing the 3rd component): those
            # breaks are CORRECT, the retries almost never pass the
            # chi-halving gate, and the extra rung-sized refits roughly
            # doubled the 1e4-residue ladder wall.  The local-minimum
            # accidents the retry exists for are sparse by nature
            # (hard-mix cohort: ~15% of rows).
            if warm_retry and i > 0 and np.any(retriable) \
                    and int(retriable.sum()) <= max(256, B // 8) \
                    and rungs[i - 1][3] is not None:
                # Second chance for quality-failed rows: refit from the
                # previous rung's solution (their sel_idx is i-1 by
                # construction — a non-unset row only stays active by
                # taking every rung since its first ok fit).
                retry = active[retriable]
                K_p, s2f_p = specs[i - 1][1], specs[i - 1][2]
                n_beg = min(10, dec_d.shape[1])
                beg = np.zeros((B, n_beg))
                from ..parallel.mesh import fetch as _fetch

                bucket = 256
                while bucket < retry.size:
                    bucket *= 2
                bucket = min(bucket, max(B, 256))
                pad = bucket - retry.size
                idx_w = np.concatenate([retry, np.full(pad, retry[0])])
                # Gather with the BUCKETED index (stable pow-2 shapes):
                # the raw retry-sized gather changed shape every call as
                # the retriable count jittered, and each fresh eager-op
                # shape is a recompile.
                beg[retry] = _fetch(dec_d[idx_w, :n_beg])[: retry.size]
                C0, tau0, S20 = _warm_p0(
                    rungs[i - 1][3], retry, K_p, K, s2_free, beg,
                    float(np.mean(dt_arr[1:] - dt_arr[:-1])),
                )
                wargs = [dec_d[idx_w], sig_d[idx_w],
                         np.concatenate([C0, np.repeat(C0[:1], pad, 0)]),
                         np.concatenate([tau0, np.repeat(tau0[:1], pad, 0)]),
                         np.concatenate([S20, np.repeat(S20[:1], pad)])]
                if mesh is not None:
                    wargs, _ = pad_and_shard(mesh, wargs)
                # Both retry arms dispatch back-to-back BEFORE either
                # blocking fetch, so the round trips overlap the device
                # work instead of serialising after it.
                escalate = (
                    optimiser == "lm" and retry_starts > max(n_starts, 1)
                )
                packed_w = _packed_fit_warm(dt_arr, *wargs, K, s2_free)
                packed_m = _packed_fit(
                    fit_fn, dt_arr, wargs[0], wargs[1], K, s2_free,
                    n_starts=retry_starts,
                ) if escalate else None
                wfit = _unpack_fit(packed_w, K)
                resc = {k: v[: retry.size].copy() for k, v in wfit.items()}
                ok_r = resc["ok_fit"] & resc["ok_err"] & resc["ok_sum"]
                if escalate:
                    # Multi-start escalation on the SAME flagged rows: a
                    # cold refit from retry_starts deterministic starts
                    # (the lever that reproduces scipy-TRF selection on
                    # adjacent-timescale mixes) — best gate-passing
                    # candidate wins.
                    mfit = _unpack_fit(packed_m, K)
                    mfit = {k: v[: retry.size] for k, v in mfit.items()}
                    ok_m = mfit["ok_fit"] & mfit["ok_err"] & mfit["ok_sum"]
                    use_m = ok_m & (~ok_r | (mfit["chisq"] < resc["chisq"]))
                    if np.any(use_m):
                        for k in resc:
                            resc[k][use_m] = mfit[k][use_m]
                        ok_r = ok_r | use_m
                acc = ok_r & (resc["chisq"] < sel_chi[retry] * chisq_threshold)
                if np.any(acc):
                    rows_acc = retry[acc]
                    for k, v in fit.items():
                        # _unpack_fit views of a fetched device buffer
                        # are read-only; rungs[] holds this same dict,
                        # so reassigning the value updates the rung.
                        if not v.flags.writeable:
                            v = v.copy()
                        v[rows_acc] = resc[k][acc]
                        fit[k] = v
                    pos = np.nonzero(retriable)[0][acc]
                    brk[pos] = False
                    take[pos] = True
                    chi = chi.copy()
                    chi[pos] = resc["chisq"][acc]
            rows = active[take]
            sel_idx[rows] = i
            sel_chi[rows] = chi[take]
            # A broken row's walk has ended regardless of early_stop
            # (early_stop only controls whether later rungs still FIT the
            # broken rows, never whether they are consulted).
            active = active[~brk]
    elif mesh is None:
        # In-graph rung tiling: decays/sigma ship to the device ONCE
        # (the host-side 5x tile dominated wall time on remote links).
        stacked_np = jax_to_np(fit_multiexp_ladder(
            dt_arr, decays, sigma, tau0_rows,
            tuple((K, s2f) for _, K, s2f in specs), Kmax=Kmax_l,
        ))
    else:
        # Residue-shard the stacked batch over EVERY mesh axis: the LM is
        # embarrassingly parallel over batch elements, so GSPMD partitions
        # the whole solve with zero communication (SURVEY §2.5 "residue
        # tensor-parallel"); pad_and_shard pads to a device multiple and
        # the results slice back to n_stack rows.
        from ..parallel.mesh import pad_and_shard

        stack_args, _ = pad_and_shard(mesh, [
            np.tile(decays, (R, 1)),
            np.tile(sigma, (R, 1)),
            np.repeat([K for _, K, _ in specs], B),
            np.repeat([s2f for _, _, s2f in specs], B),
            np.repeat(tau0_rows, B, axis=0),
        ])
        out = fit_multiexp_stacked(dt_arr, *stack_args, Kmax=Kmax_l)
        stacked_np = {k: v[:n_stack] for k, v in jax_to_np(out).items()}
    if stacked:
        rungs = []
        for i, (n_par, K, s2_free) in enumerate(specs):
            fit = {k: v[i * B : (i + 1) * B] for k, v in stacked_np.items()}
            rungs.append((n_par, K, s2_free, fit))
            if verbose:
                print(
                    f"    ...ladder rung nParams={n_par}: median chisq "
                    f"{np.median(fit['chisq']):.3g}"
                )

    # Post-walk chisq-outlier escalation (second arm of retry_starts):
    # a cold single-start LM can land in a bad local minimum that PASSES
    # the quality gates (collapsed-adjacent-timescale fits with finite
    # errors) — the walk then keeps the right K but 10-50x the chi of
    # the reference's TRF solution.  Rows whose SELECTED chisq is an
    # outlier against the cohort are refit with the same batched
    # multi-start and adopted only on a strict chisq improvement at the
    # SAME rung, so model selection is unchanged by construction (a
    # lower sel_chi can only make the already-taken break at the next
    # rung harder to un-take).  WEIGHTED fits only (ddecays given):
    # without per-point sigmas chisq is a raw SSR whose magnitude
    # varies legitimately across residues, so the cross-residue median
    # rule would flag thousands of perfectly-converged rows (measured
    # on the unweighted 1e4-residue bench).  Clean weighted workloads
    # flag ~nothing.
    if (not stacked and optimiser == "lm" and ddecays is not None
            and retry_starts > max(n_starts, 1) and B > 1):
        flagged = _chisq_outlier_rows(sel_chi, max(256, B // 8))
        if np.any(flagged):
            for i, (n_par, K, s2_free, fit) in enumerate(rungs):
                rows = np.nonzero(flagged & (sel_idx == i))[0]
                if rows.size == 0 or fit is None:
                    continue
                bucket = 256
                while bucket < rows.size:
                    bucket *= 2
                bucket = min(bucket, max(B, 256))
                idx_f = np.concatenate(
                    [rows, np.full(bucket - rows.size, rows[0])]
                )
                fargs = [dec_d[idx_f], sig_d[idx_f]]
                if mesh is not None:
                    from ..parallel.mesh import pad_and_shard

                    fargs, _ = pad_and_shard(mesh, fargs)
                mfit = _unpack_fit(
                    _packed_fit(fit_multiexp, dt_arr, *fargs, K, s2_free,
                                n_starts=retry_starts), K
                )
                mfit = {k: v[: rows.size] for k, v in mfit.items()}
                ok_m = mfit["ok_fit"] & mfit["ok_err"] & mfit["ok_sum"]
                better = ok_m & (mfit["chisq"] < sel_chi[rows])
                if np.any(better):
                    rows_b = rows[better]
                    for k, v in fit.items():
                        if not v.flags.writeable:
                            v = v.copy()
                        v[rows_b] = mfit[k][better]
                        fit[k] = v
                    sel_chi[rows_b] = mfit["chisq"][better]

    # Per-residue sequential selection (fitting_Ct_functions.py:283-304).
    if not stacked:
        # Already walked incrementally alongside the rung fits above.
        sel = sel_idx
    else:
        sel = np.full(B, -1, dtype=int)
        for b in range(B):
            prev_idx = -1
            prev_chi = np.inf
            for idx, (n_par, K, s2_free, fit) in enumerate(rungs):
                ok = fit["ok_fit"][b] and fit["ok_err"][b] and fit["ok_sum"][b]
                chi = fit["chisq"][b]
                if prev_idx < 0:
                    if ok:
                        prev_idx, prev_chi = idx, chi
                    continue
                if not ok:
                    break
                if chi >= prev_chi * chisq_threshold:
                    break
                prev_idx, prev_chi = idx, chi
            sel[b] = prev_idx
    for b in np.nonzero(sel < 0)[0]:
        # No rung passed all checks: keep the best-chisq rung anyway
        # (the reference errors out; we degrade gracefully and flag
        # via chisq=inf semantics upstream).  Such residues never break
        # out of the walk, so every rung was fitted for them (a skipped
        # rung is None only when NO residue was still walking).
        chis_b = np.asarray(
            [r[3]["chisq"][b] if r[3] is not None else np.nan for r in rungs],
            float,
        )
        # nanargmin: a diverged rung's NaN chisq must not win over a
        # finite fit (np.argmin([nan, ...]) returns the NaN index).
        sel[b] = (
            int(np.nanargmin(chis_b))
            if np.any(np.isfinite(chis_b)) else 0
        )

    # Vectorised model assembly: one fancy-indexed gather per rung instead
    # of a per-residue Python loop + from_lists (the loop was a visible
    # share of the staged ladder wall at B=1e4).  Semantics are
    # from_lists' exactly: f64 host staging (jnp.asarray canonicalises),
    # tau padding 1, zero C/mask padding, components already sorted
    # fast-to-slow inside fit_multiexp.
    Kmax = max(rungs[i][1] for i in sel)
    S2 = np.zeros(B)
    dS2 = np.zeros(B)
    chis = np.zeros(B)
    s2fasts = np.zeros(B)
    C = np.zeros((B, Kmax))
    tau = np.ones((B, Kmax))
    mask = np.zeros((B, Kmax))
    dC = np.zeros((B, Kmax))
    dtau = np.zeros((B, Kmax))
    for i, (n_par, K, s2_free, fit) in enumerate(rungs):
        rows = np.nonzero(sel == i)[0]
        if rows.size == 0:
            continue
        # [:, :K] also strips the stacked path's Kmax-wide padding
        # (the per-rung _unpack_fit arrays are already K wide).
        C[rows, :K] = fit["C"][rows][:, :K]
        tau[rows, :K] = fit["tau"][rows][:, :K]
        mask[rows, :K] = 1.0
        dC[rows, :K] = fit["dC"][rows][:, :K]
        dtau[rows, :K] = fit["dtau"][rows][:, :K]
        S2[rows] = fit["S2"][rows]
        dS2[rows] = fit["dS2"][rows]
        chis[rows] = fit["chisq"][rows]
        s2fasts[rows] = float(s2_free)

    return CtModelSet(
        S2=jnp.asarray(S2),
        C=jnp.asarray(C),
        tau=jnp.asarray(tau),
        mask=jnp.asarray(mask),
        zeta=jnp.asarray(float(zeta)),
        s2fast=jnp.asarray(s2fasts),
        dS2=jnp.asarray(dS2),
        dC=jnp.asarray(dC),
        dtau=jnp.asarray(dtau),
        chisq=jnp.asarray(chis),
        names=[str(x) for x in names],
    )


def jax_to_np(fit):
    return {k: np.asarray(v) for k, v in fit._asdict().items()}


def _ladder_via_walk(names, dt_arr, dec_d, sig_d, specs, Kmax_l, *,
                     chisq_threshold, zeta, verbose, mesh, warm_retry,
                     n_starts, retry_starts, weighted):
    """fit_ct_ladder's in-graph path: one walk dispatch + one packed
    fetch (fit.walk.fit_ct_walk), then a RESUME-style host escalation on
    exactly the rows the walk flags.

    The resume escalation replaces a full host re-walk of the flagged
    rows (whose round trips cost more than the whole walk program).
    Key observation: a warm retry at
    rung i needs only the row's PREVIOUS accepted solution — which IS
    the walk's selected output for a row that broke at rung i — plus the
    decay-head mean (packed by the walk).  So:

    - generation-0 retries (one group per first-qfail rung) are mutually
      independent: all their warm + multi-start fits dispatch
      back-to-back before any blocking fetch (round trips overlap);
    - only rows whose retry is ACCEPTED (rare) keep walking: their
      later-rung cold fits run as small bucketed host fits, and a
      second-generation quality failure joins that rung's retriable
      set, exactly like the host walk's single pass would;
    - cap semantics are host-exact: the retriable count at rung i is
      gen-0 first-failures (identical to the host walk's — a lane's
      first failure happens at the same rung in both) plus
      resumed-lane re-failures (reproduced lane-for-lane), and the
      cap/skip decision is taken on the combined count.

    Parity with the pure host path is pinned by tests/test_walk.py.
    """
    import jax.numpy as jnp

    from ..parallel.mesh import fetch
    from .walk import fit_ct_walk, unpack_walk

    B = dec_d.shape[0]
    R = len(specs)
    sp = tuple((K, s2f) for _, K, s2f in specs)
    dec_i, sig_i = dec_d, sig_d
    if mesh is not None:
        from ..parallel.mesh import pad_and_shard

        (dec_i, sig_i), _ = pad_and_shard(mesh, [dec_d, sig_d])
    packed = fit_ct_walk(dt_arr, dec_i, sig_i, chisq_threshold, sp,
                         Kmax_l, n_starts)
    w = unpack_walk(np.asarray(fetch(packed))[:B], Kmax_l, R)
    sel_idx = w["sel_idx"].astype(int)
    sel_chi = np.array(w["sel_chi"])
    selected = {
        k: np.array(w[k])
        for k in ("C", "tau", "dC", "dtau", "mask", "S2", "dS2", "chisq",
                  "s2fast")
    }
    if verbose:
        for i, (n_par, _K, _s) in enumerate(specs):
            act = w["act_rungs"][:, i] > 0
            if act.any():
                print(
                    f"    ...ladder rung nParams={n_par}: "
                    f"{int(act.sum())}/{B} residues active, median chisq "
                    f"{np.median(w['chi_rungs'][act, i]):.3g}"
                )

    cap = max(256, B // 8)
    escalate = retry_starts > max(n_starts, 1)
    qf = w["qfail"].astype(int)
    if warm_retry and np.any(qf >= 1):
        step = float(np.mean(dt_arr[1:] - dt_arr[:-1]))
        n_beg = min(10, dec_d.shape[1])
        beg_full = np.repeat(w["beg_mean"][:, None], n_beg, axis=1)

        def _dispatch(i, retry):
            """Enqueue warm + multi-start retry fits for rung i over the
            rows in ``retry`` (async; same bucketing/programs as the
            host path's arm)."""
            _np_, K, s2f = specs[i]
            K_p = specs[i - 1][1]
            bucket = 256
            while bucket < retry.size:
                bucket *= 2
            bucket = min(bucket, max(B, 256))
            pad = bucket - retry.size
            idx_w = np.concatenate([retry, np.full(pad, retry[0])])
            prev = {"C": selected["C"], "tau": selected["tau"],
                    "S2": selected["S2"]}
            C0, tau0, S20 = _warm_p0(prev, retry, K_p, K, s2f, beg_full,
                                     step)
            wargs = [dec_d[idx_w], sig_d[idx_w],
                     np.concatenate([C0, np.repeat(C0[:1], pad, 0)]),
                     np.concatenate([tau0, np.repeat(tau0[:1], pad, 0)]),
                     np.concatenate([S20, np.repeat(S20[:1], pad)])]
            if mesh is not None:
                from ..parallel.mesh import pad_and_shard

                wargs, _ = pad_and_shard(mesh, wargs)
            packed_w = _packed_fit_warm(dt_arr, *wargs, K, s2f)
            packed_m = _packed_fit(
                fit_multiexp, dt_arr, wargs[0], wargs[1], K, s2f,
                n_starts=retry_starts,
            ) if escalate else None
            return retry, packed_w, packed_m

        def _resolve(handle, K):
            """Blocking fetch + best-gate-passer merge of the two arms
            (host path's resc/ok_r rules verbatim)."""
            retry, packed_w, packed_m = handle
            wfit = _unpack_fit(packed_w, K)
            resc = {k: v[: retry.size].copy() for k, v in wfit.items()}
            ok_r = resc["ok_fit"] & resc["ok_err"] & resc["ok_sum"]
            if packed_m is not None:
                mfit = _unpack_fit(packed_m, K)
                mfit = {k: v[: retry.size] for k, v in mfit.items()}
                ok_m = mfit["ok_fit"] & mfit["ok_err"] & mfit["ok_sum"]
                use_m = ok_m & (~ok_r | (mfit["chisq"] < resc["chisq"]))
                if np.any(use_m):
                    for k in resc:
                        resc[k][use_m] = mfit[k][use_m]
                    ok_r = ok_r | use_m
            return resc, ok_r

        def _adopt(rows, vals, mask_rows, i):
            """Adopt rung i's values (a fit dict sliced to ``rows``) as
            these rows' selected model."""
            _np_, K, s2f = specs[i]
            sub = np.zeros((rows.size, Kmax_l), selected["C"].dtype)
            sub[:, :K] = vals["C"][mask_rows]
            selected["C"][rows] = sub
            sub = np.ones((rows.size, Kmax_l), selected["C"].dtype)
            sub[:, :K] = vals["tau"][mask_rows]
            selected["tau"][rows] = sub
            sub = np.zeros((rows.size, Kmax_l), selected["C"].dtype)
            sub[:, :K] = vals["dC"][mask_rows]
            selected["dC"][rows] = sub
            sub = np.zeros((rows.size, Kmax_l), selected["C"].dtype)
            sub[:, :K] = vals["dtau"][mask_rows]
            selected["dtau"][rows] = sub
            sub = np.zeros((rows.size, Kmax_l), selected["C"].dtype)
            sub[:, :K] = 1.0
            selected["mask"][rows] = sub
            selected["S2"][rows] = vals["S2"][mask_rows]
            selected["dS2"][rows] = vals["dS2"][mask_rows]
            selected["chisq"][rows] = vals["chisq"][mask_rows]
            selected["s2fast"][rows] = float(s2f)
            sel_idx[rows] = i
            sel_chi[rows] = vals["chisq"][mask_rows]

        # Phase A: pre-dispatch every generation-0 group within the cap
        # (independent of each other; round trips overlap).
        pend = {i: np.nonzero(qf == i)[0] for i in range(1, R)
                if np.any(qf == i)}
        handles = {i: _dispatch(i, rows) for i, rows in pend.items()
                   if rows.size <= cap}

        # Phase B: rung-order resolution with (rare) continuation.
        cont = np.empty(0, dtype=int)
        for i in range(1, R):
            _np_, K, s2f = specs[i]
            cont_fail = np.empty(0, dtype=int)
            if cont.size:
                # Resumed rows need rung i's cold fit (bucketed).
                bucket = 256
                while bucket < cont.size:
                    bucket *= 2
                bucket = min(bucket, max(B, 256))
                idx_c = np.concatenate(
                    [cont, np.full(bucket - cont.size, cont[0])]
                )
                fargs = [dec_d[idx_c], sig_d[idx_c]]
                if mesh is not None:
                    from ..parallel.mesh import pad_and_shard

                    fargs, _ = pad_and_shard(mesh, fargs)
                cfit = _unpack_fit(
                    _packed_fit(fit_multiexp, dt_arr, *fargs, K, s2f,
                                n_starts=n_starts), K
                )
                cfit = {k: v[: cont.size] for k, v in cfit.items()}
                ok_c = cfit["ok_fit"] & cfit["ok_err"] & cfit["ok_sum"]
                chi_c = cfit["chisq"]
                brk_c = ~ok_c | (chi_c >= sel_chi[cont] * chisq_threshold)
                take_c = ok_c & ~brk_c
                if np.any(take_c):
                    _adopt(cont[take_c], cfit, take_c, i)
                cont_fail = cont[brk_c & ~ok_c]
                cont = cont[take_c]
            g0 = pend.get(i, np.empty(0, dtype=int))
            retri = np.concatenate([g0, cont_fail])
            if retri.size == 0 or retri.size > cap:
                continue  # over-cap: natural complexity ceiling, no retry
            if cont_fail.size or i not in handles:
                handle = _dispatch(i, retri)
            else:
                handle = handles[i]
            resc, ok_r = _resolve(handle, K)
            retry = handle[0]
            acc = ok_r & (resc["chisq"] < sel_chi[retry] * chisq_threshold)
            if np.any(acc):
                rows_acc = retry[acc]
                _adopt(rows_acc, resc, acc, i)
                cont = np.concatenate([cont, rows_acc])

    # chisq-outlier escalation over the merged cohort (same trigger,
    # cap, adoption rule and refit program as the host path's arm).
    if weighted and escalate and B > 1:
        flagged = _chisq_outlier_rows(sel_chi, max(256, B // 8))
        for i, (_n_par, K, s2f) in enumerate(specs):
            rows = np.nonzero(flagged & (sel_idx == i))[0]
            if rows.size == 0:
                continue
            bucket = 256
            while bucket < rows.size:
                bucket *= 2
            bucket = min(bucket, max(B, 256))
            idx_f = np.concatenate(
                [rows, np.full(bucket - rows.size, rows[0])]
            )
            fargs = [dec_d[idx_f], sig_d[idx_f]]
            if mesh is not None:
                from ..parallel.mesh import pad_and_shard

                fargs, _ = pad_and_shard(mesh, fargs)
            mfit = _unpack_fit(
                _packed_fit(fit_multiexp, dt_arr, *fargs, K, s2f,
                            n_starts=retry_starts), K
            )
            mfit = {k: v[: rows.size] for k, v in mfit.items()}
            ok_m = mfit["ok_fit"] & mfit["ok_err"] & mfit["ok_sum"]
            better = ok_m & (mfit["chisq"] < sel_chi[rows])
            if np.any(better):
                rows_b = rows[better]
                # Same rung -> same K: the padding slots beyond K are
                # already the rung's (zero-C / one-tau) padding.
                selected["C"][rows_b, :K] = mfit["C"][better]
                selected["tau"][rows_b, :K] = mfit["tau"][better]
                selected["dC"][rows_b, :K] = mfit["dC"][better]
                selected["dtau"][rows_b, :K] = mfit["dtau"][better]
                selected["S2"][rows_b] = mfit["S2"][better]
                selected["dS2"][rows_b] = mfit["dS2"][better]
                selected["chisq"][rows_b] = mfit["chisq"][better]
                sel_chi[rows_b] = mfit["chisq"][better]

    # Assembly: identical layout to the host path's (pad width = max
    # SELECTED K, tau padding 1, zero C/mask padding).
    Kmax_out = max(specs[i][1] for i in set(sel_idx.tolist()))
    return CtModelSet(
        S2=jnp.asarray(selected["S2"]),
        C=jnp.asarray(selected["C"][:, :Kmax_out]),
        tau=jnp.asarray(selected["tau"][:, :Kmax_out]),
        mask=jnp.asarray(selected["mask"][:, :Kmax_out]),
        zeta=jnp.asarray(float(zeta)),
        s2fast=jnp.asarray(selected["s2fast"]),
        dS2=jnp.asarray(selected["dS2"]),
        dC=jnp.asarray(selected["dC"][:, :Kmax_out]),
        dtau=jnp.asarray(selected["dtau"][:, :Kmax_out]),
        chisq=jnp.asarray(selected["chisq"]),
        names=[str(x) for x in names],
    )
