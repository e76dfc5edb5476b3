"""In-graph DoF-ladder walk: all rungs + the reference's sequential
model selection in ONE device dispatch / ONE packed fetch.

The host walk (fit.expfit.fit_ct_ladder's per-rung path) pays, per rung,
a dispatch + a blocking packed fetch plus the host-side selection pass —
five sequential device round trips.  Here
the whole walk — every rung's cold batched LM and the per-residue
selection rules of fitting_Ct_functions.py:278-304 — runs inside one
jitted program: per-lane masks carry the selection state (sel_idx,
sel_chi, active) between the unrolled rung fits, lanes whose walk has
ended enter later rungs frozen (lm_solve ``skip``: their while_loop
bodies are select-masked from iteration 0, so a dead rung costs no
iterations), and ONE packed (B, cols) array returns the selected model
plus the escalation/verbose metadata the host needs.

Per-rung math is _fit_one_dense — the SAME lane function fit_multiexp
vmaps — so the two walks perform identical per-lane computations;
selection parity is pinned by tests/test_walk.py A/B.

The warm-retry / multi-start escalation arms (rare, data-dependent)
stay host-side: fit_ct_ladder re-runs the host walk on just the
quality-failure rows this walk flags (qfail column), which reproduces
the host path's retry semantics exactly on exactly the rows where the
two paths could differ (lanes are independent; a lane without a quality
failure walks identically in both).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .lm import _fit_one_dense

__all__ = ["fit_ct_walk", "unpack_walk"]


@partial(jax.jit, static_argnames=("specs", "Kmax", "n_starts"))
def fit_ct_walk(dt, decays, sigma, chisq_threshold, specs, Kmax: int,
                n_starts: int = 1):
    """Run the full ladder walk in-graph.

    dt      : (T,) lag times.
    decays  : (B, T); sigma : (B, T).
    chisq_threshold : traced scalar (the reference's 0.5 chi-halving).
    specs   : static tuple of (K, s2_free) per rung, walk order.
    Kmax    : static max K over specs (selected-model padding width).
    n_starts: batched multi-start per rung (see fit_multiexp).

    Returns ONE (B, 5*Kmax + 8 + 2*R) array; decode with
    :func:`unpack_walk`.  Column groups:
      C, tau, dC, dtau, mask        selected model (Kmax each; tau pads
                                    1, others 0 — CtModelSet layout)
      S2, dS2, chisq                of the selected rung (chisq is the
                                    ASSEMBLY value: the fallback rung's
                                    raw chisq for never-took rows)
      sel_idx                       selected rung (float; walk result —
                                    never -1: fallback rows carry their
                                    nanargmin rung)
      sel_chi                       the walk's running chi (inf for
                                    fallback rows, exactly like the
                                    host walk's sel_chi array)
      s2fast                        s2_free flag of the selected rung
      qfail                         FIRST rung where this lane broke
                                    with failed quality gates (-1 none):
                                    the host escalation trigger
      chi_rungs (R)                 per-rung chisq, NaN where the lane
                                    was not fitted (host-walk scatter
                                    semantics; drives verbose)
      act_rungs (R)                 1.0 where the lane was still active
                                    entering each rung
      beg_mean                      mean of the first min(10, T) decay
                                    points (the warm-retry seed input —
                                    packing it here saves the host
                                    escalation a separate device fetch)
    """
    dt = jnp.asarray(dt)
    decays = jnp.asarray(decays)
    sigma = jnp.asarray(sigma)
    R = len(specs)
    B = decays.shape[0]
    dtype = decays.dtype

    def rung_fit(K, s2f, act):
        """One rung's batched fit with broken lanes frozen — the vmapped
        lane function of the HOST walk (byte-parity pinned)."""
        return jax.vmap(
            lambda y, sg, sk: _fit_one_dense(dt, y, sg, K, s2f,
                                             n_starts=n_starts, skip=sk)
        )(decays, sigma, ~act)

    def padB(x, fill):  # (B, K) -> (B, Kmax)
        k = x.shape[1]
        if k == Kmax:
            return x
        return jnp.concatenate(
            [x, jnp.full((B, Kmax - k), fill, x.dtype)], axis=1
        )

    zB = jnp.zeros((B,), dtype)
    zBK = jnp.zeros((B, Kmax), dtype)
    sel = dict(
        C=zBK, tau=jnp.ones((B, Kmax), dtype), dC=zBK, dtau=zBK, mask=zBK,
        S2=zB, dS2=zB, chisq=zB, s2fast=zB,
    )
    # Fallback track: the host walk's np.nanargmin over all rungs' chisq
    # for rows that never pass a rung's checks (they never break, so
    # every rung is fitted for them).  fb_cmp is +inf until a FINITE
    # chisq arrives (strict < keeps the first minimum, NaN never wins —
    # exactly nanargmin); fb_* hold rung 0 unconditionally so the
    # all-NaN case degrades to rung 0.
    fb = dict(sel)
    fb_cmp = jnp.full((B,), jnp.inf, dtype)
    fb_idx = zB
    sel_idx = jnp.full((B,), -1.0, dtype)
    sel_chi = jnp.full((B,), jnp.inf, dtype)
    act = jnp.ones((B,), bool)
    qfail = jnp.full((B,), -1.0, dtype)
    chi_rungs = []
    act_rungs = []

    for i, (K, s2f) in enumerate(specs):
        act_rungs.append(act.astype(dtype))
        (C, tau, S2, dC, dtau, dS2, chi,
         ok_fit, ok_err, ok_sum) = rung_fit(K, s2f, act)
        chi_rungs.append(jnp.where(act, chi, jnp.nan))
        rung = dict(
            C=padB(C, 0.0), tau=padB(tau, 1.0),
            dC=padB(dC, 0.0), dtau=padB(dtau, 0.0),
            mask=padB(jnp.ones((B, K), dtype), 0.0),
            S2=S2, dS2=dS2, chisq=chi,
            s2fast=jnp.full((B,), float(s2f), dtype),
        )
        # fitting_Ct_functions.py:283-304 selection rules (identical to
        # the host walk's vectorisation incl. NaN comparison semantics:
        # NaN >= x is False, so a finite-params/NaN-chisq rung is
        # adopted).
        ok = ok_fit & ok_err & ok_sum
        unset = sel_idx < 0
        brk = act & ~unset & (~ok | (chi >= sel_chi * chisq_threshold))
        take = act & ok & ~brk
        for k in sel:
            w = take[:, None] if sel[k].ndim == 2 else take
            sel[k] = jnp.where(w, rung[k], sel[k])
        sel_idx = jnp.where(take, float(i), sel_idx)
        sel_chi = jnp.where(take, chi, sel_chi)
        qfail = jnp.where((qfail < 0) & brk & ~ok, float(i), qfail)
        act = act & ~brk
        # Fallback: strict improvement over the best finite chisq so far
        # (rung 0 seeds the params unconditionally).
        better = chi < fb_cmp
        upd = better if i else jnp.ones_like(better)
        for k in fb:
            w = upd[:, None] if fb[k].ndim == 2 else upd
            fb[k] = jnp.where(w, rung[k], fb[k])
        fb_idx = jnp.where(better, float(i), fb_idx)
        fb_cmp = jnp.where(better, chi, fb_cmp)

    use_fb = sel_idx < 0
    ufb2 = use_fb[:, None]
    cols = [
        jnp.where(ufb2, fb["C"], sel["C"]),
        jnp.where(ufb2, fb["tau"], sel["tau"]),
        jnp.where(ufb2, fb["dC"], sel["dC"]),
        jnp.where(ufb2, fb["dtau"], sel["dtau"]),
        jnp.where(ufb2, fb["mask"], sel["mask"]),
        jnp.where(use_fb, fb["S2"], sel["S2"])[:, None],
        jnp.where(use_fb, fb["dS2"], sel["dS2"])[:, None],
        jnp.where(use_fb, fb["chisq"], sel["chisq"])[:, None],
        jnp.where(use_fb, fb_idx, sel_idx)[:, None],
        sel_chi[:, None],
        jnp.where(use_fb, fb["s2fast"], sel["s2fast"])[:, None],
        qfail[:, None],
        jnp.stack(chi_rungs, axis=1),
        jnp.stack(act_rungs, axis=1),
        jnp.mean(decays[:, : min(10, decays.shape[1])], axis=1)[:, None],
    ]
    return jnp.concatenate(cols, axis=1)


def unpack_walk(packed, Kmax: int, R: int) -> dict:
    """Host-side decode of :func:`fit_ct_walk`'s packed array (numpy in,
    after the caller's single fetch)."""
    o = 0
    out = {}
    for name in ("C", "tau", "dC", "dtau", "mask"):
        out[name] = packed[:, o: o + Kmax]
        o += Kmax
    for name in ("S2", "dS2", "chisq", "sel_idx", "sel_chi", "s2fast",
                 "qfail"):
        out[name] = packed[:, o]
        o += 1
    out["chi_rungs"] = packed[:, o: o + R]
    o += R
    out["act_rungs"] = packed[:, o: o + R]
    o += R
    out["beg_mean"] = packed[:, o]
    return out
