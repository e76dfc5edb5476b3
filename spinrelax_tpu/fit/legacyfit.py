"""Legacy single-field fitting modes of calculate-relaxations-from-Ct.py.

Modes (reference :865-1000):
- 'Diso'      : global tumbling rate only.
- 'DisoS2'    : Diso + a global S2 scaling factor (applied to S2 and all
                transient amplitudes, :267-268 / :297-298).
- 'DisoCSA'   : Diso + a global mean CSA.
- 'DisoS2CSA' : all three, with the correlated Powell direction matrix
                (:930-934).
- 'new'       : alternating global-Diso Powell + per-residue CSA fits
                (:865-905); the per-residue stage here is a batched
                golden-section (all residues at once).

The chi-square follows optfunc_R1R2NOE_inner (:193-207): mean over
(R1,R2,NOE) x residues of (v-t)^2 / (sigma_sim^2 + sigma_exp^2).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import NucleusPair
from ..models.ctmodel import CtModelSet
from ..models.diffusion import Diffusion
from ..ops import observables as obs
from .scalar import golden_vec


class LegacyFitResult(NamedTuple):
    diso: float
    s2_scale: float
    csa: np.ndarray  # (nRes,)
    chisq: float
    mode: str


def _make_chisq(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet,
                vecs, weights, exp, exp_err):
    """Build jitted total and per-residue chi-square closures.

    exp     : (nRes, 3) target R1/R2/NOE.
    exp_err : (nRes, 3) uncertainties or None.
    """
    vecs_j = None if vecs is None else jnp.asarray(vecs)
    weights_j = None if weights is None else jnp.asarray(weights)
    exp_j = jnp.asarray(exp)
    err_j = None if exp_err is None else jnp.asarray(exp_err)
    base_zeta = cts.zeta
    has_ensemble = vecs_j is not None and vecs_j.ndim == 3

    def _predict(diso, s2s, csa):
        d = diffusion.with_diso(diso)
        c = dataclasses.replace(cts, zeta=base_zeta * s2s)
        rates = obs.predict_rates(pair, d, c, vecs=vecs_j, weights=weights_j, csa=csa)
        v = jnp.stack([rates.R1, rates.R2, rates.NOE], axis=-1)  # (nRes, 3)
        if rates.dR1 is not None:
            dv = jnp.stack([rates.dR1, rates.dR2, rates.dNOE], axis=-1)
        else:
            dv = None
        return v, dv

    def _inner(v, dv):
        sq = (v - exp_j) ** 2
        if dv is not None and err_j is not None:
            w = dv**2 + err_j**2
        elif dv is not None:
            w = dv**2
        elif err_j is not None:
            w = err_j**2
        else:
            return sq  # unweighted (reference :207)
        return sq / w

    @jax.jit
    def chisq_total(diso, s2s, csa):
        v, dv = _predict(diso, s2s, csa)
        return jnp.mean(_inner(v, dv))

    @jax.jit
    def chisq_res(diso, s2s, csa):
        v, dv = _predict(diso, s2s, csa)
        return jnp.mean(_inner(v, dv), axis=-1)  # (nRes,)

    return chisq_total, chisq_res


def fit_legacy(
    mode: str,
    pair: NucleusPair,
    diffusion: Diffusion,
    cts: CtModelSet,
    exp: np.ndarray,
    exp_err: Optional[np.ndarray],
    vecs=None,
    weights=None,
    csa0: Optional[np.ndarray] = None,
    max_cycles: int = 100,
    tol: float = 1e-6,
    method: str = "powell",
    verbose: bool = False,
) -> LegacyFitResult:
    """``method``: 'powell' reproduces the reference's optimiser (direction
    matrices included); 'gradient' minimises the same chi-square with
    L-BFGS-B driven by exact JAX gradients (the forward model is fully
    differentiable); 'device' (mode='new' only) runs the ENTIRE
    alternating Diso/per-residue-CSA fit as one jitted while_loop — a
    single dispatch and one packed fetch, no host round-trip per cycle."""
    from scipy.optimize import fmin_powell

    n_res = cts.n_models
    if csa0 is None:
        csa0 = np.full(n_res, pair.csa_value)
    csa = np.asarray(csa0, dtype=float).copy()
    diso0 = float(np.asarray(diffusion.diso))
    csa_mean0 = float(np.mean(csa))

    chisq_total, chisq_res = _make_chisq(
        pair, diffusion, cts, vecs, weights, exp, exp_err
    )

    if method == "gradient" and mode in ("Diso", "DisoS2", "DisoCSA", "DisoS2CSA"):
        return _fit_legacy_gradient(
            mode, chisq_total, diso0, csa, csa_mean0, n_res, verbose
        )

    if method == "device":
        if mode != "new":
            raise ValueError(
                "method='device' is implemented for mode='new' only "
                "(the alternating fit; use 'powell' or 'gradient' for "
                f"mode={mode!r})"
            )
        return _fit_legacy_new_device(
            chisq_total, chisq_res, diso0, csa, max_cycles, tol
        )

    if mode == "Diso":
        f = lambda x: float(chisq_total(x[0], 1.0, jnp.asarray(csa)))
        out = fmin_powell(f, x0=[diso0], direc=[[0.1 * diso0]], full_output=True, disp=verbose)
        return LegacyFitResult(float(np.ravel(out[0])[0]), 1.0, csa, float(out[1]), mode)

    if mode == "DisoS2":
        f = lambda x: float(chisq_total(x[0], x[1], jnp.asarray(csa)))
        d_init = np.array([[0.1 * diso0, 0.1], [0.1 * diso0, -0.1]])
        out = fmin_powell(f, x0=[diso0, 1.0], direc=d_init, full_output=True, disp=verbose)
        return LegacyFitResult(float(out[0][0]), float(out[0][1]), csa, float(out[1]), mode)

    if mode == "DisoCSA":
        f = lambda x: float(chisq_total(x[0], 1.0, jnp.full(n_res, x[1])))
        d_init = np.array(
            [[0.1 * diso0, 0.1 * csa_mean0], [0.1 * diso0, -0.1 * csa_mean0]]
        )
        out = fmin_powell(f, x0=[diso0, csa_mean0], direc=d_init, full_output=True, disp=verbose)
        return LegacyFitResult(
            float(out[0][0]), 1.0, np.full(n_res, float(out[0][1])), float(out[1]), mode
        )

    if mode == "DisoS2CSA":
        # Correlated Powell directions (reference :930-934): CSA and S2
        # both compensate for Diso.
        p_init = np.array([diso0, 1.0, csa_mean0])
        dmat = np.array(
            [
                [np.sqrt(1 / 3), np.sqrt(1 / 3), np.sqrt(1 / 3)],
                [-np.sqrt(2 / 3), np.sqrt(1 / 6), np.sqrt(1 / 6)],
                [0.0, np.sqrt(1 / 2), -np.sqrt(1 / 2)],
            ]
        )
        d_init = 0.1 * dmat * p_init
        f = lambda x: float(chisq_total(x[0], x[1], jnp.full(n_res, x[2])))
        out = fmin_powell(f, x0=p_init, direc=d_init, full_output=True, disp=verbose)
        return LegacyFitResult(
            float(out[0][0]), float(out[0][1]),
            np.full(n_res, float(out[0][2])), float(out[1]), mode,
        )

    if mode == "new":
        diso = diso0
        diso_prev = None
        first = True
        for r in range(max_cycles):
            f = lambda x: float(chisq_total(np.atleast_1d(x)[0], 1.0, jnp.asarray(csa)))
            out = fmin_powell(f, x0=diso, direc=[[0.1 * diso]], full_output=True, disp=False)
            diso, chi = float(np.ravel(out[0])[0]), float(out[1])
            if not first and np.allclose(diso, diso_prev, rtol=tol):
                break
            diso_prev = diso

            fres = lambda c: chisq_res(diso, 1.0, c)
            csa_new = np.asarray(
                golden_vec(fres, jnp.asarray(csa - 150e-6), jnp.asarray(csa + 150e-6))
            )
            # Compare CONSECUTIVE rounds (new vs the value entering this
            # round) — comparing against a stale csa_prev from two
            # rounds ago both delays detection and falsely converges on
            # period-2 oscillations.
            converged = not first and np.allclose(csa_new, csa, rtol=tol)
            csa = csa_new
            if converged:
                break
            first = False
            if verbose:
                print(f"    ...round {r} complete. Diso={diso:g}")
        chi = float(chisq_total(diso, 1.0, jnp.asarray(csa)))
        return LegacyFitResult(diso, 1.0, csa, chi, mode)

    raise ValueError(f"invalid optimisation mode {mode!r}")


def _fit_legacy_new_device(
    chisq_total, chisq_res, diso0, csa0, max_cycles, tol
) -> LegacyFitResult:
    """mode='new' as ONE device dispatch: a jitted while_loop alternating
    a bracket-expanding golden-section on log(Diso) (derivative-free like
    the reference's Powell, positivity structural) with the batched
    per-residue CSA golden-section, replicating the host loop's
    convergence flags (np.allclose semantics incl. its default atol) and
    its break-before-local ordering."""
    n_cyc = int(max_cycles)

    def _close(a, b):
        # np.allclose(a, b, rtol=tol): |a-b| <= atol + rtol*|b| with the
        # default atol=1e-8 — the host path uses exactly this, so the
        # fused path must too or it would iterate past the host's stop.
        return jnp.abs(a - b) <= 1e-8 + tol * jnp.abs(b)

    def _golden_diso(diso_c, csa):
        # 1-D minimisation over z with diso = diso_c * e^z: z0 = 0 is the
        # current value; bracket edges re-centre and double (the
        # reference's Powell is unbounded, so clamping would be wrong).
        def f(zv):
            return chisq_total(diso_c * jnp.exp(zv[0]), 1.0, csa)[None]

        def body(st):
            best, hw, it, _ = st
            lo = best - hw
            hi = best + hw
            nb = golden_vec(f, lo, hi)
            at_edge = jnp.minimum(nb - lo, hi - nb) < 0.01 * hw
            hw = jnp.where(at_edge, 2.0 * hw, hw)
            return nb, hw, it + 1, jnp.any(at_edge)

        def cond(st):
            return st[3] & (st[2] < 8)

        z0 = jnp.zeros(1)
        best, _hw, _it, _c = jax.lax.while_loop(
            cond, body, (z0, jnp.full(1, 0.2), jnp.asarray(0), jnp.asarray(True))
        )
        return diso_c * jnp.exp(best[0])

    def _body(st):
        diso, csa, diso_prev, first, _done, it = st
        diso_new = _golden_diso(diso, csa)
        g_conv = (~first) & _close(diso_new, diso_prev)
        csa_new = golden_vec(
            lambda c: chisq_res(diso_new, 1.0, c), csa - 150e-6, csa + 150e-6
        )
        c_conv = (~first) & jnp.all(_close(csa_new, csa))
        # Host ordering: the global-convergence break happens BEFORE the
        # local stage, so its csa update must be discarded on g_conv.
        csa_out = jnp.where(g_conv, csa, csa_new)
        done = g_conv | c_conv
        return diso_new, csa_out, diso_new, jnp.asarray(False), done, it + 1

    def _cond(st):
        return (~st[4]) & (st[5] < n_cyc)

    @jax.jit
    def _solve(diso_j, csa_j):
        st = (
            diso_j, csa_j, diso_j, jnp.asarray(True), jnp.asarray(False),
            jnp.asarray(0),
        )
        diso, csa, _p, _f, _d, _it = jax.lax.while_loop(_cond, _body, st)
        return diso, csa, chisq_total(diso, 1.0, csa)

    diso, csa, chi = jax.device_get(
        _solve(jnp.asarray(float(diso0)), jnp.asarray(csa0))
    )
    return LegacyFitResult(
        float(diso), 1.0, np.asarray(csa, dtype=float), float(chi), "new"
    )


def _fit_legacy_gradient(mode, chisq_total, diso0, csa, csa_mean0, n_res, verbose):
    """L-BFGS-B with exact gradients over the active parameter subset.
    Parameters are scaled to O(1) so the optimiser sees a well-conditioned
    problem (Diso ~ 1e-5, CSA ~ -1.7e-4)."""
    from scipy.optimize import minimize

    active = {
        "Diso": ("diso",),
        "DisoS2": ("diso", "s2s"),
        "DisoCSA": ("diso", "csa"),
        "DisoS2CSA": ("diso", "s2s", "csa"),
    }[mode]
    x0 = {"diso": diso0, "s2s": 1.0, "csa": csa_mean0}
    scales = {"diso": abs(diso0), "s2s": 1.0, "csa": max(abs(csa_mean0), 1e-6)}

    csa_j = jnp.asarray(csa)

    def unpack(z):
        vals = dict(x0)
        for name, zi in zip(active, z):
            vals[name] = zi * scales[name]
        return vals

    grad_fn = jax.jit(
        jax.value_and_grad(
            lambda d, s2s, c: chisq_total(d, s2s, jnp.full(n_res, c))
            if "csa" in active
            else chisq_total(d, s2s, csa_j),
            argnums=(0, 1, 2),
        )
    )

    def f_and_g(z):
        vals = unpack(z)
        f, g = grad_fn(vals["diso"], vals["s2s"], vals["csa"])
        gs = {"diso": float(g[0]), "s2s": float(g[1]), "csa": float(g[2])}
        return float(f), np.array([gs[n] * scales[n] for n in active])

    z0 = np.array([x0[n] / scales[n] for n in active])
    # jac=True hands scipy the (f, g) pair from ONE jitted forward+grad
    # dispatch per iterate (separate fun/jac lambdas would dispatch the
    # identical computation twice).
    res = minimize(f_and_g, z0, jac=True, method="L-BFGS-B")
    vals = unpack(res.x)
    out_csa = np.full(n_res, vals["csa"]) if "csa" in active else csa
    if verbose:
        print(f"    ...gradient fit converged: {res.message}")
    return LegacyFitResult(
        float(vals["diso"]), float(vals["s2s"]), out_csa, float(res.fun), mode
    )
