"""End-to-end observable prediction: C(t) params + D tensor -> R1/R2/NOE/rho.

One batched, jittable forward model replaces the reference's per-residue
loops (``calculate-relaxations-from-Ct.py:125-191`` legacy path and the
``spinRelaxation*`` class evaluations, ``spectral_densities.py:607-907``).

Two averaging semantics exist in the reference and both are provided:

- legacy (:func:`predict_rates`): every observable, including NOE, is
  computed per vector-sample and then ensemble-averaged
  (get_relax_from_J_simd, spectral_densities.py:1710-1737).
- new API (:func:`predict_rates_newapi`): R1 is ensemble-averaged *first*
  and the averaged R1 enters the NOE formula
  (spinRelaxationNOE.eval, spectral_densities.py:877-907).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..constants import NucleusPair
from ..core.stats import _safe_sqrt, weighted_mean_std
from ..models.ctmodel import CtModelSet
from ..models.diffusion import Diffusion
from . import relaxation as rx


class RatesWithErrors(NamedTuple):
    R1: jnp.ndarray
    R2: jnp.ndarray
    NOE: jnp.ndarray
    rho: jnp.ndarray
    dR1: Optional[jnp.ndarray] = None
    dR2: Optional[jnp.ndarray] = None
    dNOE: Optional[jnp.ndarray] = None
    drho: Optional[jnp.ndarray] = None


def compute_j(pair: NucleusPair, diffusion: Diffusion, cts: CtModelSet, vecs=None):
    """J at the pair's five frequencies: (nRes, [nSamp,] 5)."""
    omega = jnp.asarray(pair.omega5())
    return diffusion.j_combined(
        omega, cts.S2, cts.C, cts.tau, mask=cts.mask, vecs=vecs, zeta=cts.zeta
    )


def _csa_broadcast(csa, ensemble: bool):
    """Shared rule for aligning a per-residue (nRes,) CSA array with an
    ensemble J of shape (nRes, nSamp, 5): add the sample axis.  Scalars
    and already-broadcastable arrays pass through."""
    if csa is None:
        return None
    csa = jnp.asarray(csa)
    return csa[:, None] if (csa.ndim == 1 and ensemble) else csa


def predict_rates(
    pair: NucleusPair,
    diffusion: Diffusion,
    cts: CtModelSet,
    vecs=None,
    weights=None,
    csa=None,
) -> RatesWithErrors:
    """Legacy-path prediction (per-sample NOE) with optional weighted
    ensemble averaging over the sample axis.

    vecs    : (nRes, nSamp, 3) or (nRes, 3) PAF vectors (anisotropic only).
    weights : (nRes, nSamp) ensemble weights or None.
    csa     : None, scalar, or (nRes,) residue-specific CSA.
    """
    J = compute_j(pair, diffusion, cts, vecs)
    ensemble = J.ndim == 3  # (nRes, nSamp, 5)
    rates = rx.relaxation_from_j(J, pair, csa=_csa_broadcast(csa, ensemble))
    if not ensemble:
        return RatesWithErrors(rates.R1, rates.R2, rates.NOE, rates.rho)
    R1, dR1 = weighted_mean_std(rates.R1, weights, axis=-1)
    R2, dR2 = weighted_mean_std(rates.R2, weights, axis=-1)
    NOE, dNOE = weighted_mean_std(rates.NOE, weights, axis=-1)
    rho, drho = weighted_mean_std(rates.rho, weights, axis=-1)
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, drho)


def predict_rates_newapi(
    pair: NucleusPair,
    diffusion: Diffusion,
    cts: CtModelSet,
    vecs=None,
    weights=None,
    csa=None,
) -> RatesWithErrors:
    """New-API prediction matching spinRelaxation{R1,R2,NOE}.eval():
    NOE uses the ensemble-averaged R1 (spectral_densities.py:894-907)."""
    J = compute_j(pair, diffusion, cts, vecs)
    return rates_from_j_newapi(pair, J, weights=weights, csa=csa)


def rates_from_j_newapi(pair: NucleusPair, J, weights=None, csa=None) -> RatesWithErrors:
    """New-API rates from a precomputed J(omega5) — lets callers share one
    batched J evaluation across experiments (the A/D geometry coefficients
    depend only on vectors + tensor shape, not on the field)."""
    ensemble = J.ndim == 3
    f_dd = pair.factor_dd()
    f_csa = pair.factor_csa(_csa_broadcast(csa, ensemble))
    tf = pair.time_fact

    r1_s = rx.r1_from_j(J, f_dd, f_csa, tf)
    r2_s = rx.r2_from_j(J, f_dd, f_csa, tf)
    rho_s = rx.rho_from_j(J)
    if not ensemble:
        noe = rx.noe_from_j(J, f_dd, tf, pair.gamma_b / pair.gamma_a, r1_s)
        return RatesWithErrors(r1_s, r2_s, noe, rho_s)

    R1, dR1 = weighted_mean_std(r1_s, weights, axis=-1)
    R2, dR2 = weighted_mean_std(r2_s, weights, axis=-1)
    rho, drho = weighted_mean_std(rho_s, weights, axis=-1)
    noe_s = rx.noe_from_j(J, f_dd, tf, pair.gamma_b / pair.gamma_a, R1[:, None])
    NOE, dNOE = weighted_mean_std(noe_s, weights, axis=-1)
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, drho)


def rates_from_a_moments_newapi(pair: NucleusPair, G, mu, cov, csa=None) -> RatesWithErrors:
    """New-API ensemble rates WITHOUT materialising the sample axis.

    R1/R2 (and the NOE cross-relaxation numerator) are linear in J, and
    the axisymmetric J is linear in the per-sample A-coefficients
    (reference spectral_densities.py:2057-2077; rate formulas :824-907),
    so the weighted ensemble mean and sd collapse onto the first/second
    central A-moments:

        mean(R)  = mu . r        with  r_j = R(G_j)
        sd(R)^2  = r^T cov r

    This is algebraically identical to :func:`rates_from_j_newapi` over
    the full (nRes, nSamp, 5) J — at O(nRes*3) instead of O(nRes*nSamp)
    per optimiser step (the multi-field fit's former hot loop).

    G   : (nRes, 3, 5) from ``ops.jomega.symmtop_g_factors`` at the
          pair's omega5 grid.
    mu  : (nRes, 3), cov : (nRes, 3, 3) from ``ops.jomega.a_moments_symmtop``
          (select the prolate/oblate branch before calling).
    csa : None, scalar, or (nRes,).

    ``rho`` = J(wX)/J(0) is NOT linear in A; the returned rho is the
    ratio of the ensemble-MEAN J (drho=None).  Optimisers only consume
    R1/R2/NOE; use :func:`predict_rates_newapi` for reported rho errors.
    """
    mu = jnp.asarray(mu)
    cov = jnp.asarray(cov)
    f_dd = pair.factor_dd()
    csa_v = None if csa is None else jnp.asarray(csa)
    if csa_v is not None and csa_v.ndim == 1:
        csa_v = csa_v[:, None]  # broadcast (nRes,) over the 3 decay modes
    f_csa = pair.factor_csa(csa_v)
    tf = pair.time_fact

    r1_j = rx.r1_from_j(G, f_dd, f_csa, tf)  # (nRes, 3)
    r2_j = rx.r2_from_j(G, f_dd, f_csa, tf)
    # The NOE's R1-independent numerator: shared with rx.noe_from_j so
    # the moment-collapse linearity identity (pinned by
    # test_moment_collapse) cannot drift from the per-sample formula.
    sig_j = rx.cross_rate_from_j(G, f_dd, tf, pair.gamma_b / pair.gamma_a)

    def _stats(r):
        mean = jnp.sum(mu * r, axis=-1)
        var = jnp.einsum(
            "rj,rjk,rk->r", r, cov, r,
            precision=jax.lax.Precision.HIGHEST,  # a reduced-precision
            # f32 default (TF32) loses ~1e-3 on f32 contractions
        )
        # _safe_sqrt: sqrt has a NaN *gradient* at 0 even though the
        # primal is fine — a zero-variance ensemble would NaN-poison the
        # optimiser jacobians (core/stats.py, the single home).
        return mean, _safe_sqrt(var)

    R1, dR1 = _stats(r1_j)
    R2, dR2 = _stats(r2_j)
    y, dy = _stats(sig_j)
    NOE = 1.0 + y / R1
    dNOE = dy / jnp.abs(R1)
    J_mean = jnp.einsum("rj,rjw->rw", mu, G,
                        precision=jax.lax.Precision.HIGHEST)
    rho = rx.rho_from_j(J_mean)
    return RatesWithErrors(R1, R2, NOE, rho, dR1, dR2, dNOE, None)


def predict_jomega(
    pair: NucleusPair,
    diffusion: Diffusion,
    cts: CtModelSet,
    vecs=None,
    weights=None,
):
    """J(omega) with ensemble averaging, mirroring _obtain_Jomega
    (calculate-relaxations-from-Ct.py:82-122).
    Returns (J_mean, J_std) with shape (nRes, 5); J_std is None without an
    ensemble axis."""
    J = compute_j(pair, diffusion, cts, vecs)
    if J.ndim == 2:
        return J, None
    mean, std = weighted_mean_std(
        jnp.moveaxis(J, -1, 0), weights, axis=-1
    )
    return jnp.moveaxis(mean, 0, -1), jnp.moveaxis(std, 0, -1)
