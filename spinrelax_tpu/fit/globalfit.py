"""Global parameter optimisation against multi-field experiments.

Replaces the reference's optimisation machinery in
``spinRelaxationExperiments`` (spectral_densities.py:1217-1447): a
registry of optimisable globals {Diso, Daniso, zeta, CSA} plus the
residue-specific CSA (rsCSA) local stage, alternated until convergence.

Accelerator-first design: the full multi-experiment chi-square is ONE jitted,
differentiable function of the parameter vector — every experiment, every
residue, every vector sample evaluated in a single fused graph.  Two
optimisers drive it:

- 'powell'  : scipy fmin_powell on the jitted objective with the
  reference's diagonal step-size direction matrix (parity mode,
  spectral_densities.py:1387-1397).
- 'gradient': L-BFGS-B with exact JAX gradients (the forward model is
  fully differentiable — the reference could never do this).
- 'device'  : the whole optimisation in ONE device dispatch — a jitted
  Levenberg-Marquardt while_loop on the residual vector (chisq is a sum
  of squares), forward-mode jacobians over the log-space positive
  parameters.  No host<->device round-trip per iterate.  With rsCSA requested the
  alternating loop fuses each global+local cycle (LM on the globals +
  bracket-expanding golden-section over all residues' CSA) into ONE
  dispatch and one packed fetch per cycle (_cycle_device).

The rsCSA local stage is a *batched* golden-section over all residues at
once (the chi-square separates per residue), replacing nResidues
sequential scalar Powell runs (spectral_densities.py:1371-1382).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.diffusion import Diffusion
from ..models.experiments import ExperimentSet
from ..ops import observables as obs
from .scalar import golden_vec

# (half_width [ppm-scale CSA units], n_iter, max_expand) shared by
# GlobalFitter.local_step's signature and the fused _cycle_device program
# — one home so the two rsCSA walks cannot drift apart.
_LOCAL_STEP_DEFAULTS = (150e-6, 60, 8)

ALLOWED_VARIABLES = ("Diso", "Daniso", "CSA", "zeta", "rsCSA")
# Moment-collapsed ensemble statistics for the axisymmetric fit (exact;
# see _eval_all).  Module-level so benchmarks can A/B the paths.
USE_MOMENT_COLLAPSE = True
# Powell step sizes (spectral_densities.py:1219)
STEP_SIZES = {"Diso": 1e-5, "Daniso": 0.1, "zeta": 0.1, "CSA": 1e-5, "rsCSA": 1e-5}
EXPORT_SCALING = {"Diso": 1.0, "Daniso": 1.0, "zeta": 1.0, "CSA": 1e6, "rsCSA": 1e6}
EXPORT_UNITS = {"Diso": "ps^-1", "Daniso": "a.u.", "zeta": "a.u.", "CSA": "ppm", "rsCSA": "ppm"}


@dataclasses.dataclass
class FitState:
    diso: float
    aniso: float
    zeta: float
    csa: np.ndarray  # (nRes,) residue-specific (may be uniform)
    chisq: float = np.nan


def _eval_all(es: ExperimentSet, diso, aniso, zeta, csa):
    """Predicted (value, error) for every experiment, batched.

    Returns list of (v (nRes,), e (nRes,) or None)."""
    if es.diffusion.kind == "isotropic":
        diffusion = Diffusion.isotropic(diso=diso)
    elif es.diffusion.kind == "axisymmetric":
        diffusion = Diffusion.axisymmetric(diso=diso, aniso=aniso)
    else:
        raise ValueError(f"optimisation unsupported for kind {es.diffusion.kind}")
    cts = dataclasses.replace(es.cts, zeta=zeta)
    out = []
    vecs = None if es.vecs is None else jnp.asarray(es.vecs)
    weights = None if es.weights is None else jnp.asarray(es.weights)
    # One batched J evaluation over the stacked omega5 grids of all UNIQUE
    # pairs: the geometry (A) and decay (D) coefficients are field-
    # independent, so this removes the per-experiment recomputation the
    # reference performs (spectral_densities.py:803-818 evaluates each
    # experiment object separately).
    pairs = []
    for e in es.experiments:
        if e.pair not in pairs:
            pairs.append(e.pair)
    omega_all = jnp.concatenate([jnp.asarray(p.omega5()) for p in pairs])
    rates_by_pair = {}
    if (USE_MOMENT_COLLAPSE and es.diffusion.kind == "axisymmetric"
            and vecs is not None and vecs.ndim == 3):
        # Moment-collapsed fast path: rates are linear in the per-sample
        # A-coefficients, so the ensemble statistics follow from the
        # precomputed (mu, cov) A-moments — O(nRes*3) per step instead of
        # O(nRes*nSamp) (reference evaluates J over every sample every
        # step, spectral_densities.py:751-763,1710-1737).  Both
        # prolate/oblate moment sets are jit constants; the branch is
        # selected in-graph because Daniso is traced.
        from ..ops import jomega as jw

        mu_p, cov_p, mu_o, cov_o = es.symmtop_a_moments()
        dpar, dperp = diffusion.dpar_dperp()
        prolate = dpar > dperp
        mu = jnp.where(prolate, jnp.asarray(mu_p), jnp.asarray(mu_o))
        cov = jnp.where(prolate, jnp.asarray(cov_p), jnp.asarray(cov_o))
        G_all = jw.symmtop_g_factors(
            omega_all, dpar, dperp, cts.S2, cts.C, cts.tau,
            comp_mask=cts.mask, zeta=cts.zeta,
        )
        for i, p in enumerate(pairs):
            rates_by_pair[p] = obs.rates_from_a_moments_newapi(
                p, G_all[..., 5 * i : 5 * (i + 1)], mu, cov, csa=csa
            )
    else:
        J_all = diffusion.j_combined(
            omega_all, cts.S2, cts.C, cts.tau, mask=cts.mask, vecs=vecs, zeta=cts.zeta
        )
        for i, p in enumerate(pairs):
            J = J_all[..., 5 * i : 5 * (i + 1)]
            rates_by_pair[p] = obs.rates_from_j_newapi(p, J, weights=weights, csa=csa)
    for e in es.experiments:
        rates = rates_by_pair[e.pair]
        if e.expt_type == "R1":
            v, dv = rates.R1, rates.dR1
        elif e.expt_type == "R2":
            v, dv = rates.R2, rates.dR2
        elif e.expt_type == "NOE":
            v, dv = rates.NOE, rates.dNOE
        else:
            raise ValueError(f"unknown experiment type {e.expt_type!r}")
        out.append((v, dv))
    return out


def _combined_weight(e, dv, like):
    """The reference's composite error weight dTarget^2 + dSim^2 with
    the both-absent -> 1.0 fallback (calc_chisq,
    spectral_densities.py:803-818) plus the nonpositive -> 1.0 clamp
    that the reference applies only in its rsCSA inner objective
    (:1430-1447).  Extending the clamp to the GLOBAL chi-square is a
    deliberate deviation: a zero error bar in an experiment file makes
    the reference's global objective inf (division by zero), which its
    Powell loop cannot recover from — those points weight at 1.0 here
    instead.  THE single home of this 4-branch rule: chisq_total,
    residuals_total and chisq_per_residue must stay mutually consistent
    (chisq_total == sum(residuals^2) is the invariant the on-device LM
    relies on; the rsCSA local stage must weight like the global stage
    or the alternation fights itself), so all three call here."""
    if e.error is not None and dv is not None:
        w = jnp.asarray(e.error) ** 2 + dv**2
    elif dv is None and e.error is not None:
        w = jnp.asarray(e.error) ** 2
    elif e.error is None and dv is not None:
        w = dv**2
    else:
        w = jnp.ones_like(like)
    return jnp.where(w > 0, w, 1.0)


def chisq_total(es: ExperimentSet, diso, aniso, zeta, csa):
    """Reference chi-square: per-experiment masked mean of
    (v-t)^2 / (dTarget^2 + dSim^2), summed over experiments / nExpt
    (spectral_densities.py:803-818, 1409-1413)."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    total = 0.0
    for e, (v, dv) in zip(es.experiments, preds):
        m = jnp.asarray(e.mask)
        t = jnp.asarray(e.target)
        sq = (v - t) ** 2
        w = _combined_weight(e, dv, sq)
        total = total + jnp.sum(m * sq / w) / jnp.maximum(jnp.sum(m), 1.0)
    return total / len(es.experiments)


def residuals_total(es: ExperimentSet, diso, aniso, zeta, csa):
    """Flat residual vector r with chisq_total == sum(r^2) exactly
    (per-experiment masked normalisation folded into each element) —
    the least-squares form the on-device Levenberg-Marquardt consumes."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    n_e = len(es.experiments)
    rs = []
    for e, (v, dv) in zip(es.experiments, preds):
        m = jnp.asarray(e.mask)
        t = jnp.asarray(e.target)
        w = _combined_weight(e, dv, v)
        norm = jnp.maximum(jnp.sum(m), 1.0) * n_e
        # sqrt(m/norm) is parameter-independent (w is not): keeping the
        # mask OUTSIDE the w-bearing factor keeps the jacobian of masked
        # entries exactly 0 instead of NaN.
        rs.append(jnp.sqrt(m / norm) * ((v - t) / jnp.sqrt(w)))
    return jnp.concatenate(rs)


def chisq_per_residue(es: ExperimentSet, diso, aniso, zeta, csa):
    """Per-residue chi-square for the rsCSA local stage
    (optimisation_loop_rsCSA_inner_function,
    spectral_densities.py:1430-1447): mean over covering experiments of
    (v-t)^2 / (dv^2 + dt^2), with weight 1 when both vanish."""
    preds = _eval_all(es, diso, aniso, zeta, csa)
    num = 0.0
    cnt = 0.0
    for e, (v, dv) in zip(es.experiments, preds):
        m = jnp.asarray(e.mask)
        t = jnp.asarray(e.target)
        w = _combined_weight(e, dv, v)
        num = num + m * (v - t) ** 2 / w
        cnt = cnt + m
    return num / jnp.maximum(cnt, 1.0)


class GlobalFitter:
    """Drives the global/local optimisation loops
    (perform_optimisation, spectral_densities.py:1302-1382)."""

    def __init__(self, es: ExperimentSet, opt_vars: Sequence[str]):
        for v in opt_vars:
            if v not in ALLOWED_VARIABLES:
                raise ValueError(
                    f"unknown optimisation variable {v!r}; allowed: {ALLOWED_VARIABLES}"
                )
        if "CSA" in opt_vars and "rsCSA" in opt_vars:
            raise ValueError("cannot optimise both global CSA and rsCSA")
        self.es = es
        self.global_vars = [v for v in opt_vars if v != "rsCSA"]
        self.do_local = "rsCSA" in opt_vars
        n_res = es.n_residues
        csa0 = es.csa
        if csa0 is None:
            csa0 = np.full(n_res, es.experiments[0].pair.csa_value)
        self.state = FitState(
            diso=float(np.asarray(es.diffusion.diso)),
            aniso=float(np.asarray(es.diffusion.aniso)),
            zeta=float(np.asarray(es.cts.zeta)),
            csa=np.asarray(csa0, dtype=float).copy(),
        )

        # One jitted chi-square over the full packed parameter vector.
        es_ref = self.es

        @jax.jit
        def _chisq_packed(diso, aniso, zeta, csa):
            return chisq_total(es_ref, diso, aniso, zeta, csa)

        @jax.jit
        def _chisq_res(diso, aniso, zeta, csa):
            return chisq_per_residue(es_ref, diso, aniso, zeta, csa)

        self._chisq = _chisq_packed
        self._chisq_res = _chisq_res
        # csa included (argnums 3): the scalar-CSA direction is the SUM
        # of the per-residue csa gradient, so the gradient path needs no
        # second un-jitted re-trace of the chi-square graph per iterate.
        self._grad = jax.jit(jax.grad(_chisq_packed, argnums=(0, 1, 2, 3)))

        # One-dispatch device optimiser (method="device"): pure-JAX BFGS
        # over the scaled packed globals; current state values ride in as
        # arguments so cycles re-use ONE compiled program.
        if self.global_vars:
            idx = {v: i for i, v in enumerate(self.global_vars)}

            def _unpack(z, d0, a0, zeta0, csa0):
                # Positive params in log-space (x = x0 * e^z): z0 = 0 is
                # naturally scaled AND positivity is structural, so the
                # unit-Hessian first BFGS step cannot drive Diso negative
                # and NaN-poison the line search.  CSA (sign-free) moves
                # linearly in units of its magnitude.
                d = d0 * jnp.exp(z[idx["Diso"]]) if "Diso" in idx else d0
                a = a0 * jnp.exp(z[idx["Daniso"]]) if "Daniso" in idx else a0
                zz = (
                    zeta0 * jnp.exp(z[idx["zeta"]]) if "zeta" in idx
                    else zeta0
                )
                if "CSA" in idx:
                    ref = jnp.mean(csa0)
                    val = ref + z[idx["CSA"]] * jnp.maximum(
                        jnp.abs(ref), 1e-6
                    )
                    c = jnp.full_like(csa0, val)
                else:
                    c = csa0
                return d, a, zz, c

            n_p = len(idx)

            def _lm_core(d0, a0, zeta0, csa0):
                # Levenberg-Marquardt on the residual vector, entirely
                # inside one jitted while_loop: the chi-square is a sum
                # of squares, so LM's J^T J curvature converges in ~10
                # steps where f32 BFGS line searches stall — and each
                # iterate costs n_p forward-mode passes, no host trips.
                def resid(z):
                    return residuals_total(
                        es_ref, *_unpack(z, d0, a0, zeta0, csa0)
                    )

                def fval(z):
                    r = resid(z)
                    return jnp.sum(r * r)

                eye = jnp.eye(n_p)

                _hi = jax.lax.Precision.HIGHEST  # f32 matmuls may default
                # to reduced precision (TF32); the LM curvature must not

                def body(state):
                    z, lam, f, it, _moved = state
                    # linearize shares ONE primal evaluation between the
                    # residual and its n_p basis-vector JVPs (jacfwd IS
                    # vmap-of-jvp over eye, but with its own primal; the
                    # separate resid(z) re-ran the full multi-experiment
                    # forward model a third time each iteration).
                    r, jvp = jax.linearize(resid, z)
                    J = jnp.transpose(jax.vmap(jvp)(eye))  # (nR, n_p)
                    g = jnp.matmul(J.T, r, precision=_hi)
                    H = jnp.matmul(J.T, J, precision=_hi)
                    dz = jnp.linalg.solve(H + lam * eye, -g)
                    z_new = z + dz
                    f_new = fval(z_new)
                    ok = f_new < f
                    z = jnp.where(ok, z_new, z)
                    f = jnp.where(ok, f_new, f)
                    lam = jnp.where(ok, lam * 0.25, lam * 4.0)
                    moved = jnp.where(
                        ok, jnp.max(jnp.abs(dz)), jnp.asarray(jnp.inf)
                    )
                    return z, lam, f, it + 1, moved

                def cond(state):
                    _z, lam, _f, it, moved = state
                    return (it < 80) & (lam < 1e10) & (moved > 1e-6)

                z0 = jnp.zeros(n_p)
                state = (
                    z0, jnp.asarray(1e-3), fval(z0), jnp.asarray(0),
                    jnp.asarray(jnp.inf),
                )
                z, _lam, f, _it, _mv = jax.lax.while_loop(cond, body, state)
                return f, _unpack(z, d0, a0, zeta0, csa0)

            self._solve_device = jax.jit(_lm_core)

            # Fused alternating cycle (method="device" with rsCSA): one
            # dispatch per global+local cycle instead of the ~10 the
            # host-driven loop pays (LM dispatch + up to 8 golden-section
            # rounds each fetching their edge mask).  CSA cannot be a
            # global here (CSA+rsCSA rejected above), so _unpack passes
            # csa0 through and the local stage owns it.
            if self.do_local:
                covered_j = jnp.asarray(
                    np.asarray(es_ref.coverage_counts()) > 0
                )
                _lw, _ln, _lx = _LOCAL_STEP_DEFAULTS

                def _cycle_core(d0, a0, zeta0, csa0):
                    _f1, (d1, a1, z1, _c) = _lm_core(d0, a0, zeta0, csa0)

                    def f(c):
                        return chisq_per_residue(es_ref, d1, a1, z1, c)

                    # Same walk as GlobalFitter.local_step: golden-section
                    # per residue, re-centred at any bracket edge with the
                    # half-width doubled, up to _lx rounds.
                    def body(st):
                        best, hw, it, _ = st
                        lo = best - hw
                        hi = best + hw
                        nb = golden_vec(f, lo, hi, n_iter=_ln)
                        at_edge = (
                            jnp.minimum(nb - lo, hi - nb) < 0.01 * hw
                        )
                        cont = jnp.any(at_edge & covered_j)
                        hw = jnp.where(at_edge, 2.0 * hw, hw)
                        return nb, hw, it + 1, cont

                    def cond(st):
                        return st[3] & (st[2] < _lx)

                    best, _hw, _it, _cn = jax.lax.while_loop(
                        cond,
                        body,
                        (
                            csa0,
                            jnp.full_like(csa0, _lw),
                            jnp.asarray(0),
                            jnp.asarray(True),
                        ),
                    )
                    csa1 = jnp.where(covered_j, best, csa0)
                    return d1, a1, z1, csa1

                self._cycle_device = jax.jit(_cycle_core)

    # -- parameter packing ---------------------------------------------
    def _get_globals(self) -> np.ndarray:
        vals = []
        for v in self.global_vars:
            if v == "Diso":
                vals.append(self.state.diso)
            elif v == "Daniso":
                vals.append(self.state.aniso)
            elif v == "zeta":
                vals.append(self.state.zeta)
            elif v == "CSA":
                vals.append(float(np.mean(self.state.csa)))
        return np.array(vals)

    def _set_globals(self, x: np.ndarray):
        for v, val in zip(self.global_vars, x):
            if v == "Diso":
                self.state.diso = float(val)
            elif v == "Daniso":
                self.state.aniso = float(val)
            elif v == "zeta":
                self.state.zeta = float(val)
            elif v == "CSA":
                self.state.csa[:] = float(val)

    def chisq(self) -> float:
        s = self.state
        return float(self._chisq(s.diso, s.aniso, s.zeta, jnp.asarray(s.csa)))

    def _objective_np(self, x) -> float:
        self._set_globals(np.atleast_1d(np.asarray(x, dtype=float)))
        return self.chisq()

    # -- optimisation stages --------------------------------------------
    def global_step(self, method: str = "powell") -> float:
        x0 = self._get_globals()
        if len(x0) == 0:
            return self.chisq()
        if method == "powell":
            from scipy.optimize import fmin_powell

            direc = np.diag([STEP_SIZES[v] for v in self.global_vars])
            out = fmin_powell(
                self._objective_np, x0=x0, direc=direc, full_output=True, disp=False
            )
            xbest, fbest = out[0], out[1]
        elif method == "gradient":
            from scipy.optimize import minimize

            def f_and_g(x):
                self._set_globals(np.atleast_1d(x))
                s = self.state
                csa_j = jnp.asarray(s.csa)
                f = float(self._chisq(s.diso, s.aniso, s.zeta, csa_j))
                g_full = self._grad(s.diso, s.aniso, s.zeta, csa_j)
                gsel = []
                for v in self.global_vars:
                    if v == "Diso":
                        gsel.append(float(g_full[0]))
                    elif v == "Daniso":
                        gsel.append(float(g_full[1]))
                    elif v == "zeta":
                        gsel.append(float(g_full[2]))
                    elif v == "CSA":
                        # dchi/dCSA_scalar = sum_i dchi/dcsa_i (one jitted
                        # grad covers it; no per-iterate re-trace)
                        gsel.append(float(jnp.sum(g_full[3])))
                return f, np.array(gsel)

            # Scale parameters so L-BFGS sees O(1) magnitudes.  jac=True
            # hands scipy the (f, g) pair from ONE forward+grad evaluation
            # instead of separate fun/jac callbacks that would recompute
            # the chi-square graph twice per iterate.
            scales = np.array(
                [abs(v) if abs(v) > 0 else 1.0 for v in x0], dtype=float
            )

            def fg_scaled(z):
                f, g = f_and_g(z * scales)
                return f, g * scales

            res = minimize(
                fg_scaled,
                x0 / scales,
                jac=True,
                method="L-BFGS-B",
            )
            xbest, fbest = res.x * scales, res.fun
        elif method == "device":
            # The entire optimisation as ONE device dispatch: jax's pure
            # BFGS traced under jit (built once in __init__), so no
            # host<->device round-trip per iterate (the scipy-driven
            # paths fetch f and g each iterate).  Parameters are scaled
            # to O(1) like the
            # gradient path.
            s = self.state
            fdev, (d_b, a_b, z_b, c_b) = self._solve_device(
                s.diso, s.aniso, s.zeta, jnp.asarray(s.csa)
            )
            vals = {
                "Diso": float(d_b), "Daniso": float(a_b),
                "zeta": float(z_b), "CSA": float(np.asarray(c_b)[0]),
            }
            xbest = np.array([vals[v] for v in self.global_vars])
            fbest = float(fdev)
        else:
            raise ValueError(f"unknown method {method!r}")
        self._set_globals(np.atleast_1d(xbest))
        self.state.chisq = float(fbest)
        return self.state.chisq

    def local_step(self, half_width: float = _LOCAL_STEP_DEFAULTS[0],
                   n_iter: int = _LOCAL_STEP_DEFAULTS[1],
                   max_expand: int = _LOCAL_STEP_DEFAULTS[2]):
        """Batched rsCSA: golden-section over each residue's CSA in a
        bracket around the current value; residues decouple so one
        vectorised search replaces nRes sequential Powell fits.

        The reference's per-residue Powell (spectral_densities.py:1371-1382)
        is unbounded, so the bracket must not silently clamp a far-off
        optimum: residues whose minimiser lands at (or outside) the bracket
        edge are re-CENTRED at that edge with the half-width doubled and
        re-searched, up to ``max_expand`` rounds — cumulative reach
        +-(2^max_expand - 1)*half_width (~+-38 000 ppm at the defaults,
        far past any physical CSA)."""
        s = self.state
        csa0 = jnp.asarray(s.csa)
        covered = np.asarray(self.es.coverage_counts()) > 0

        def f(c):
            return self._chisq_res(s.diso, s.aniso, s.zeta, c)

        hw = jnp.full_like(csa0, half_width)
        best = csa0
        for _ in range(max_expand):
            lo = best - hw
            hi = best + hw
            best = golden_vec(f, lo, hi, n_iter=n_iter)
            # Edge detection in units of the bracket width: golden-section
            # converges interior minima well inside the bracket, so a
            # result within 1% of an edge means the true optimum may lie
            # outside -> re-centre there and double the width.
            at_edge = jnp.minimum(best - lo, hi - best) < 0.01 * hw
            if not bool(jnp.any(at_edge & jnp.asarray(covered))):
                break
            hw = jnp.where(at_edge, 2.0 * hw, hw)
        new = np.asarray(best)
        # Residues with no experimental coverage keep their CSA
        # (reference skips them: nExpts>0 check, :1375-1377).
        s.csa = np.where(covered, new, s.csa)

    def run(
        self,
        max_cycles: int = 10,
        tol: float = 1e-6,
        method: str = "powell",
        verbose: bool = False,
    ) -> FitState:
        """Alternating global/local loop (perform_optimisation,
        spectral_densities.py:1302-1358)."""
        has_global = len(self.global_vars) > 0
        if not has_global and not self.do_local:
            # No optimisation variables requested: evaluate and return —
            # the alternating loop below would otherwise run an
            # UNREQUESTED rsCSA local pass, mutating state.csa (the CLI
            # guards with `if opt_params:`, the library surface didn't).
            self.state.chisq = self.chisq()
            return self.state
        if has_global and not self.do_local:
            self.global_step(method)
            return self.state
        if self.do_local and not has_global:
            self.local_step()
            self.state.chisq = self.chisq()
            return self.state
        # method="device": the whole global+local cycle is ONE compiled
        # dispatch and one packed fetch; the host only applies the
        # reference's convergence checks between cycles.
        fused = method == "device" and getattr(self, "_cycle_device", None)
        first = True
        for n in range(max_cycles):
            prev_glob = self._get_globals()
            if fused:
                s = self.state
                d1, a1, z1, csa1 = (
                    np.asarray(x)
                    for x in jax.device_get(
                        self._cycle_device(
                            s.diso, s.aniso, s.zeta, jnp.asarray(s.csa)
                        )
                    )
                )
                vals = {"Diso": d1, "Daniso": a1, "zeta": z1}
                self._set_globals(
                    np.array([vals[v] for v in self.global_vars])
                )
            else:
                self.global_step(method)
            now_glob = self._get_globals()
            # atol=0: allclose's default atol=1e-8 would dominate rtol for
            # the small-magnitude parameters here (Diso ~4e-5 ps^-1,
            # CSA ~1.7e-4) and stop the alternation orders of magnitude
            # before the requested relative tolerance.
            if not first and np.allclose(prev_glob, now_glob, rtol=tol, atol=0.0):
                break
            prev_csa = self.state.csa.copy()
            if fused:
                self.state.csa = np.asarray(csa1, dtype=float).copy()
            else:
                self.local_step()
            if not first and np.allclose(
                prev_csa, self.state.csa, rtol=tol, atol=0.0
            ):
                self.state.chisq = self.chisq()
                break
            first = False
            if verbose:
                print(f"    ...cycle {n}: chisq {self.chisq():.6g}")
        self.state.chisq = self.chisq()
        return self.state
