"""Legacy explicit fit surface: func_exp_decay1..11 / Lipari-Szabo product
forms and the do_Expstyle_fit / do_LSstyle_fit drivers.

Reference: fitting_Ct_functions.py:483-660.  This surface is dormant in
the reference (no callers outside the module), but it is part of the
public API, so a functional equivalent is provided: the same model
families, the same per-DoF hard-coded initial guesses, the same return
contract (chi, params, perr, ymodel) including the _bound_check ->
9999.99 sentinel and calc_chi's division by dy (sic, not dy^2,
fitting_Ct_functions.py:547-551).

Accelerator-first shape: one vectorised model evaluator per family (fixed-width
parameter vectors, vmappable), fit by the shared batched LM
(:mod:`spinrelax_tpu.fit.lm`) instead of sequential scipy curve_fit.
``do_expstyle_fit`` / ``do_lsstyle_fit`` accept a single curve or a
(B, T) batch fitted in one vmapped solve.

Behavioural note documented per CLAUDE.md conventions: the reference's
``do_LSstyle_fit`` is BROKEN as shipped for num_pars >= 2 — the
func_LS_decay2..9 definitions are commented out
(fitting_Ct_functions.py:483-500), so it raises NameError.  Here the
intended product-form models are implemented and tested.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .lm import lm_solve


def _split_params(params, num_pars: int):
    """Unpack the reference's flat (guess-ordered) parameter vector.

    Odd num_pars: (S2, A1, tau1, A2, tau2, ...); even: (A1, tau1, ...).
    Returns (s2 or None, amps (K,), taus (K,)) with K = num_pars // 2.
    """
    params = jnp.asarray(params)
    if num_pars == 1:
        return None, jnp.ones(1, params.dtype), params[:1]
    if num_pars % 2 == 1:
        s2, rest = params[0], params[1:]
    else:
        s2, rest = None, params
    amps = rest[0::2]
    taus = rest[1::2]
    return s2, amps, taus


def exp_decay(t, params, num_pars: int):
    """func_exp_decayN (fitting_Ct_functions.py:511-534): a plain sum of
    exponentials; even DoF uses the implicit constant 1 - sum(A), odd DoF
    fits the constant S2 explicitly.  num_pars==1 is exp(-t/tau)."""
    t = jnp.asarray(t)
    scalar = t.ndim == 0  # the reference evaluates pointwise too
    tv = jnp.atleast_1d(t)
    s2, amps, taus = _split_params(params, num_pars)
    terms = jnp.sum(amps[:, None] * jnp.exp(-tv[None, :] / taus[:, None]), axis=0)
    if num_pars == 1:
        return terms[0] if scalar else terms
    const = s2 if s2 is not None else 1.0 - jnp.sum(amps)
    out = const + terms
    return out[0] if scalar else out


def ls_decay(t, params, num_pars: int):
    """Lipari-Szabo product forms func_LS_decayN (the intended behaviour
    of the commented-out definitions, fitting_Ct_functions.py:483-500):
    prod_i (S2_i + (1-S2_i) exp(-t/tau_i)), odd DoF premultiplied by a
    free S2_0.  num_pars==1 is exp(-t/tau)."""
    t = jnp.asarray(t)
    if num_pars == 1:
        return jnp.exp(-t / jnp.asarray(params)[0])
    scalar = t.ndim == 0  # pointwise evaluation like the reference
    tv = jnp.atleast_1d(t)
    s2_0, amps, taus = _split_params(params, num_pars)
    factors = amps[:, None] + (1.0 - amps[:, None]) * jnp.exp(
        -tv[None, :] / taus[:, None]
    )
    out = jnp.prod(factors, axis=0)
    if s2_0 is not None:
        out = s2_0 * out
    return out[0] if scalar else out


def _exp_guess(num_pars: int, t_max: float) -> np.ndarray:
    """Hard-coded initial guesses of do_Expstyle_fit
    (fitting_Ct_functions.py:612-655)."""
    g = {
        1: (t_max / 2.0,),
        2: (0.5, t_max / 2.0),
        3: (0.5, 0.5, t_max / 2.0),
        4: (0.33, t_max / 20.0, 0.33, t_max / 2.0),
        5: (0.33, 0.33, t_max / 20.0, 0.33, t_max / 2.0),
        6: (0.25, t_max / 50.0, 0.25, t_max / 10.0, 0.25, t_max / 2.0),
        7: (0.25, 0.25, t_max / 50.0, 0.25, t_max / 10.0, 0.25, t_max / 2.0),
        8: (0.2, t_max / 64.0, 0.2, t_max / 16.0, 0.2, t_max / 4.0, 0.2, t_max),
        9: (0.2, 0.2, t_max / 64.0, 0.2, t_max / 16.0, 0.2, t_max / 4.0, 0.2, t_max),
    }
    return np.asarray(g[num_pars], dtype=float)


def _ls_guess(num_pars: int, t_max: float) -> np.ndarray:
    """Hard-coded initial guesses of do_LSstyle_fit
    (fitting_Ct_functions.py:555-610)."""
    g = {
        1: (t_max / 2.0,),
        2: (0.5, t_max / 2.0),
        3: (0.69, 0.69, t_max / 2.0),
        4: (0.69, t_max / 2.0, 0.69, t_max / 20.0),
        5: (0.71, 0.71, t_max / 2.0, 0.71, t_max / 20.0),
        6: (0.71, t_max / 2.0, 0.71, t_max / 8.0, 0.71, t_max / 32.0),
        7: (0.72, 0.72, t_max / 2.0, 0.72, t_max / 8.0, 0.72, t_max / 32.0),
        8: (0.72, t_max, 0.72, t_max / 4.0, 0.72, t_max / 16.0, 0.72, t_max / 64.0),
        9: (0.74, 0.74, t_max, 0.74, t_max / 4.0, 0.74, t_max / 16.0, 0.74, t_max / 64.0),
    }
    return np.asarray(g[num_pars], dtype=float)


def bound_check(params, num_pars: int) -> np.ndarray:
    """_bound_check (fitting_Ct_functions.py:536-545): True when the
    amplitude sum (plus explicit S2 for odd DoF) exceeds 1."""
    params = np.atleast_2d(np.asarray(params))
    if num_pars == 1:
        return np.zeros(params.shape[0], dtype=bool)
    if num_pars % 2 == 0:
        s = params[:, 0::2].sum(axis=1)
    else:
        s = params[:, 0] + params[:, 1::2].sum(axis=1)
    return s > 1.0


def calc_chi(y, ymodel, dy=None):
    """Reference chi (fitting_Ct_functions.py:547-551): mean squared
    residual, divided by dy — sic, NOT dy^2 (quirk replicated).

    The reference's default sentinel is an EMPTY LIST (``dy=[]``, :547),
    meaning unweighted — accept both None and any zero-length array."""
    y = np.asarray(y)
    ymodel = np.asarray(ymodel)
    sq = (y - ymodel) ** 2.0
    if dy is not None and np.asarray(dy).size:
        sq = sq / np.asarray(dy)
    return np.sum(sq, axis=-1) / y.shape[-1]


def _fit_family(model_fn, guess_fn, num_pars: int, x, y, dy=None,
                tau_cap_factor: float = 1e3):
    """Shared driver: batched bounded LM over the per-DoF guess table.

    The reference passes tau bounds of np.inf to curve_fit; the sigmoid
    box here needs a finite cap, set generously at tau_cap_factor * t_max
    (any tau at that edge is an unresolvable plateau either way).
    Returns (chi (B,), params (B, P), perr (B, P), ymodel (B, T)),
    squeezed to unbatched shapes when y is 1-D.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    single = y.ndim == 1
    yb = np.atleast_2d(y)
    dyb = None if dy is None or (hasattr(dy, "__len__") and len(dy) == 0) else np.atleast_2d(np.asarray(dy, dtype=float))

    t_max = float(x[-1])
    p0 = guess_fn(num_pars, t_max)  # both callers always pass a guess_fn
    # Bounds: amplitudes/S2 in [0, 1]; taus in (0, cap].
    lo = np.zeros(num_pars)
    hi = np.ones(num_pars)
    if num_pars == 1:
        tau_idx = np.array([0])
    elif num_pars % 2 == 0:
        tau_idx = np.arange(1, num_pars, 2)
    else:
        tau_idx = np.arange(2, num_pars, 2)
    lo[tau_idx] = 1e-8
    hi[tau_idx] = tau_cap_factor * t_max

    xj = jnp.asarray(x)
    loj, hij, p0j = jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(p0)

    def fit_one(yi, sgi):
        def resid(p):
            return (model_fn(xj, p, num_pars) - yi) / sgi

        return lm_solve(resid, p0j, loj, hij)

    yj = jnp.asarray(yb)
    if dyb is None:
        sg = jnp.ones_like(yj)
    else:
        # A single shared (T,) sigma must broadcast across the batch
        # (vmap rejects mismatched leading axes).
        sg = jnp.broadcast_to(jnp.asarray(dyb), yj.shape)
    res = jax.vmap(fit_one)(yj, sg)
    params = np.asarray(res.params)
    perr = np.asarray(res.perr)
    ymodel = np.asarray(
        jax.vmap(lambda p: model_fn(xj, p, num_pars))(res.params)
    )
    chi = calc_chi(yb, ymodel, dyb)
    # _bound_check -> 9999.99 sentinel (fitting_Ct_functions.py:621-627).
    chi = np.where(bound_check(params, num_pars), 9999.99, chi)
    if single:
        return float(chi[0]), params[0], perr[0], ymodel[0]
    return chi, params, perr, ymodel


def do_expstyle_fit(num_pars: int, x, y, dy=None):
    """do_Expstyle_fit equivalent (fitting_Ct_functions.py:612-660).

    Accepts y of shape (T,) or a batch (B, T) fitted in one vmapped LM.
    Returns (chi, params, perr, ymodel)."""
    if not 1 <= num_pars <= 9:
        raise ValueError(f"num_pars must be in 1..9, got {num_pars}")
    return _fit_family(exp_decay, _exp_guess, num_pars, x, y, dy)


def do_lsstyle_fit(num_pars: int, x, y, dy=None):
    """do_LSstyle_fit equivalent (fitting_Ct_functions.py:555-610) using
    the intended Lipari-Szabo product models (the reference's own version
    raises NameError for num_pars >= 2; see module docstring)."""
    if not 1 <= num_pars <= 9:
        raise ValueError(f"num_pars must be in 1..9, got {num_pars}")
    return _fit_family(ls_decay, _ls_guess, num_pars, x, y, dy)


# Named aliases mirroring the reference's public function family
# (func_exp_decay1..11; 10/11 exist in the reference numbering as the
# 5-term members, fitting_Ct_functions.py:520-534).
def _make_named(num_pars):
    def f(t, *params):
        # dtype follows the ambient jax x64 config (float64 in parity
        # mode); forcing f64 here would warn when x64 is disabled.
        return np.asarray(exp_decay(jnp.asarray(t), jnp.asarray(params), num_pars))

    f.__name__ = f"func_exp_decay{num_pars}"
    f.__doc__ = f"Positional-arg evaluator matching the reference's func_exp_decay{num_pars}."
    return f


_NUMBERED = {n: _make_named(n) for n in range(1, 12)}
func_exp_decay1 = _NUMBERED[1]
func_exp_decay2 = _NUMBERED[2]
func_exp_decay3 = _NUMBERED[3]
func_exp_decay4 = _NUMBERED[4]
func_exp_decay5 = _NUMBERED[5]
func_exp_decay6 = _NUMBERED[6]
func_exp_decay7 = _NUMBERED[7]
func_exp_decay8 = _NUMBERED[8]
func_exp_decay9 = _NUMBERED[9]
func_exp_decay10 = _NUMBERED[10]
func_exp_decay11 = _NUMBERED[11]
