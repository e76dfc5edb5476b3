"""Unit tests for the unrolled small-SPD Cholesky kernels behind the LM
solver (fit/lm.py) — the replacements for batched ``jnp.linalg.solve`` /
``pinv``, whose batched tiny-system lowerings can scalar-loop.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spinrelax_tpu.fit.lm import (
    _chol_solve_small,
    _multiexp_res_jac,
    _multiexp_residual,
    _spd_inv_diag_small,
    fit_multiexp,
    fit_multiexp_varpro,
    lm_solve,
)


def _spd(rng, P, n=None):
    if n is None:
        J = rng.normal(size=(40, P))
        return J.T @ J + 1e-3 * np.eye(P)
    out = np.empty((n, P, P))
    for i in range(n):
        J = rng.normal(size=(40, P))
        out[i] = J.T @ J + (1e-3 + 0.01 * i) * np.eye(P)
    return out


@pytest.mark.parametrize("P", [2, 3, 5, 7, 9])
def test_chol_solve_matches_linalg(rng, P):
    A = _spd(rng, P)
    b = rng.normal(size=P)
    x = np.asarray(_chol_solve_small(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-12)


def test_chol_solve_batched_and_jvp(rng):
    P = 7
    A = _spd(rng, P, n=8)
    b = rng.normal(size=(8, P))
    x = np.asarray(jax.vmap(_chol_solve_small)(jnp.asarray(A), jnp.asarray(b)))
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-11)

    # Forward-mode derivative equals linalg.solve's for SYMMETRIC tangents
    # (the only tangents the LM/varpro paths produce: A = J^T J + diag).
    A0 = jnp.asarray(A[0])
    b0 = jnp.asarray(b[0])
    S = rng.normal(size=(P, P))
    dA = jnp.asarray(S + S.T)
    db = jnp.asarray(rng.normal(size=P))
    _, t1 = jax.jvp(_chol_solve_small, (A0, b0), (dA, db))
    _, t2 = jax.jvp(jnp.linalg.solve, (A0, b0), (dA, db))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-10)


@pytest.mark.parametrize("P", [2, 5, 9])
def test_spd_inv_diag_matches_inv(rng, P):
    A = _spd(rng, P)
    d = np.asarray(_spd_inv_diag_small(jnp.asarray(A)))
    np.testing.assert_allclose(d, np.diag(np.linalg.inv(A)), rtol=1e-11)


def test_cov_chol_zero_column_matches_scipy_truncation(rng):
    """An EXACTLY-dead Jacobian column (e.g. a component whose C_i
    underflowed to 0, zeroing its tau column) must get ZERO variance —
    scipy curve_fit's pcov comes from a truncated SVD that zeroes
    degenerate directions, so the reference ACCEPTS such fits; a NaN
    here would make ok_err reject the rung and model selection diverge
    (round-3 review finding)."""
    T = 60
    t = jnp.asarray(np.linspace(0.1, 6.0, T))
    y = jnp.asarray(np.exp(-np.linspace(0.1, 6.0, T)) + 1e-3 * rng.normal(size=T))

    def resid(p):
        # p = [a, b, dead]: the third parameter never enters the model.
        return p[0] * jnp.exp(-t / p[1]) - y + 0.0 * p[2] * jnp.zeros_like(t)

    p0 = jnp.asarray([0.9, 1.2, 0.5])
    lo = jnp.zeros(3)
    hi = jnp.asarray([2.0, 10.0, 1.0])
    for cov in ("chol", "pinv"):
        res = lm_solve(resid, p0, lo, hi, cov=cov)
        perr = np.asarray(res.perr)
        assert np.isfinite(perr[:2]).all(), cov
        assert perr[2] == 0.0, cov  # dead direction: zero, not NaN/inf

    with pytest.raises(ValueError):
        lm_solve(resid, p0, lo, hi, cov="cholesky")


def test_spd_inv_diag_nan_on_singular():
    # An exactly-zero row/column must NOT silently produce zeros the way
    # pinv does — the dense paths rely on NaN/inf here to reject the fit.
    A = np.diag([1.0, 0.0, 2.0])
    d = np.asarray(_spd_inv_diag_small(jnp.asarray(A)))
    assert not np.isfinite(d).all()


def _decays(rng, n, K, T):
    dt = np.arange(1.0, T + 1.0)
    S2 = rng.uniform(0.6, 0.9, n)
    C = rng.uniform(0.03, 0.1, (n, K))
    tau = np.sort(rng.uniform(5.0, 300.0, (n, K)), axis=1)
    dec = S2[:, None] + np.einsum(
        "rk,rkt->rt", C, np.exp(-dt[None, None, :] / tau[:, :, None])
    )
    return dt, dec + 1e-4 * rng.normal(size=(n, T))


def test_lm_cov_chol_matches_pinv(rng):
    """For WELL-CONDITIONED fits the Cholesky covariance equals pinv's.

    Rank-deficient lanes (a dead component's tau column ~0) are the
    DOCUMENTED divergence — pinv zeroes the degenerate direction, chol
    reports a huge/NaN uncertainty that ok_err then rejects — so the
    comparison is restricted to lanes whose J^T J condition number is
    sound."""
    K, T = 2, 300
    dt, dec = _decays(rng, 6, K, T)
    dt_j = jnp.asarray(dt)
    one = jnp.ones(T)

    def run(cov):
        def fit_one(y):
            p0 = jnp.asarray([0.05, 0.05, 10.0, 100.0, 0.7])
            lo = jnp.asarray([0.0, 0.0, 1e-8, 1e-8, 0.0])
            hi = jnp.asarray([1.0, 1.0, dt_j[-1] * 10, dt_j[-1] * 10, 1.0])
            res = lm_solve(
                lambda p: _multiexp_residual(p, dt_j, y, one, K, True),
                p0, lo, hi, cov=cov,
            )
            Jp = jax.jacfwd(
                lambda p: _multiexp_residual(p, dt_j, y, one, K, True)
            )(res.params)
            return res.params, res.perr, Jp.T @ Jp
        return jax.vmap(fit_one)(jnp.asarray(dec))

    p1, e1, H = run("chol")
    p2, e2, _ = run("pinv")
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-12)
    good = np.linalg.cond(np.asarray(H)) < 1e10
    assert good.any(), "test data produced no well-conditioned lane"
    np.testing.assert_allclose(
        np.asarray(e1)[good], np.asarray(e2)[good], rtol=1e-6
    )


def test_convergence_gates_preserve_solution(rng):
    """The 10-ulp ftol / stuck-lambda gates must not change the fitted
    parameters beyond optimiser noise at f64 (they fire far beyond
    curve_fit's own 1e-8 stopping)."""
    K, T = 2, 400
    dt, dec = _decays(rng, 8, K, T)
    fit_a = fit_multiexp(jnp.asarray(dt), jnp.asarray(dec),
                         jnp.ones_like(jnp.asarray(dec)), K=K, s2_free=True)
    # ungated reference: disable both gates
    dt_j = jnp.asarray(dt)
    one = jnp.ones(T)

    def fit_one(y):
        from spinrelax_tpu.fit.lm import _init_multiexp
        C0, tau0, S20 = _init_multiexp(dt_j, y, K, True)
        p0 = jnp.concatenate([C0, tau0, jnp.asarray(S20)[None]])
        lo = jnp.concatenate([jnp.zeros(K), jnp.full(K, 1e-8), jnp.zeros(1)])
        hi = jnp.concatenate([jnp.ones(K), jnp.full(K, dt_j[-1] * 10), jnp.ones(1)])
        res = lm_solve(
            lambda p: _multiexp_residual(p, dt_j, y, one, K, True),
            p0, lo, hi, ftol=0.0, lam_stuck=np.inf, cov="chol",
        )
        return res.params
    p_ref = np.asarray(jax.vmap(fit_one)(jnp.asarray(dec)))
    S2_a = np.asarray(fit_a.S2)
    np.testing.assert_allclose(S2_a, p_ref[:, -1], atol=2e-7)


@pytest.mark.parametrize("K,s2_free", [(1, True), (2, True), (2, False),
                                       (4, True), (4, False)])
def test_multiexp_analytic_jacobian_matches_ad(rng, K, s2_free):
    """The closed-form residual Jacobian that replaced the in-loop jacfwd
    must BE the AD Jacobian — same residual, same
    derivative — for every rung shape the DoF ladder uses."""
    T = 120
    dt = jnp.asarray(np.arange(1.0, T + 1.0))
    y = jnp.asarray(0.7 + 0.2 * np.exp(-np.arange(1.0, T + 1.0) / 40.0)
                    + 1e-3 * rng.normal(size=T))
    sg = jnp.asarray(rng.uniform(0.5, 2.0, T))
    P = 2 * K + (1 if s2_free else 0)
    p = jnp.asarray(np.concatenate([
        rng.uniform(0.02, 0.2, K),                  # C
        np.sort(rng.uniform(3.0, 200.0, K)),        # tau
        rng.uniform(0.5, 0.9, 1)[: (1 if s2_free else 0)],
    ]))
    assert p.shape == (P,)
    r_an, J_an = _multiexp_res_jac(p, dt, y, sg, K, s2_free)
    r_ad = _multiexp_residual(p, dt, y, sg, K, s2_free)
    J_ad = jax.jacfwd(
        lambda q: _multiexp_residual(q, dt, y, sg, K, s2_free)
    )(p)
    np.testing.assert_allclose(np.asarray(r_an), np.asarray(r_ad), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(J_an), np.asarray(J_ad),
                               rtol=1e-12, atol=1e-14)


def test_stacked_masked_jacobian_freezes_inactive(rng):
    """The stacked solver's masked analytic Jacobian must keep inactive
    components' columns EXACTLY zero (that is what freezes them) and match
    AD on the active ones."""
    from spinrelax_tpu.fit.lm import fit_multiexp_stacked

    K, T = 2, 150
    dt, dec = _decays(rng, 4, K, T)
    Kmax = 4
    tau0 = np.tile(np.array([5.0, 20.0, 80.0, 300.0]), (4, 1))
    out = fit_multiexp_stacked(
        jnp.asarray(dt), jnp.asarray(dec), jnp.ones_like(jnp.asarray(dec)),
        jnp.full(4, K), jnp.asarray([True, True, False, False]),
        jnp.asarray(tau0), Kmax=Kmax,
    )
    C = np.asarray(out.C)
    dC = np.asarray(out.dC)
    # Padding components (sorted last) stay exactly zero; their pinv'd
    # uncertainties are null-space zeros up to SVD rounding (~1e-13).
    np.testing.assert_array_equal(C[:, K:], 0.0)
    assert np.abs(dC[:, K:]).max() < 1e-10
    assert np.isfinite(np.asarray(out.chisq)).all()


def test_varpro_degenerate_tau_start_survives(rng):
    """Single-exponential data under a K=2 varpro fit drives the two taus
    together mid-iteration, making the normal matrix numerically
    singular; the scale-aware ridge must keep the fit finite (the old
    absolute 1e-10 ridge relied on LU returning finite garbage)."""
    K, T = 2, 200
    dt = np.arange(1.0, T + 1.0)
    dec = 0.8 + 0.15 * np.exp(-dt / 50.0)
    dec = np.tile(dec, (3, 1)) + 1e-5 * rng.normal(size=(3, T))
    fit = fit_multiexp_varpro(jnp.asarray(dt), jnp.asarray(dec),
                              jnp.ones_like(jnp.asarray(dec)), K=K,
                              s2_free=True)
    assert np.isfinite(np.asarray(fit.S2)).all()
    assert np.isfinite(np.asarray(fit.chisq)).all()
    np.testing.assert_allclose(np.asarray(fit.S2), 0.8, atol=5e-3)
