"""Benchmark: C(t)-fit + R1/R2/NOE throughput in residues/second
(the second BASELINE metric; reference ~9.5 residues/s on CPU via
sequential scipy ladder + per-residue J/relax loops).

One jitted program: batched 2-component LM fit of synthetic decays ->
J(omega) -> R1/R2/NOE for all residues.

Usage: python tools/bench_fit.py [--nres 10000] [--ndeltas 500]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

REFERENCE_CPU_RES_PER_S = 9.5  # the reference's CPU scripts, one core


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nres", type=int, default=10_000)
    p.add_argument("--ndeltas", type=int, default=500)
    p.add_argument("--ladder", action="store_true",
                   help="benchmark the FULL DoF ladder (per-rung dense LM "
                        "+ host model selection, the production default) "
                        "instead of the fixed-K finish")
    p.add_argument("--staged", action="store_true",
                   help="with --ladder: decays already device-resident "
                        "(the flagship run_sharded_finish path hands the "
                        "ladder the streamed C(t) accumulators on device; "
                        "default measures the host-fed CLI path incl. the "
                        "host->device transfer)")
    a = p.parse_args()

    import jax
    import jax.numpy as jnp

    from spinrelax_tpu.constants import NucleusPair
    from spinrelax_tpu.fit.lm import fit_multiexp
    from spinrelax_tpu.ops.jomega import j_combine_isotropic
    from spinrelax_tpu.ops import relaxation as rx

    N, D = a.nres, a.ndeltas
    pair = NucleusPair(time_unit="ps")
    omega = jnp.asarray(pair.omega5(), dtype=jnp.float32)
    f_dd, f_csa, tf = pair.factor_dd(), pair.factor_csa(), pair.time_fact
    gr = pair.gamma_b / pair.gamma_a
    dt = (jnp.arange(D, dtype=jnp.float32) + 1.0)

    @jax.jit
    def gen(key):
        kS, kC, kt, kn = jax.random.split(key, 4)
        S2 = jax.random.uniform(kS, (N,), minval=0.6, maxval=0.9)
        C = jax.random.uniform(kC, (N, 2), minval=0.02, maxval=0.1)
        tau = jnp.stack(
            [jax.random.uniform(kt, (N,), minval=5.0, maxval=30.0),
             jax.random.uniform(kt, (N,), minval=100.0, maxval=400.0)], -1
        )
        decay = S2[:, None] + jnp.sum(
            C[:, :, None] * jnp.exp(-dt[None, None, :] / tau[:, :, None]), 1
        )
        return decay + 1e-4 * jax.random.normal(kn, (N, D))

    @jax.jit
    def step(decays, acc):
        fit = fit_multiexp(dt, decays, jnp.ones_like(decays), K=2,
                           s2_free=True)
        J = j_combine_isotropic(omega, 4242.0, fit.S2, fit.C, fit.tau)
        R1 = rx.r1_from_j(J, f_dd, f_csa, tf)
        R2 = rx.r2_from_j(J, f_dd, f_csa, tf)
        NOE = rx.noe_from_j(J, f_dd, tf, gr, R1)
        return acc + R1[0] + R2[-1] + NOE[N // 2]

    n_iter = 5
    key = jax.random.PRNGKey(int(time.time()) & 0x7FFFFFFF)
    # 2*n_iter+1 inputs: the LAST is reserved for compile/warm-up, so
    # every timed call sees fresh data.
    inputs = [gen(k) for k in jax.random.split(key, 2 * n_iter + 1)]

    if a.ladder:
        # Full ladder: 5 rungs (2,3,5,7,9 params), one dense vmapped LM
        # per rung (the production DEFAULT — the all-rungs-stacked solve
        # is slower) + the reference's
        # sequential per-residue selection on the host.
        from spinrelax_tpu.fit.expfit import fit_ct_ladder

        names = [str(i) for i in range(N)]
        dt_np = np.asarray(dt)
        if a.staged:
            # Flagship path: run_sharded_finish hands the ladder the
            # streamed C(t) accumulators already ON DEVICE (fit_ct_ladder's
            # jnp.asarray is then a no-op) — no host->device decay shipping.
            feed = [jax.block_until_ready(x) for x in inputs]
        else:
            feed = [np.asarray(x, dtype=np.float32) for x in inputs]
        fit_ct_ladder(names, dt_np, feed[-1])  # compile
        dtime = None
        for rnd in range(2):
            batch = feed[rnd * n_iter : (rnd + 1) * n_iter]
            t0 = time.perf_counter()
            for x in batch:
                model = fit_ct_ladder(names, dt_np, x)
            dtime = (time.perf_counter() - t0) / n_iter
            assert np.isfinite(np.asarray(model.S2)).all()
        rate = N / dtime
        print(json.dumps({
            "metric": "fit_ladder_residues_per_s",
            "value": rate,
            "unit": "residues/s",
            "config": f"{N} residues x {D} lags, full DoF ladder "
                      "(per-rung LM + selection, "
                      + ("device-staged decays" if a.staged
                         else "host-fed decays") + ")",
            "vs_baseline": rate / REFERENCE_CPU_RES_PER_S,
        }))
        return
    float(step(inputs[-1], jnp.float32(0.0)))  # compile + settle
    dtime = None
    for rnd in range(2):
        batch = inputs[rnd * n_iter : (rnd + 1) * n_iter]
        t0 = time.perf_counter()
        acc = jnp.float32(0.0)
        for x in batch:
            acc = step(x, acc)
        assert np.isfinite(float(acc))
        dtime = (time.perf_counter() - t0) / n_iter

    rate = N / dtime
    print(json.dumps({
        "metric": "fit_relax_residues_per_s",
        "value": rate,
        "unit": "residues/s",
        "config": f"{N} residues x {D} lags, 2-component LM + R1R2NOE",
        "vs_baseline": rate / REFERENCE_CPU_RES_PER_S,
    }))


if __name__ == "__main__":
    main()
