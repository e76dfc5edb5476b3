"""Benchmark: multi-field global-fit inner loop (BASELINE config #5).

Measures one full chi-square evaluation (6 experiments x nRes residues x
nSamp vector samples, new-API semantics) on the device, vs the reference's
eval_all on CPU — the quantity both optimisers call per step.

Usage: python tools/bench_multifield.py [--nres 200] [--nsamp 2592]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nres", type=int, default=200)
    p.add_argument("--nsamp", type=int, default=2592, help="72x36 histogram bins")
    p.add_argument("--ref", action="store_true", help="also time the reference on CPU")
    p.add_argument("--no-collapse", action="store_true",
                   help="A/B: disable the moment-collapsed ensemble path")
    p.add_argument("--opt", default="", metavar="M1,M2",
                   help="also time full Diso+Daniso optimisations per method "
                   "(powell/gradient/device)")
    a = p.parse_args()

    import jax
    import jax.numpy as jnp

    from spinrelax_tpu.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu.fit import globalfit
    from spinrelax_tpu.fit.globalfit import chisq_total

    if a.no_collapse:
        globalfit.USE_MOMENT_COLLAPSE = False
    from spinrelax_tpu.io.experiments import ExperimentData
    from spinrelax_tpu.models import CtModelSet, Diffusion
    from spinrelax_tpu.models.experiments import ExperimentSet
    from spinrelax_tpu.ops import observables as obs

    rng = np.random.default_rng(0)
    n, s = a.nres, a.nsamp
    names = [str(i + 2) for i in range(n)]
    cts = CtModelSet.from_lists(
        names,
        rng.uniform(0.6, 0.9, n),
        list(rng.uniform(0.02, 0.1, (n, 2))),
        list(np.stack([rng.uniform(5, 30, n), rng.uniform(100, 800, n)], -1)),
        s2fast=[True] * n,
        zeta=0.89,
        sort=False,
    )
    v = rng.normal(size=(n, s, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.uniform(0.0, 3.0, (n, s)).astype(np.float32)
    diff = Diffusion.axisymmetric(diso=4e-5, aniso=1.5)

    expts = []
    for f in (600.133, 850.13):
        pair = NucleusPair(B0=field_from_mhz(f), time_unit="ps")
        rates = obs.predict_rates_newapi(pair, diff, cts, vecs=v, weights=w)
        for t, vals, errs in (
            ("R1", rates.R1, rates.dR1),
            ("R2", rates.R2, rates.dR2),
            ("NOE", rates.NOE, rates.dNOE),
        ):
            expts.append(
                ExperimentData(
                    expt_type=t, nuclei_a="15N", nuclei_b="1H", frequency=f,
                    freq_unit="MHz", names=np.array(names),
                    values=np.asarray(vals).copy(),
                    errors=np.maximum(np.asarray(errs), 1e-3),
                )
            )
    es = ExperimentSet.build(expts, cts, diff, vecs=v, weights=w)

    csa = jnp.asarray(np.full(n, -170e-6))

    @jax.jit
    def chi(diso):
        return chisq_total(es, diso, es.diffusion.aniso, cts.zeta, csa)

    # Warm-up + force; pre-stage the scalar arguments on device so the
    # loop times the evaluation, not host->device scalar transfers.
    disos = [
        jax.device_put(jnp.float32(4e-5 * (1.0 + 1e-5 * k))) for k in range(1, 21)
    ]
    jax.block_until_ready(disos)

    def timed_loop(fn):
        _ = float(fn(disos[0]))
        best = None
        for _round in range(2):  # steady state on the 2nd round
            t0 = time.perf_counter()
            acc = jnp.float32(0.0)
            for d in disos:
                acc = acc + fn(d)
            _ = float(acc)
            best = (time.perf_counter() - t0) / len(disos)
        return best

    dt_eval = timed_loop(chi)

    # Per-dispatch floor in THIS process (a trivial chained jitted op),
    # for separating launch overhead from the evaluation's compute.
    @jax.jit
    def null_op(d):
        return d * 1.0000001

    dt_null = timed_loop(null_op)

    out = {
        "metric": "multifield_chisq_eval_ms",
        "value": dt_eval * 1e3,
        "unit": "ms",
        "null_dispatch_ms": dt_null * 1e3,
        "moment_collapse": bool(
            __import__(
                "spinrelax_tpu.fit.globalfit", fromlist=["USE_MOMENT_COLLAPSE"]
            ).USE_MOMENT_COLLAPSE
        ),
        "config": f"{n} residues x {s} samples x 6 experiments",
    }

    if a.opt:
        # Full Diso+Daniso optimisation wall time per method, starting
        # 20%/20% off the truth (compile excluded via a throwaway run).
        from spinrelax_tpu.fit.globalfit import GlobalFitter

        for method in a.opt.split(","):
            def fresh():
                es2 = ExperimentSet.build(
                    expts, cts,
                    Diffusion.axisymmetric(diso=4.8e-5, aniso=1.2),
                    vecs=v, weights=w,
                )
                return GlobalFitter(es2, ["Diso", "Daniso"])

            f0 = fresh()
            f0.run(method=method)  # compile warm-up
            f1 = fresh()
            t0 = time.perf_counter()
            state = f1.run(method=method)
            dt_opt = time.perf_counter() - t0
            out[f"opt_{method}_s"] = dt_opt
            out[f"opt_{method}_diso_err"] = abs(state.diso / 4e-5 - 1.0)

    if a.ref:
        sys.path.insert(0, "tools/refshim")
        sys.path.insert(0, "/root/reference")
        import fitting_Ct_functions as fitCt
        import spectral_densities as sd

        grd = sd.globalRotationalDiffusion_Axisymmetric(D=[4e-5, 1.5])
        grd.bVecs = True
        grd.vecNames = np.array(names)
        grd.vecXH = np.swapaxes(v, 0, 1).astype(np.float64)
        grd.vecWeights = np.swapaxes(w, 0, 1).astype(np.float64)
        grd.axisAvg = 0
        grd.update_A_coefficients()
        ac = fitCt.autoCorrelations()
        S2 = np.asarray(cts.S2)
        C = np.asarray(cts.C)
        tau = np.asarray(cts.tau)
        for i, nm in enumerate(names):
            ac.add_model(nm, listC=list(C[i]), listTau=list(tau[i]), S2=S2[i], bS2Fast=True)
        ac.set_zeta(0.89)
        objE = sd.spinRelaxationExperiments(grd, ac)
        import tempfile

        from spinrelax_tpu.io.experiments import write_experiment

        with tempfile.TemporaryDirectory() as td:
            for i, e in enumerate(expts):
                fn = f"{td}/e{i}.dat"
                write_experiment(fn, e)
                objE.add_experiment(fn)
        objE.map_experiment_peaknames_to_models()
        t0 = time.perf_counter()
        objE.eval_all()
        ref_dt = time.perf_counter() - t0
        out["reference_eval_ms"] = ref_dt * 1e3
        out["vs_baseline"] = ref_dt / dt_eval

    print(json.dumps(out))


if __name__ == "__main__":
    main()
