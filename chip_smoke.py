"""Chip smoke run: drive the SpinRelax workflow once on one NVIDIA GPU.

    python chip_smoke.py           # phases P0-P5 on one card
    python chip_smoke.py --four    # only the mesh phase, on four cards

Everything runs in ONE process: a JAX process reserves most of a card's
memory when it starts, so a second process on the same card fails.

Phases (each prints one JSON line: phase, ok, shapes, compile_s =
first call incl. compilation, run_s = median of warm calls each ending
in block_until_ready, peak_bytes_in_use, and every compared error
beside its tolerance):

  P0 device    the platform must be "gpu" (there is no CPU fallback);
               card name + power limit, JAX version, XLA_FLAGS, compile
               cache and native libraries.
  P1 run-all   seeded ubiquitin-scale XTC (71 N-H bonds, 1231 atoms,
               10^5 frames, 1 ps) through ``cli.main(["run-all", ...])``
               at -t_mem 10000 (streamed) and -t_mem 1000 (in memory);
               fit-ct and relax rerun on the host CPU backend from the
               card's own artefacts.
  P2 C(t)      the streamed group step with both XLA forms of the ACF
               (matmul-DFT and jnp.fft) at 32x1000x1024 and 8x3000x1024
               against a float64 host reference on 128 bonds.
  P3 ladder    the in-graph DoF-ladder walk on 10^4 residues x 500 lags
               (adjacent-timescale hard mixes + clean 2-exponential
               controls) against the CPU backend on 512 of them.
  P4 rates     J(omega) + R1/R2/NOE for 200 residues x 2592 vector
               samples x 6 experiments against the CPU backend, and the
               on-device multi-field fit recovering D_iso.
  P5 dq        the dq stage on a 10^6-frame quaternion colvar x 100
               lags against the CPU backend in float32 and float64.

P2, P4 and P5 rerun their device computation under
``jax.default_matmul_precision("float32")``: any difference names an
f32 dot the card would otherwise run in TF32.

The last line of standard output is ``{"ok": true, "device": {...}}``
only when every phase passed; any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn, reps: int = 3):
    """(result, seconds of the first call, median seconds of ``reps``
    warm calls); every call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        runs.append(time.perf_counter() - t0)
    return out, first, statistics.median(runs)


def _check(name: str, err: float, tol: float, ok=None) -> dict:
    """One compared quantity: ``ok`` defaults to err <= tol."""
    err = float(err)
    return {"name": name, "err": err, "tol": tol,
            "ok": bool(err <= tol if ok is None else ok)}


def _record(phase: str, shapes, compile_s, run_s, checks, **extra) -> dict:
    rec = {
        "phase": phase,
        "ok": all(c["ok"] for c in checks),
        "shapes": shapes,
        "compile_s": compile_s,
        "run_s": run_s,
        "peak_bytes_in_use": _peak_bytes(),
        "checks": checks,
    }
    rec.update(extra)
    return rec


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _rel_lanes(a, b) -> np.ndarray:
    """Per-element relative difference; lanes NaN on both sides agree."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(a - b) / np.abs(b)
    both_nan = np.isnan(a) & np.isnan(b)
    return np.where(both_nan | (a == b), 0.0, np.nan_to_num(rel, nan=np.inf))


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@contextlib.contextmanager
def _on_cpu():
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        yield


class _CompileLog:
    """Backend compile durations (with the jitted function's name)
    recorded while the context is open."""

    def __init__(self):
        self.events = []
        self._on = False

    def _listener(self, event, duration, **kw):
        from jax._src import dispatch

        if self._on and event == dispatch.BACKEND_COMPILE_EVENT:
            self.events.append((kw.get("fun_name", "?"), float(duration)))

    def __enter__(self):
        import jax.monitoring

        if not getattr(_CompileLog, "_registered", False):
            jax.monitoring.register_event_duration_secs_listener(
                _CompileLog._dispatch)
            _CompileLog._registered = True
        _CompileLog._active = self
        self._on = True
        return self

    @staticmethod
    def _dispatch(event, duration, **kw):
        active = getattr(_CompileLog, "_active", None)
        if active is not None:
            active._listener(event, duration, **kw)

    def __exit__(self, *exc):
        self._on = False
        _CompileLog._active = None

    def summary(self) -> dict:
        top = sorted(self.events, key=lambda e: -e[1])[:5]
        return {"n": len(self.events),
                "total_s": sum(s for _, s in self.events),
                "largest": [{"fun_name": n, "seconds": s} for n, s in top]}


def _numbers(fn: str) -> np.ndarray:
    """Every numeric token of a text artefact (comment / legend / set
    terminator lines skipped)."""
    vals = []
    with open(fn) as fp:
        for line in fp:
            if not line.strip() or line.lstrip()[0] in "#@&":
                continue
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
    return np.asarray(vals)


def _artefact_ok(fn: str) -> bool:
    if not os.path.exists(fn):
        return False
    if fn.endswith(".npz"):
        from spinrelax_tpu.io import vectors

        _names, vecs, weights = vectors.load_vector_distribution(fn)
        return bool(np.isfinite(vecs).all() and np.isfinite(weights).all())
    vals = _numbers(fn)
    return vals.size > 0 and bool(np.isfinite(vals).all())


def _bond_vectors(key, g: int, n_frames: int, n_bonds: int):
    """(g, F, N, 3) f32 unit vectors on the device: a fixed direction per
    bond wobbling by an Ornstein-Uhlenbeck process (50-frame memory) —
    DC-heavy signals whose C(t) decays to a plateau, like real N-H
    bonds."""
    import jax
    import jax.numpy as jnp

    k0, k1 = jax.random.split(key)
    base = jax.random.normal(k0, (g, n_bonds, 3), jnp.float32)
    base = base / jnp.linalg.norm(base, axis=-1, keepdims=True)
    a = np.float32(np.exp(-1.0 / 50.0))
    noise = jax.random.normal(k1, (n_frames, g, n_bonds, 3), jnp.float32)

    def ou(x, xi):
        x = a * x + np.float32(np.sqrt(1.0 - a * a)) * xi
        return x, x

    _, wob = jax.lax.scan(ou, noise[0], noise)
    v = base[None] + 0.4 * wob
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.swapaxes(v, 0, 1)


def _acf_sums_host(v: np.ndarray, n_deltas: int) -> np.ndarray:
    """float64 numpy reference: (..., F, 3) -> (..., n_deltas) lag sums of
    (v(t).v(t+d))^2, straight from the definition's FFT form."""
    v = np.asarray(v, np.float64)
    n = v.shape[-2]
    nfft = 1 << int(np.ceil(np.log2(n + n_deltas)))
    power = 0.0
    for i in range(3):
        for j in range(i, 3):
            w = (1.0 if i == j else 2.0) ** 0.5
            spec = np.fft.rfft(w * v[..., i] * v[..., j], n=nfft, axis=-1)
            power = power + spec.real ** 2 + spec.imag ** 2
    return np.fft.irfft(power, n=nfft, axis=-1)[..., 1:n_deltas + 1]


# ---------------------------------------------------------------------------
# P0 device
# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    """Card name and power limit, read by a child process that never
    touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device() -> dict:
    import jax

    from spinrelax_tpu.io import native
    from spinrelax_tpu.utils import compile_cache

    d = jax.devices()[0]
    native.available()
    native.xtc_available()
    return {
        "phase": "P0_device",
        "ok": True,
        "platform": d.platform,
        "device_kind": d.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": nvidia_smi_line(),
        "jax": jax.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": compile_cache.cache_dir(),
        "native_libraries": native.library_report(),
    }


# ---------------------------------------------------------------------------
# P1 run-all
# ---------------------------------------------------------------------------

# (t_mem [ps], extra run-all flags): the reference default memory time
# through the streamed C(t) stage, and a 1 ns memory time in memory.
RUNALL_CASES = ((10000.0, ("-stream", "4")), (1000.0, ()))
D_TRUE = 3.3e-5  # ps^-1, the generator's isotropic tumbling


def _runall_artefacts(outpref: str, bfields) -> list:
    files = ["colvar-qorient"] + [
        outpref + s for s in (
            "-iso.dat", "-aniso2.dat", "-aniso_q.dat", "_Ctint.dat",
            "_Ctext.dat", "_S2.dat", "_fittedCt.dat", "_vecHistogram.npz")]
    for bf in bfields:
        files += [f"{outpref}-{int(bf)}_{r}.dat"
                  for r in ("R1", "R2", "NOE", "rho")]
    return files


def _acf_step_module_mb(n_frames: int, n_bonds: int, g: int = 4) -> float:
    """Serialized StableHLO size (MB) of the streamed C(t) group step at a
    chunk length: the matmul-DFT's factor matrices are embedded in it as
    constants (run-all's fused program holds two such ACFs)."""
    import jax
    import jax.numpy as jnp

    from spinrelax_tpu.ops import autocorr

    step = autocorr._stream_update_jit(n_frames, n_frames // 2)
    acc = jax.ShapeDtypeStruct((n_bonds, n_frames // 2), jnp.float32)
    exp = jax.export.export(step)(
        jax.ShapeDtypeStruct((g, n_frames, n_bonds, 3), jnp.float32),
        acc, acc)
    return len(exp.mlir_module_serialized) / 1e6


def phase_runall(workdir: str, n_res: int = 71, n_atoms: int = 1231,
                 n_frames: int = 100_000, cases=RUNALL_CASES,
                 bfields=(600.133, 850.13), warm: int = 1) -> dict:
    """run-all on a seeded trajectory, then fit-ct and relax on the host
    CPU backend from the card's own artefacts."""
    from spinrelax_tpu.io import fittedct as fctio
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.ops import autocorr
    from spinrelax_tpu.pipeline import cli, stages
    from spinrelax_tpu.utils.synthetic import build_trajectory

    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    ref, xtc, info = build_trajectory(workdir, n_res, n_atoms - 3 * n_res,
                                      n_frames, d_iso=D_TRUE, seed=SEED)
    setup_s = time.perf_counter() - t0
    checks, runs = [], {}
    for t_mem, extra in cases:
        tag = f"tmem{int(t_mem)}"
        run_dir = os.path.join(workdir, tag)
        os.makedirs(run_dir, exist_ok=True)
        outpref = f"rotdif-{t_mem / 1000.0:g}ns"
        argv = ["run-all", "-sxtc", xtc, "-refpdb", ref,
                "-t_mem", repr(t_mem), "-D_ext", repr(D_TRUE), "1.0",
                "-Bfields", *map(repr, bfields), *extra, "-bForce"]
        with contextlib.chdir(run_dir):
            with _CompileLog() as log:
                t0 = time.perf_counter()
                rc = cli.main(argv)
                cold = time.perf_counter() - t0
            warm_s = []
            for _ in range(warm):
                t0 = time.perf_counter()
                cli.main(argv)
                warm_s.append(time.perf_counter() - t0)
            missing = [f for f in _runall_artefacts(outpref, bfields)
                       if not _artefact_ok(f)]
            checks.append(_check(f"{tag}_artefacts_missing_or_nonfinite",
                                 len(missing), 0))
            fpc = int(round(t_mem))
            dft = autocorr._dft_constants(fpc, fpc // 2, "float32")
            const_mb = sum(a.nbytes for a in dft if hasattr(a, "nbytes")) / 1e6
            runs[tag] = {
                "rc": rc, "cold_s": cold,
                "warm_s": statistics.median(warm_s) if warm_s else None,
                "compiles": log.summary(),
                "fused_group_step_compile_s": sum(
                    s for n, s in log.events if "_fused_update" in n),
                "dft_constant_MB_per_acf": const_mb,
                "acf_step_stablehlo_MB": _acf_step_module_mb(fpc, n_res),
                "missing": missing,
            }
            # Host CPU backend, from the card's artefacts.
            gpu_fit = fctio.read_fittedct(outpref + "_fittedCt.dat")
            with _on_cpu():
                cpu_fit = stages.stage_fit_ct([outpref + "_Ctint.dat"],
                                              "cpu")
                k_gpu = np.asarray(gpu_fit.mask).sum(1)
                k_cpu = np.asarray(cpu_fit.mask).sum(1)
                same = k_gpu == k_cpu
                checks.append(_check(f"{tag}_fitct_sameK_frac_deficit",
                                     1.0 - same.mean(), 0.05))
                checks.append(_check(
                    f"{tag}_fitct_S2_sameK_abs",
                    _max_abs(np.asarray(gpu_fit.S2)[same],
                             np.asarray(cpu_fit.S2)[same]) if same.any()
                    else 0.0, 1e-3))
                for bf in bfields:
                    of = f"{outpref}-{int(bf)}"
                    rates = stages.stage_relax(
                        outpref + "_fittedCt.dat", "cpu-" + str(int(bf)),
                        Diffusion.axisymmetric(diso=D_TRUE, aniso=1.0),
                        vec_file=outpref + "_vecHistogram.npz",
                        freq_mhz=bf)
                    for r in ("R1", "R2", "NOE"):
                        card = _numbers(f"{of}_{r}.dat").reshape(n_res, -1)
                        cpu = np.asarray(getattr(rates, r))
                        # the card's value is read back from its %g
                        # artefact (6 significant digits)
                        checks.append(_check(f"{tag}_{int(bf)}_{r}_rel",
                                             _max_rel(card[:, 1], cpu), 2e-5))
    return _record(
        "P1_runall", {"n_res": n_res, "n_atoms": n_atoms,
                      "n_frames": n_frames, "t_mem": [c[0] for c in cases],
                      "bfields": list(bfields)},
        setup_s, {k: v["warm_s"] for k, v in runs.items()}, checks,
        runs=runs, xtc_MB=info["file_bytes"] / 1e6)


# ---------------------------------------------------------------------------
# P2 C(t) group step, both XLA forms
# ---------------------------------------------------------------------------

CT_SHAPES = ((32, 1000, 1024), (8, 3000, 1024))
# A rerun under default_matmul_precision("float32") may differ from the
# first run by reduction-order noise (~1e-7); a dot computed in TF32
# (10-bit mantissa) shows as ~1e-3.  Exact zero means fully pinned.
TF32_AUDIT_TOL = 2e-6


def _group_step(acf):
    """The streamed Palmer group step (autocorr._stream_update_jit's
    body) over a given ACF form."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(v, acc_s, acc_s2):
        n_frames = v.shape[1]
        n_deltas = n_frames // 2
        n_vals = n_frames - jnp.arange(1, n_deltas + 1, dtype=v.dtype)
        s = acf(jnp.swapaxes(v, 1, 2), n_deltas)
        e = -1.5 + 1.5 * s / n_vals
        return acc_s + jnp.sum(e, axis=0), acc_s2 + jnp.sum(e ** 2, axis=0)

    return step


def phase_ct(shapes=CT_SHAPES, n_check: int = 128, reps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    from spinrelax_tpu.ops import autocorr

    forms = {"xla": autocorr._acf_sums_xla, "fft": autocorr._acf_sums_fft}
    checks, times = [], {}
    compile_s, run_s = {}, {}
    for g, n_frames, n_bonds in shapes:
        n_deltas = n_frames // 2
        v = _bond_vectors(jax.random.PRNGKey(SEED), g, n_frames, n_bonds)
        ref = _acf_sums_host(
            np.swapaxes(np.asarray(v[:, :, :n_check]), 1, 2), n_deltas)
        n_vals = n_frames - np.arange(1, n_deltas + 1)
        ref_ct = np.mean(-0.5 + 1.5 * ref / n_vals, axis=0)  # (n, D)
        zeros = jnp.zeros((n_bonds, n_deltas), jnp.float32)
        for name, acf in forms.items():
            tag = f"{name}_{g}x{n_frames}x{n_bonds}"
            step = _group_step(acf)
            (acc_s, _), c_s, r_s = _timed(lambda: step(v, zeros, zeros), reps)
            compile_s[tag], run_s[tag] = c_s, r_s
            ct = 1.0 + np.asarray(acc_s[:n_check]) / g
            checks.append(_check(f"{tag}_Ct_abs_vs_f64", _max_abs(ct, ref_ct),
                                 2e-6))
            with jax.default_matmul_precision("float32"):
                acc_f32, _ = jax.block_until_ready(
                    _group_step(acf)(v, zeros, zeros))
            checks.append(_check(f"{tag}_tf32_audit_abs",
                                 _max_abs(1.0 + np.asarray(acc_f32[:n_check]) / g,
                                          ct), TF32_AUDIT_TOL))
            times[tag] = {"frames_x_vectors_per_s": g * n_frames * n_bonds
                          / r_s}
        del v
    return _record("P2_ct", [list(s) for s in shapes], compile_s, run_s,
                   checks, rates=times)


# ---------------------------------------------------------------------------
# P3 DoF ladder
# ---------------------------------------------------------------------------

LADDER_SPECS = ((1, False), (1, True), (2, True), (3, True), (4, True))


def ladder_cohort(n_res: int, n_lags: int, seed: int = SEED):
    """First half: adjacent-timescale 3-component hard mixes
    (S2 + sum C = 1, sigma 5e-4); second half: clean two-exponential
    decays with a free S2 (sigma 1e-4).  Returns f32 (dt, y, sigma)."""
    rng = np.random.default_rng(seed)
    dt = np.arange(1, n_lags + 1) * 2.0
    n_hard = n_res // 2
    n_clean = n_res - n_hard
    S2 = rng.uniform(0.4, 0.9, n_hard)
    C = rng.uniform(0.02, 0.2, (n_hard, 3))
    tau = np.stack([rng.uniform(1.5, 12, n_hard),
                    rng.uniform(12, 120, n_hard),
                    rng.uniform(120, 1500, n_hard)], 1)
    C = C * ((1.0 - S2) / C.sum(1))[:, None]
    hard = S2[:, None] + (C[:, :, None] * np.exp(
        -dt[None, None, :] / tau[:, :, None])).sum(1)
    hard += rng.normal(scale=5e-4, size=hard.shape)
    S2c = rng.uniform(0.6, 0.9, n_clean)
    Cc = rng.uniform(0.02, 0.1, (n_clean, 2))
    tauc = np.stack([rng.uniform(5, 30, n_clean),
                     rng.uniform(100, 400, n_clean)], 1)
    clean = S2c[:, None] + (Cc[:, :, None] * np.exp(
        -dt[None, None, :] / tauc[:, :, None])).sum(1)
    clean += rng.normal(scale=1e-4, size=clean.shape)
    y = np.concatenate([hard, clean]).astype(np.float32)
    sg = np.concatenate([np.full(hard.shape, 5e-4),
                         np.full(clean.shape, 1e-4)]).astype(np.float32)
    return dt.astype(np.float32), y, sg


def phase_ladder(n_res: int = 10_000, n_lags: int = 500, n_cmp: int = 512,
                 reps: int = 3) -> dict:
    from spinrelax_tpu.fit.walk import fit_ct_walk, unpack_walk

    dt, y, sg = ladder_cohort(n_res, n_lags)
    kmax = max(k for k, _ in LADDER_SPECS)
    R = len(LADDER_SPECS)

    def walk(yy, ss):
        return fit_ct_walk(dt, yy, ss, np.float32(0.5), LADDER_SPECS, kmax)

    packed, c_s, r_s = _timed(lambda: walk(y, sg), reps)
    card = unpack_walk(np.asarray(packed), kmax, R)
    half = n_res // 2
    idx = np.concatenate([np.arange(n_cmp // 2),
                          half + np.arange(n_cmp - n_cmp // 2)])
    with _on_cpu():
        cpu = unpack_walk(np.asarray(walk(y[idx], sg[idx])), kmax, R)
    k_card = card["mask"][idx].sum(1)
    k_cpu = cpu["mask"].sum(1)
    same = k_card == k_cpu
    hard = idx < half
    checks = [
        _check("sameK_frac_deficit", 1.0 - same.mean(), 0.01),
        _check("S2_sameK_abs", _max_abs(card["S2"][idx][same],
                                        cpu["S2"][same]), 1e-3),
    ]
    return _record(
        "P3_ladder", {"n_res": n_res, "n_lags": n_lags, "n_cmp": n_cmp,
                      "specs": [list(s) for s in LADDER_SPECS]},
        c_s, r_s, checks,
        observed={"sameK_hard": float(same[hard].mean()),
                  "sameK_clean": float(same[~hard].mean()),
                  "K_hist_card": np.bincount(
                      card["mask"].sum(1).astype(int),
                      minlength=kmax + 1).tolist()},
        residues_per_s=n_res / r_s)


# ---------------------------------------------------------------------------
# P4 J(omega) + rates, multi-field fit
# ---------------------------------------------------------------------------


def multifield_problem(n_res: int, n_samp: int, seed: int = SEED,
                       diso: float = 4e-5, aniso: float = 1.5):
    """(pair list, cts, vecs, weights, ExperimentData list) of six
    experiments (R1/R2/NOE at 600 and 850 MHz) predicted from a known
    axisymmetric tensor."""
    from spinrelax_tpu.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu.io.experiments import ExperimentData
    from spinrelax_tpu.models import CtModelSet, Diffusion
    from spinrelax_tpu.ops import observables as obs

    rng = np.random.default_rng(seed)
    names = [str(i + 2) for i in range(n_res)]
    cts = CtModelSet.from_lists(
        names, rng.uniform(0.6, 0.9, n_res),
        list(rng.uniform(0.02, 0.1, (n_res, 2))),
        list(np.stack([rng.uniform(5, 30, n_res),
                       rng.uniform(100, 800, n_res)], -1)),
        s2fast=[True] * n_res, zeta=0.89, sort=False)
    v = rng.normal(size=(n_res, n_samp, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    w = rng.uniform(0.0, 3.0, (n_res, n_samp)).astype(np.float32)
    diff = Diffusion.axisymmetric(diso=diso, aniso=aniso)
    pairs = [NucleusPair(B0=field_from_mhz(f), time_unit="ps")
             for f in (600.133, 850.13)]
    expts = []
    for f, pair in zip((600.133, 850.13), pairs):
        rates = obs.predict_rates_newapi(pair, diff, cts, vecs=v, weights=w)
        for t in ("R1", "R2", "NOE"):
            expts.append(ExperimentData(
                expt_type=t, nuclei_a="15N", nuclei_b="1H", frequency=f,
                freq_unit="MHz", names=np.array(names),
                values=np.asarray(getattr(rates, t)).copy(),
                errors=np.maximum(np.asarray(getattr(rates, "d" + t)),
                                  1e-3)))
    return pairs, cts, v, w, expts


def phase_rates(n_res: int = 200, n_samp: int = 2592, reps: int = 3) -> dict:
    import jax

    from spinrelax_tpu.fit.globalfit import GlobalFitter
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.models.experiments import ExperimentSet
    from spinrelax_tpu.ops import observables as obs

    diso, aniso = 4e-5, 1.5
    pairs, cts, v, w, expts = multifield_problem(n_res, n_samp, diso=diso,
                                                 aniso=aniso)
    diff = Diffusion.axisymmetric(diso=diso, aniso=aniso)

    def rates_fn(pair):
        return jax.jit(lambda vv, ww: tuple(
            getattr(obs.predict_rates_newapi(pair, diff, cts, vecs=vv,
                                             weights=ww), r)
            for r in ("R1", "R2", "NOE")))

    checks, compile_s, run_s = [], {}, {}
    for pair in pairs:
        tag = f"{pair.B0 * 267.513 / (2 * np.pi):.0f}MHz"
        fn = rates_fn(pair)
        card, compile_s[tag], run_s[tag] = _timed(lambda: fn(v, w), reps)
        with _on_cpu():
            cpu = jax.block_until_ready(rates_fn(pair)(v, w))
        with jax.default_matmul_precision("float32"):
            f32 = jax.block_until_ready(rates_fn(pair)(v, w))
        for r, a, b, c in zip(("R1", "R2", "NOE"), card, cpu, f32):
            checks.append(_check(f"{tag}_{r}_rel_vs_cpu", _max_rel(a, b),
                                 1e-5))
            checks.append(_check(f"{tag}_{r}_tf32_audit_rel",
                                 _max_rel(c, a), TF32_AUDIT_TOL))

    es = ExperimentSet.build(
        expts, cts, Diffusion.axisymmetric(diso=1.2 * diso, aniso=1.2),
        vecs=v, weights=w)
    fitter = GlobalFitter(es, ["Diso", "Daniso"])
    start = copy.deepcopy(fitter.state)

    def fit():
        fitter.state = copy.deepcopy(start)
        return fitter.run(method="device").diso

    got, compile_s["fit"], run_s["fit"] = _timed(fit, reps)
    checks.append(_check("fit_Diso_rel_vs_truth", abs(got / diso - 1.0),
                         0.01))
    return _record("P4_rates", {"n_res": n_res, "n_samp": n_samp,
                                "n_expt": len(expts)},
                   compile_s, run_s, checks)


# ---------------------------------------------------------------------------
# P5 dq
# ---------------------------------------------------------------------------


def phase_dq(workdir: str, n_frames: int = 1_000_000, tau: float = 2000.0,
             reps: int = 3) -> dict:
    import jax

    from spinrelax_tpu.pipeline.stages import stage_dq
    from spinrelax_tpu.utils.synthetic import simulate_quats, write_colvar_file

    q = simulate_quats(n_frames, [1.0 / (6.0 * tau)] * 3, 1.0, seed=SEED)
    colvar = os.path.join(workdir, "colvar-dq")
    write_colvar_file(colvar, q, 1.0)
    grid = (tau / 100.0, tau, tau / 100.0)

    def run(pref):
        return stage_dq(colvar, os.path.join(workdir, pref), *grid,
                        n_chunks=4)

    card, c_s, r_s = _timed(lambda: run("card"), reps)
    with _on_cpu():
        cpu = run("cpu")
        with jax.enable_x64(True):
            f64 = run("f64")
    with jax.default_matmul_precision("float32"):
        f32 = run("f32")
    checks = [
        _check("D_axes_rel_vs_cpu", _max_rel(card.D_axes, cpu.D_axes), 1e-5),
        _check("D_iso_rel_vs_cpu", _max_rel(card.D_iso, cpu.D_iso), 1e-5),
        _check("D_axes_rel_vs_cpu_f64", _max_rel(card.D_axes, f64.D_axes),
               1e-5),
        _check("D_axes_tf32_audit_rel", _max_rel(f32.D_axes, card.D_axes),
               TF32_AUDIT_TOL),
    ]
    return _record("P5_dq", {"n_frames": n_frames,
                             "n_lags": int(len(card.lag_times))},
                   c_s, r_s, checks, D_axes=np.asarray(card.D_axes).tolist())


# ---------------------------------------------------------------------------
# --four: the mesh path, four cards against one
# ---------------------------------------------------------------------------


def phase_four(n_bonds: int = 10_000, n_frames: int = 1000, g: int = 32,
               n_groups: int = 2, n_res_fit: int = 200,
               n_samp: int = 2592) -> dict:
    """ShardedCtStream over a (2, 2) mesh, run_sharded_finish, and the
    residue-sharded multi-field fit, each against the same seeded inputs
    on one card in the same process.  Times are walls of single passes,
    compilation included."""
    import jax

    from jax.sharding import NamedSharding, PartitionSpec as P

    from spinrelax_tpu.constants import NucleusPair, field_from_mhz
    from spinrelax_tpu.fit.globalfit import GlobalFitter
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.models.experiments import ExperimentSet
    from spinrelax_tpu.ops import observables as obs
    from spinrelax_tpu.ops.autocorr import palmer_pooled_stats
    from spinrelax_tpu.parallel.fit import shard_experiment_set
    from spinrelax_tpu.parallel.mesh import make_mesh
    from spinrelax_tpu.parallel.streamed import (
        ShardedCtStream, run_sharded_finish)

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devs)}")
    meshes = {"four": make_mesh(4), "one": make_mesh(1)}
    keys = jax.random.split(jax.random.PRNGKey(SEED), n_groups)
    diff = Diffusion.isotropic(diso=D_TRUE)
    acc, wall_s = {}, {}
    for tag, mesh in meshes.items():
        stream = ShardedCtStream(mesh, n_frames, n_bonds)
        # one card takes each group in quarters: the accumulation is a
        # plain sum over chunks, so the statistics are the same
        parts = 1 if tag == "four" else 4
        t0 = time.perf_counter()
        for k in keys:
            grp = _bond_vectors(k, g, n_frames, n_bonds)
            for p in range(parts):
                stream.update(grp[p * g // parts:(p + 1) * g // parts])
            del grp
        acc[tag] = jax.block_until_ready(stream.accumulators())
        wall_s[f"{tag}_stream"] = time.perf_counter() - t0
    ct = {}
    for tag in meshes:
        mean, _ = palmer_pooled_stats(*acc[tag])
        ct[tag] = np.asarray(mean)[:n_bonds]
    checks, worst = [], {}
    checks.append(_check("Ct_abs_four_vs_one", _max_abs(ct["four"],
                                                        ct["one"]), 1e-5))
    # The finish on both layouts starts from the SAME pooled sums (the
    # one-card stream's): multi-exponential fits amplify the last-bit
    # differences of two C(t) streams far beyond 1e-5.
    res_sh = NamedSharding(meshes["four"], P("res", None))
    acc_four = (jax.device_put(acc["one"][0], res_sh),
                jax.device_put(acc["one"][1], res_sh),
                jax.device_put(acc["one"][2],
                               NamedSharding(meshes["four"], P())))
    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    fin = {}
    for tag, a_ in (("four", acc_four), ("one", acc["one"])):
        t0 = time.perf_counter()
        fin[tag] = run_sharded_finish(meshes[tag], *a_, n_res=n_bonds,
                                      delta_t=1.0, diffusion=diff, pair=pair)
        wall_s[f"{tag}_finish"] = time.perf_counter() - t0
    a, b = fin["four"], fin["one"]
    # The ladder's f32 LM runs on differently sized per-device batches, so
    # its fits part at the LM's convergence tolerance, not at rounding
    # level (as card vs CPU in P3): they are held to P3's criteria.  The
    # sharded rates are checked on the four-card finish's own models.
    same = np.asarray(a.cts.mask).sum(1) == np.asarray(b.cts.mask).sum(1)
    checks.append(_check("finish_sameK_frac_deficit", 1.0 - same.mean(),
                         0.01))
    checks.append(_check("finish_S2_sameK_abs",
                         _max_abs(np.asarray(a.cts.S2)[same],
                                  np.asarray(b.cts.S2)[same]), 1e-3))
    one_card = jax.block_until_ready(jax.jit(
        lambda d, c: obs.predict_rates(pair, d, c))(diff, a.cts))
    for r in ("R1", "R2", "NOE"):
        rel = _rel_lanes(getattr(a, r), np.asarray(getattr(one_card, r)))
        checks.append(_check(f"{r}_rel_four_vs_one_same_models",
                             float(np.max(rel)), 1e-5))
    for name, x4, x1 in [("S2", a.cts.S2, b.cts.S2)] + [
            (r, getattr(a, r), getattr(b, r)) for r in ("R1", "R2", "NOE")]:
        rel = _rel_lanes(np.asarray(x4)[same], np.asarray(x1)[same])
        worst[name] = float(np.max(rel)) if rel.size else 0.0

    pairs, cts, v, w, expts = multifield_problem(n_res_fit, n_samp)
    fits = {}
    for tag, mesh in meshes.items():
        es = ExperimentSet.build(
            expts, cts, Diffusion.axisymmetric(diso=4.8e-5, aniso=1.2),
            vecs=v, weights=w)
        if tag == "four":
            es = shard_experiment_set(es, mesh)
        t0 = time.perf_counter()
        st = GlobalFitter(es, ["Diso", "Daniso"]).run(method="device")
        wall_s[f"{tag}_fit"] = time.perf_counter() - t0
        fits[tag] = (st.diso, st.aniso, st.chisq)
    for i, name in enumerate(("Diso", "Daniso", "chisq")):
        checks.append(_check(f"fit_{name}_rel_four_vs_one",
                             _max_rel(fits["four"][i], fits["one"][i]), 1e-5))
    return _record(
        "four_mesh", {"n_bonds": n_bonds, "n_frames": n_frames, "g": g,
                      "n_groups": n_groups, "mesh": dict(
                          meshes["four"].shape), "n_res_fit": n_res_fit},
        None, None, checks, wall_s=wall_s,
        observed_rel_sameK_four_vs_one=worst,
        peak_bytes_per_device=[_peak_bytes(d) for d in devs[:4]])


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def ok_line(platform: str, kind: str, count: int) -> str:
    """The last line of a run in which every phase passed."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def _emit(rec: dict) -> None:
    print(json.dumps(rec, default=float), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        print(f"unknown arguments: {unknown}", file=sys.stderr)
        return 2
    import jax

    from spinrelax_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); "
              "this script measures the card and has no CPU fallback",
              file=sys.stderr)
        return 1
    compile_cache.enable_default()

    p0 = phase_device()
    print(p0["nvidia_smi"], flush=True)
    _emit(p0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if four:
            phases = [lambda: phase_four()]
        else:
            phases = [lambda: phase_runall(os.path.join(work, "runall")),
                      phase_ct, phase_ladder, phase_rates,
                      lambda: phase_dq(work)]
        ok = True
        for run in phases:
            t0 = time.perf_counter()
            rec = run()
            rec["phase_s"] = time.perf_counter() - t0
            _emit(rec)
            ok &= rec["ok"]
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(ok_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
