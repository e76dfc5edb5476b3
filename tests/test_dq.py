"""Delta-q rotational diffusion: numpy transliteration parity + synthetic
D-tensor recovery + full-script parity against the reference
calculate-dq-distribution.py (run via subprocess with dependency shims)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from spinrelax_tpu.core import quaternion as qt
from spinrelax_tpu.ops import dq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
SHIM = os.path.join(REPO, "tools", "refshim")


def np_qmult(a, b):
    w1, x1, y1, z1 = np.moveaxis(a, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        axis=-1,
    )


def simulate_diffusion_quats(rng, n_frames, D_body, dt):
    """Rotational Brownian motion with body-frame diffusion tensor
    diag(D_body): per-step rotation angles ~ N(0, 2 D_i dt)."""
    sig = np.sqrt(2.0 * np.asarray(D_body) * dt)
    q = np.zeros((n_frames, 4))
    q[0] = [1.0, 0, 0, 0]
    for t in range(1, n_frames):
        w = rng.normal(scale=sig)
        th = np.linalg.norm(w)
        ax = w / th if th > 0 else np.array([1.0, 0, 0])
        dqq = np.concatenate([[np.cos(th / 2)], ax * np.sin(th / 2)])
        q[t] = np_qmult(q[t - 1], dqq)
        q[t] /= np.linalg.norm(q[t])
    return q


def np_dq_stats(q, lags):
    """Literal transliteration of obtain_self_dq + averages
    (calculate-dq-distribution.py:102-126)."""
    isos, Ms = [], []
    for delta in lags:
        a = q[:-delta] * np.array([1.0, -1, -1, -1])
        dqs = np_qmult(a, q[delta:])
        sgn = np.where(dqs[:, 0] >= 0, 1.0, -1.0)
        v = dqs[:, 1:] * sgn[:, None]
        isos.append(np.mean(1.0 - 2.0 * np.sum(v**2, axis=-1)))
        Ms.append(np.einsum("ij,ik->jk", v, v) / len(v))
    return np.array(isos), np.array(Ms)


@pytest.fixture(scope="module")
def qtraj():
    rng = np.random.default_rng(7)
    # Axisymmetric-ish tensor in ps^-1 (tau ~ few hundred ps).
    D_body = np.array([8e-4, 8e-4, 2.4e-3])
    return simulate_diffusion_quats(rng, 24000, D_body, dt=1.0), D_body


def test_dq_statistics_matches_numpy(qtraj):
    q, _ = qtraj
    lags = np.array([1, 5, 10, 20], dtype=np.int32)
    stats = dq.dq_statistics(jnp.asarray(q), jnp.asarray(lags))
    want_iso, want_M = np_dq_stats(q, lags)
    np.testing.assert_allclose(np.asarray(stats.iso), want_iso, atol=1e-10)
    np.testing.assert_allclose(np.asarray(stats.M), want_M, atol=1e-10)


@pytest.mark.parametrize(
    "n_frames,lag_list,n_chunks",
    [
        (24000, [3, 7], 4),
        # Long lags where ndat shrinks far below n, uneven division:
        (24000, [11000, 23900, 23993], 4),
        (24000, [23950], 7),
        # Tiny trajectory, lag leaves ndat barely above n_chunks:
        (64, [30, 55, 59], 5),
    ],
)
def test_chunked_statistics_match_reference_chunking(
    qtraj, n_frames, lag_list, n_chunks
):
    """The masked idx//nblock chunking must reproduce the reference's
    ceil(ndat/nchunk) blocking (calculate-dq-distribution.py:128-144)
    EXACTLY at every lag, including long lags where ndat is small and
    divides unevenly — both the iso decays and the anisotropy tensors."""
    q, _ = qtraj
    q = q[:n_frames]
    lags = np.array(lag_list, dtype=np.int32)
    stats = dq.dq_statistics(jnp.asarray(q), jnp.asarray(lags), n_chunks=n_chunks)
    for li, delta in enumerate(lags):
        a = q[:-delta] * np.array([1.0, -1, -1, -1])
        dqs = np_qmult(a, q[delta:])
        sgn = np.where(dqs[:, 0] >= 0, 1.0, -1.0)
        v = dqs[:, 1:] * sgn[:, None]
        ndat = len(v)
        nblock = int(np.ceil(ndat / n_chunks))
        for c in range(n_chunks):
            seg = v[nblock * c : min(ndat, nblock * (c + 1))]
            assert len(seg) > 0, "test config produced an empty chunk"
            want_iso = np.mean(1.0 - 2.0 * np.sum(seg**2, axis=-1))
            want_M = np.einsum("ij,ik->jk", seg, seg) / len(seg)
            np.testing.assert_allclose(
                float(stats.iso_chunks[li, c]), want_iso, atol=1e-10
            )
            np.testing.assert_allclose(
                np.asarray(stats.M_chunks[li, c]), want_M, atol=1e-10
            )


def test_exp_fit_recovers_tau():
    x = np.arange(1.0, 200.0, 2.0)
    tau_true = 77.0
    y = 1.5 * np.exp(-x / tau_true) - 0.5
    tau = float(np.asarray(dq.fit_exp_decay(jnp.asarray(x), jnp.asarray(y), 1.5, -0.5)))
    np.testing.assert_allclose(tau, tau_true, rtol=1e-6)
    # batched, other form
    y2 = 0.5 * np.exp(-x[None, :] / np.array([[30.0], [120.0]])) + 0.5
    taus = np.asarray(dq.fit_exp_decay(jnp.asarray(x), jnp.asarray(y2), 0.5, 0.5))
    np.testing.assert_allclose(taus, [30.0, 120.0], rtol=1e-6)


def test_synthetic_D_recovery(qtraj):
    q, D_body = qtraj
    res = dq.analyse_dq(q, delta_t=1.0, min_dt=5.0, max_dt=500.0, skip_dt=5.0, n_chunks=4)
    D_sorted = np.sort(res.D_axes) * 1e-12  # s^-1 -> ps^-1
    # The delta-q vector component i measures rotation about body axis i:
    # Var(theta_i) = 2 D_i t, so each axis decay recovers D_i itself.
    want = np.sort(D_body)
    np.testing.assert_allclose(D_sorted, want, rtol=0.25)
    # The degenerate pair should average to D_perp reasonably well.
    np.testing.assert_allclose(np.mean(D_sorted[:2]), D_body[0], rtol=0.15)
    # The unique axis recovered at the first lag must align with lab z
    # (the x/y plane is degenerate so the in-plane axes are arbitrary).
    assert abs(res.axes_per_lag[0, 2, 2]) > 0.99


@pytest.mark.slow
def test_full_script_parity_vs_reference(tmp_path, qtraj):
    """Write a synthetic colvar, run the reference script end-to-end, and
    compare its fitted taus/PAF against analyse_dq."""
    q, _ = qtraj
    n = q.shape[0]
    colvar = tmp_path / "colvar-qorient"
    with open(colvar, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(n):
            fp.write(
                " %f %f %f %f %f\n" % (t * 1.0, q[t, 0], q[t, 1], q[t, 2], q[t, 3])
            )

    env = dict(os.environ)
    env["PYTHONPATH"] = SHIM + ":" + REF
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable,
            os.path.join(REF, "calculate-dq-distribution.py"),
            "--iso",
            "--aniso",
            "-f",
            str(colvar),
            "-o",
            str(tmp_path / "ref"),
            "--mindt",
            "5",
            "--skip",
            "5",
            "--maxdt",
            "500",
        ],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]

    # Parse reference outputs.
    ref_iso = {}
    with open(tmp_path / "ref-iso.dat") as fp:
        for line in fp:
            if line.startswith("# model fit"):
                ref_tau_iso = float(line.split("=")[1].split("[")[0])
    ref_taus = []
    with open(tmp_path / "ref-aniso2.dat") as fp:
        for line in fp:
            if "tau =" in line:
                ref_taus.append(float(line.split("=")[1].split("[")[0]))
            if line.startswith("# Quaternion"):
                ref_q = np.array([float(x) for x in line.split(":")[1].split()])

    res = dq.analyse_dq(q, delta_t=1.0, min_dt=5.0, max_dt=500.0, skip_dt=5.0)
    if 0 < ref_tau_iso < 1e6:
        # The reference's unbounded scalar Powell occasionally diverges on
        # the iso fit (observed: tau=-2.9e15 on clean synthetic data);
        # only compare when it returned something physical.
        np.testing.assert_allclose(res.iso_tau, ref_tau_iso, rtol=1e-3)
    else:
        assert 0 < res.iso_tau < 1e6  # ours must stay physical regardless
    np.testing.assert_allclose(res.aniso_taus, ref_taus, rtol=1e-3)
    # Same PAF quaternion up to sign.
    dot = abs(float(np.dot(res.q_frame, ref_q)))
    assert dot > 0.9999, (res.q_frame, ref_q)


def test_multi_replica_pooling_matches_concatenated_samples(qtraj, rng):
    """analyse_dq_multi must equal lag statistics over the POOLED delta-q
    samples of all replicas (the reference's concatenation semantics),
    including ragged replica lengths."""
    q, _ = qtraj
    reps = [q[:5000], q[5000:13000], q[13000:]]  # unequal lengths
    lags = np.array([5, 10, 15, 20], dtype=np.int32)
    res = dq.analyse_dq_multi(reps, 1.0, 5.0, 20.0, 5.0)

    for li, delta in enumerate(lags):
        vs = []
        for r in reps:
            a = r[:-delta] * np.array([1.0, -1, -1, -1])
            dqs = np_qmult(a, r[delta:])
            sgn = np.where(dqs[:, 0] >= 0, 1.0, -1.0)
            vs.append(dqs[:, 1:] * sgn[:, None])
        v = np.concatenate(vs)
        want_iso = np.mean(1.0 - 2.0 * np.sum(v**2, axis=-1))
        np.testing.assert_allclose(res.iso[li], want_iso, atol=1e-10)


def test_streamed_analysis_matches_in_memory(tmp_path, qtraj):
    """--stream path: identical DqResult to the in-memory path, from an
    actual colvar file read in small blocks."""
    from spinrelax_tpu.pipeline.stages import stage_dq

    q, _ = qtraj
    q = q[:6000]
    fn = str(tmp_path / "colvar-qorient")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(q.shape[0]):
            fp.write(" %.10f %.10f %.10f %.10f %.10f\n" % (t * 1.0, *q[t]))

    res_mem = stage_dq(fn, str(tmp_path / "mem"), 5.0, 200.0, 5.0)
    res_str = stage_dq(fn, str(tmp_path / "str"), 5.0, 200.0, 5.0,
                       stream_chunk=700)
    np.testing.assert_allclose(res_str.iso, res_mem.iso, atol=1e-8)
    np.testing.assert_allclose(res_str.aniso_taus, res_mem.aniso_taus, rtol=1e-6)
    np.testing.assert_allclose(res_str.D_axes, res_mem.D_axes, rtol=1e-6)
    assert abs(float(np.dot(res_str.q_frame, res_mem.q_frame))) > 1 - 1e-9


def test_streamed_chunked_errors_hist_tensor_match_in_memory(tmp_path, qtraj):
    """--stream with n_chunks / -hist / --fulltensor (VERDICT r2 #7): the
    streamed sub-chunk error bars equal the in-memory blocking
    (calculate-dq-distribution.py:128-144,613-630), the per-lag histogram
    files are byte-identical (bitwise-equal dq vectors -> equal counts),
    and the tensor trace matches."""
    from spinrelax_tpu.pipeline.stages import stage_dq

    q, _ = qtraj
    q = q[:4800]
    fn = str(tmp_path / "colvar-qorient")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(q.shape[0]):
            fp.write(" %.10f %.10f %.10f %.10f %.10f\n" % (t * 1.0, *q[t]))

    kw = dict(n_chunks=4, do_hist=True, hist_bins=21, hist_format="dat",
              do_full_tensor=True)
    res_mem = stage_dq(fn, str(tmp_path / "mem"), 20.0, 200.0, 20.0, **kw)
    res_str = stage_dq(fn, str(tmp_path / "str"), 20.0, 200.0, 20.0,
                       stream_chunk=700, **kw)

    # Sub-chunk statistics and derived error-bar fits.
    np.testing.assert_allclose(
        res_str.iso_chunks, res_mem.iso_chunks, atol=1e-10
    )
    np.testing.assert_allclose(
        res_str.aniso_chunks, res_mem.aniso_chunks, atol=1e-10
    )
    np.testing.assert_allclose(
        res_str.iso_tau_chunks, res_mem.iso_tau_chunks, rtol=1e-6
    )
    np.testing.assert_allclose(
        res_str.aniso_tau_chunks, res_mem.aniso_tau_chunks, rtol=1e-6
    )

    # Histogram + tensor artefacts: byte-identical.
    import glob
    hists = sorted(glob.glob(str(tmp_path / "mem-hist-*.dat")))
    assert len(hists) == len(res_mem.lag_times)
    for fn_m in hists:
        fn_s = fn_m.replace("mem-hist", "str-hist")
        with open(fn_m, "rb") as fa, open(fn_s, "rb") as fb:
            assert fa.read() == fb.read(), fn_m
    # Tensor trace: the PAF-locked off-diagonals are ~1e-18 pure
    # summation noise (the frame diagonalises M at the first lag), so
    # bitwise equality is impossible there — compare numerically.
    with open(str(tmp_path / "mem-tensor.dat")) as fa, \
            open(str(tmp_path / "str-tensor.dat")) as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x == y:
            continue
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            if u != v:
                assert abs(float(u) - float(v)) < 1e-14, (x, y)


def test_rotmat_xvg_input_matches_colvar(tmp_path, qtraj):
    """stage_dq on a gmx-rotmat .xvg (rotation matrices) must equal the
    colvar path fed the INVERSE quaternions
    (calculate-dq-distribution.py:389-407,490-495)."""
    from spinrelax_tpu.core import quaternion as qt_
    from spinrelax_tpu.pipeline.stages import stage_dq

    q, _ = qtraj
    q = q[:4000]
    R = np.asarray(qt_.quat_to_mat(jnp.asarray(q)))  # (N,3,3)
    xvg_fn = str(tmp_path / "rotmat.xvg")
    with open(xvg_fn, "w") as fp:
        fp.write("@ title \"Fit matrix\"\n")
        for t in range(q.shape[0]):
            fp.write(" ".join(["%f" % (t * 1.0)] + ["%.12f" % v for v in R[t].ravel()]) + "\n")
    q_inv = np.asarray(qt_.qconj(jnp.asarray(q)))
    colvar_fn = str(tmp_path / "colvar-qorient")
    with open(colvar_fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(q.shape[0]):
            fp.write(" %f %.12f %.12f %.12f %.12f\n" % (t * 1.0, *q_inv[t]))

    res_x = stage_dq(xvg_fn, str(tmp_path / "xv"), 5.0, 100.0, 5.0)
    res_c = stage_dq(colvar_fn, str(tmp_path / "cv"), 5.0, 100.0, 5.0)
    np.testing.assert_allclose(res_x.iso, res_c.iso, atol=1e-7)
    np.testing.assert_allclose(res_x.aniso_taus, res_c.aniso_taus, rtol=1e-4)


def test_stage_dq_fractional_timestep_tensor_lags(tmp_path, rng):
    """Sub-ps timesteps: the tensor/hist lag reconstruction must round
    (lag_time/delta_t) instead of truncating — 43*0.1/0.1 floats to
    42.999... and astype(int) used to silently shift those rows one
    frame."""
    from spinrelax_tpu.pipeline.stages import stage_dq

    n = 4000
    dt = 0.1
    th = np.cumsum(rng.normal(scale=0.03, size=n))
    q = np.stack([np.cos(th / 2), np.sin(th / 2), np.zeros(n), np.zeros(n)], 1)
    fn = str(tmp_path / "colvar")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(n):
            fp.write(" %g %f %f %f %f\n" % (t * dt, *q[t]))
    res = stage_dq(fn, str(tmp_path / "o"), min_dt=0.5, max_dt=20.0,
                   skip_dt=0.5, do_full_tensor=True)
    rows = np.loadtxt(str(tmp_path / "o-tensor.dat"), comments=["#", "&", "@"])
    lag_frames = np.rint(res.lag_times / dt).astype(int)
    # Independent recomputation at the EXACT integer lags.
    a = q * np.array([1.0, -1, -1, -1])
    for k in (0, len(lag_frames) // 2, len(lag_frames) - 1):
        delta = int(lag_frames[k])
        from spinrelax_tpu.core import quaternion as qt
        import jax.numpy as jnp

        dq_ = np.asarray(qt.qreduce(qt.qmult(jnp.asarray(a[:-delta]),
                                             jnp.asarray(q[delta:]))))
        v = dq_[:, 1:4]
        M = np.einsum("ij,ik->jk", v, v) / len(v)
        R = np.asarray(qt.quat_to_mat(jnp.asarray(res.q_frame)))
        MR = R @ M @ R.T
        np.testing.assert_allclose(rows[k, 1:10], MR.reshape(9), atol=5e-6)


def test_empty_lag_grid_raises_clear_error(qtraj):
    q, _ = qtraj
    with pytest.raises(ValueError, match="lag grid needs >= 2 points"):
        dq.analyse_dq(q[:400], 1.0, min_dt=100.0, max_dt=50.0, skip_dt=5.0)


def test_single_lag_grid_raises_clear_error(qtraj):
    """A 1-point lag grid would silently NaN-poison the exp-decay guess
    (y[1] clamps to y[0] under JAX indexing) — it must error loudly."""
    q, _ = qtraj
    with pytest.raises(ValueError, match="lag grid needs >= 2 points"):
        dq.analyse_dq(q[:400], 1.0, min_dt=50.0, max_dt=50.0, skip_dt=50.0)


@pytest.mark.slow
@pytest.mark.parametrize("trial", range(3))
def test_full_script_parity_randomized(tmp_path, trial):
    """Randomized live-reference sweep over the dq pipeline: fully
    anisotropic / prolate / oblate body tensors, each conjugated into a
    RANDOM principal frame (the fixed-config parity test keeps the PAF on
    the lab axes), random timestep and lag grid.  Differential: both
    codes see the same colvar, so convention choices cancel."""
    rng = np.random.default_rng(8265 + trial)
    D_body, dt, grid = [
        (np.array([6e-4, 1.1e-3, 2.2e-3]), 1.0, (5.0, 5.0, 500.0)),
        (np.array([8e-4, 8.5e-4, 2.0e-3]), 2.0, (10.0, 10.0, 800.0)),
        (np.array([4e-4, 1.8e-3, 1.9e-3]), 1.0, (4.0, 4.0, 400.0)),
    ][trial]
    q = simulate_diffusion_quats(rng, 24000, D_body, dt=dt)
    # Conjugate into a random principal frame: q' = q * r re-labels the
    # body axes, so the diffusion tensor's PAF is r instead of identity.
    r = rng.normal(size=4)
    r /= np.linalg.norm(r)
    q = np.array([np_qmult(qi, r) for qi in q])
    mindt, skip, maxdt = grid

    colvar = tmp_path / "colvar-qorient"
    with open(colvar, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(q.shape[0]):
            fp.write(" %f %f %f %f %f\n"
                     % (t * dt, q[t, 0], q[t, 1], q[t, 2], q[t, 3]))

    env = dict(os.environ)
    env["PYTHONPATH"] = SHIM + ":" + REF
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REF, "calculate-dq-distribution.py"),
         "--iso", "--aniso", "-f", str(colvar), "-o", str(tmp_path / "ref"),
         "--mindt", str(mindt), "--skip", str(skip), "--maxdt", str(maxdt)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]

    ref_tau_iso = None
    with open(tmp_path / "ref-iso.dat") as fp:
        for line in fp:
            if line.startswith("# model fit"):
                ref_tau_iso = float(line.split("=")[1].split("[")[0])
    ref_taus = []
    ref_q = None
    with open(tmp_path / "ref-aniso2.dat") as fp:
        for line in fp:
            if "tau =" in line:
                ref_taus.append(float(line.split("=")[1].split("[")[0]))
            if line.startswith("# Quaternion"):
                ref_q = np.array([float(x) for x in line.split(":")[1].split()])

    res = dq.analyse_dq(q, delta_t=dt, min_dt=mindt, max_dt=maxdt,
                        skip_dt=skip)
    if 0 < ref_tau_iso < 1e6:
        np.testing.assert_allclose(res.iso_tau, ref_tau_iso, rtol=1e-3)
    else:
        assert 0 < res.iso_tau < 1e6
    np.testing.assert_allclose(res.aniso_taus, ref_taus, rtol=1e-3)
    dot = abs(float(np.dot(res.q_frame, ref_q)))
    assert dot > 0.9999, (trial, res.q_frame, ref_q)


def test_packed_finalise_model_fields_match_eager(qtraj):
    """The fused device finalise (one dispatch, one packed fetch) rides
    the fitted model curves and per-chunk anisotropy conversions along
    in DqResult; pin them against independent eager recomputation from
    the fitted taus (the pre-fusion writer semantics,
    calculate-dq-distribution.py:230-272,613-647)."""
    q, _ = qtraj
    res = dq.analyse_dq(q[:6000], delta_t=1.0, min_dt=20.0, max_dt=400.0,
                        skip_dt=20.0, n_chunks=4)
    x = res.lag_times

    # Fitted model curves: row 0 the full series, rows 1.. the chunks.
    taus_iso = np.concatenate([[res.iso_tau], res.iso_tau_chunks])
    np.testing.assert_allclose(
        res.iso_models,
        np.asarray(dq.isotropic_decay(x[None, :], taus_iso[:, None])),
        rtol=1e-12,
    )
    taus_an = np.concatenate([res.aniso_taus[None], res.aniso_tau_chunks])
    np.testing.assert_allclose(
        res.aniso_models,
        np.asarray(dq.anisotropic_decay(x[None, None, :], taus_an[..., None])),
        rtol=1e-12,
    )

    # Per-chunk anisotropy samples use the MAIN fit's axis order.
    order = np.argsort(res.D_axes)
    np.testing.assert_allclose(
        res.anisotropies,
        [float(v) for v in dq.calculate_anisotropies(jnp.asarray(res.D_axes[order]))],
        rtol=1e-12,
    )
    D_ch = np.asarray(dq.tau_to_D(res.aniso_tau_chunks))
    expect = np.stack(
        [np.asarray(v) for v in dq.calculate_anisotropies(jnp.asarray(D_ch[:, order]))],
        axis=-1,
    )
    np.testing.assert_allclose(res.anis_chunk_samples, expect, rtol=1e-12)


def _write_multi_colvar(fn, reps):
    with open(fn, "w") as fp:
        for r in reps:
            fp.write("#! FIELDS time q.w q.x q.y q.z\n")
            for t in range(r.shape[0]):
                fp.write(" %.10f %.10f %.10f %.10f %.10f\n" % (t * 1.0, *r[t]))


def test_streamed_multi_matches_in_memory(tmp_path, qtraj):
    """--multi --stream (VERDICT r3 #2): the constant-memory multi-replica
    aggregate path equals the in-memory --multi results, ragged replica
    lengths and whole-replica sub-chunk errors included.  Chunk size 700
    forces blocks that split replicas mid-stream AND replicas shorter
    than one block."""
    from spinrelax_tpu.pipeline.stages import stage_dq

    q, _ = qtraj
    reps = [q[:5000], q[5000:13000], q[13000:16000]]  # ragged lengths
    fn = str(tmp_path / "colvar-all")
    _write_multi_colvar(fn, reps)

    kw = dict(multi=True, n_chunks=3, do_full_tensor=True)
    res_mem = stage_dq(fn, str(tmp_path / "mem"), 5.0, 200.0, 5.0, **kw)
    res_str = stage_dq(fn, str(tmp_path / "str"), 5.0, 200.0, 5.0,
                       stream_chunk=700, **kw)

    np.testing.assert_allclose(res_str.iso, res_mem.iso, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res_str.M), np.asarray(res_mem.M),
                               atol=1e-10)
    np.testing.assert_allclose(res_str.iso_chunks, res_mem.iso_chunks,
                               atol=1e-10)
    np.testing.assert_allclose(res_str.aniso_chunks, res_mem.aniso_chunks,
                               atol=1e-10)
    np.testing.assert_allclose(res_str.aniso_taus, res_mem.aniso_taus,
                               rtol=1e-6)
    np.testing.assert_allclose(res_str.iso_tau_chunks,
                               res_mem.iso_tau_chunks, rtol=1e-6)
    np.testing.assert_allclose(res_str.aniso_tau_chunks,
                               res_mem.aniso_tau_chunks, rtol=1e-6)
    np.testing.assert_allclose(res_str.D_axes, res_mem.D_axes, rtol=1e-6)
    assert abs(float(np.dot(res_str.q_frame, res_mem.q_frame))) > 1 - 1e-12


def test_streamed_multi_boundaries_exact(qtraj):
    """The streamed multi accumulators must never pair frames across a
    replica boundary: compare against the closed-form pooled statistics
    of independent per-replica dq vectors (same oracle as
    test_multi_replica_pooling)."""
    q, _ = qtraj
    reps = [q[:2000], q[2000:5000], q[5000:5600]]
    lags = np.array([5, 10, 15, 20], dtype=np.int32)

    def chunks():
        for i, r in enumerate(reps):
            for off in range(0, r.shape[0], 333):
                yield i, r[off : off + 333]

    rep_sums, rep_lengths = dq.dq_statistics_streamed_multi(
        chunks(), lags, 333
    )
    assert rep_lengths == [len(r) for r in reps]
    S = np.sum([s for s, _m, _c in rep_sums], axis=0)
    C = np.sum([c for _s, _m, c in rep_sums], axis=0)
    for li, delta in enumerate(lags):
        vs = []
        for r in reps:
            a = r[:-delta] * np.array([1.0, -1, -1, -1])
            dqs = np_qmult(a, r[delta:])
            sgn = np.where(dqs[:, 0] >= 0, 1.0, -1.0)
            vs.append(dqs[:, 1:] * sgn[:, None])
        v = np.concatenate(vs)
        assert C[li] == v.shape[0]
        want = np.mean(1.0 - 2.0 * np.sum(v**2, axis=-1))
        np.testing.assert_allclose(S[li] / C[li], want, atol=1e-10)


def test_streamed_multi_errors(tmp_path, qtraj):
    from spinrelax_tpu.pipeline.stages import stage_dq

    q, _ = qtraj
    fn = str(tmp_path / "colvar-all")
    _write_multi_colvar(fn, [q[:3000], q[3000:6000]])
    # n_chunks must divide the replica count
    with pytest.raises(ValueError, match="must divide nReplicas"):
        stage_dq(fn, str(tmp_path / "o"), 5.0, 100.0, 5.0,
                 multi=True, n_chunks=3, stream_chunk=700)
    # max_dt is checked against the SHORTEST replica
    with pytest.raises(ValueError, match="shortest replica"):
        stage_dq(fn, str(tmp_path / "o"), 5.0, 2000.0, 5.0,
                 multi=True, stream_chunk=700)
    # rotmat .xvg files are single-trajectory
    with pytest.raises(ValueError, match="single-trajectory"):
        stage_dq(str(tmp_path / "rot.xvg"), str(tmp_path / "o"),
                 5.0, 100.0, 5.0, multi=True, stream_chunk=700)


def test_streamed_multi_short_replica_fails_fast(qtraj):
    """An invalid max_dt must error at the FIRST short replica's flush,
    not after the entire (minutes-long on real aggregates) streaming
    pass (ADVICE round 4): the generator below would yield ~1000 more
    chunks if the stream were consumed to the end."""
    q, _ = qtraj
    consumed = []

    def chunks():
        # Replica 0 is too short for max_dt=100 at dt=1 (needs 201
        # frames); replica 1 would stream 1000 further chunks.
        consumed.append((0, 0))
        yield 0, q[:100]
        for i in range(1000):
            consumed.append((1, i))
            yield 1, q[:512]

    with pytest.raises(ValueError, match="shortest replica"):
        dq.analyse_dq_multi_streamed(chunks(), 1.0, 5.0, 100.0, 5.0,
                                     chunk_frames=512)
    # The failure fired at replica 0's boundary flush (triggered by the
    # first replica-1 chunk) -- nothing beyond that was pulled.
    assert len(consumed) <= 2, consumed


@pytest.mark.parametrize("n", [1, 1024, 2500])
def test_frame_sum_matches_einsum(n):
    """Blocked frame-axis contraction == the plain einsum, for frame
    counts below, at and past one block (zero padding is inert)."""
    rng = np.random.default_rng(n)
    v = jnp.asarray(rng.normal(size=(n, 3)))
    w = jnp.asarray(rng.uniform(size=(n, 4)))
    m = jnp.asarray(rng.uniform(size=n))
    for spec, ops in (("ij,ik->jk", (v, v)), ("i,i->", (m, m)),
                      ("ij,ik,ic->cjk", (v, v, w)), ("i,ic->c", (m, w))):
        np.testing.assert_allclose(np.asarray(dq._frame_sum(spec, *ops)),
                                   np.asarray(jnp.einsum(spec, *ops)),
                                   rtol=1e-12, atol=1e-12)


def test_dq_statistics_f32_sums_stay_accurate():
    """float32 statistics over 2*10^5 frames agree with float64 to ~1e-6:
    the per-frame vectors are good to ~1e-9, and the blocked frame sums
    keep a single long f32 sweep's ~1e-4 rounding out of M."""
    from spinrelax_tpu.utils.synthetic import simulate_quats

    q = simulate_quats(200_000, [1e-4, 1.5e-4, 2.5e-4], 1.0, seed=5)
    lags = np.array([10, 100, 1000], np.int32)
    s64 = dq.dq_statistics(jnp.asarray(q, jnp.float64), lags, n_chunks=4)
    s32 = dq.dq_statistics(jnp.asarray(q, jnp.float32), lags, n_chunks=4)
    assert s32.M.dtype == jnp.float32
    for a, b in ((s32.M, s64.M), (s32.M_chunks, s64.M_chunks)):
        a, b = np.asarray(a, np.float64), np.asarray(b)
        scale = np.max(np.abs(b), axis=(-2, -1), keepdims=True)
        assert np.max(np.abs(a - b) / scale) < 2e-6
    np.testing.assert_allclose(np.asarray(s32.iso), np.asarray(s64.iso),
                               rtol=0, atol=1e-6)
