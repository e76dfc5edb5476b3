"""C(t) autocorrelation: FFT path vs a literal numpy transliteration of the
reference's Palmer lag loop (calculate-Ct-from-traj.py:200-238), plus
synthetic-recovery and S^2 tests."""

import numpy as np
import pytest

from spinrelax_tpu.ops import autocorr as ac


def np_ct_palmer(vecs):
    """Literal numpy port of the reference's calculate_Ct_Palmer
    (einsum lag loop, SEM denominator sqrt(n)-1)."""
    sh = vecs.shape
    n_rep, n_deltas = sh[0], sh[1] // 2
    n_res = sh[2]
    Ct = np.zeros((n_deltas, n_res))
    dCt = np.zeros((n_deltas, n_res))
    for delta in range(1, 1 + n_deltas):
        n_vals = sh[1] - delta
        tmp = -0.5 + 1.5 * np.square(
            np.einsum("ijkl,ijkl->ijk", vecs[:, :-delta], vecs[:, delta:])
        )
        tmp = np.einsum("ijk->ik", tmp) / n_vals
        Ct[delta - 1] = np.mean(tmp, axis=0)
        dCt[delta - 1] = np.std(tmp, axis=0) / (np.sqrt(n_rep) - 1.0)
    return Ct, dCt


def random_unit_walk(rng, n_rep, n_frames, n_res, step=0.15):
    """Smooth random walks on the unit sphere (correlated vectors)."""
    v = rng.normal(size=(n_rep, 1, n_res, 3))
    out = [v / np.linalg.norm(v, axis=-1, keepdims=True)]
    for _ in range(n_frames - 1):
        nxt = out[-1] + step * rng.normal(size=(n_rep, 1, n_res, 3))
        nxt /= np.linalg.norm(nxt, axis=-1, keepdims=True)
        out.append(nxt)
    return np.concatenate(out, axis=1)


def test_fft_matches_reference_loop(rng):
    vecs = random_unit_walk(rng, n_rep=3, n_frames=64, n_res=5)
    want_ct, want_dct = np_ct_palmer(vecs)
    got_ct, got_dct = ac.ct_palmer(vecs)
    np.testing.assert_allclose(np.asarray(got_ct), want_ct, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got_dct), want_dct, atol=1e-10)


def test_fft_matches_direct_jax(rng):
    vecs = random_unit_walk(rng, n_rep=2, n_frames=40, n_res=3)
    ct1, dct1 = ac.ct_palmer(vecs)
    ct2, dct2 = ac.ct_palmer_direct(vecs)
    np.testing.assert_allclose(np.asarray(ct1), np.asarray(ct2), atol=1e-10)
    np.testing.assert_allclose(np.asarray(dct1), np.asarray(dct2), atol=1e-10)


def test_scan_variant_matches(rng):
    vecs = random_unit_walk(rng, n_rep=4, n_frames=32, n_res=4)
    ct1, dct1 = ac.ct_palmer(vecs)
    ct2, dct2 = ac.ct_palmer_scan(vecs, batch=2)
    np.testing.assert_allclose(np.asarray(ct1), np.asarray(ct2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(dct1), np.asarray(dct2), atol=1e-9)


def test_group_update_matches_ct_palmer(rng):
    """stream_accumulate's jitted group step (the bench.py / streamed
    stage path) over (g, F, nRes, 3) groups + pooled stats == ct_palmer,
    with groups of unequal size."""
    vecs = random_unit_walk(rng, n_rep=7, n_frames=32, n_res=20)
    groups = [vecs[:3], vecs[3:5], vecs[5:]]
    acc_s, acc_s2, n = ac.stream_accumulate(iter(groups), 32)
    assert n == 7
    mean, dct = ac.palmer_pooled_stats(acc_s, acc_s2, float(n))
    ct1, dct1 = ac.ct_palmer(vecs)
    np.testing.assert_allclose(np.asarray(mean).T, np.asarray(ct1),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(dct).T, np.asarray(dct1),
                               atol=1e-9)


@pytest.mark.parametrize("form", ["xla", "fft"])
@pytest.mark.parametrize("n_frames", [1000, 2000, 3000])
def test_acf_forms_f32_vs_f64_direct(rng, form, n_frames):
    """Both XLA forms of the lag sums, fed f32 DC-heavy bond vectors at
    real chunk lengths, reproduce the f64 lag loop (ct_palmer_direct) to
    2e-6 absolute on C(t) — the accuracy the chip smoke run demands."""
    import jax.numpy as jnp

    acf = {"xla": ac._acf_sums_xla, "fft": ac._acf_sums_fft}[form]
    vecs = random_unit_walk(rng, n_rep=2, n_frames=n_frames, n_res=2,
                            step=0.02)
    n_deltas = n_frames // 2
    v32 = jnp.asarray(np.swapaxes(vecs, 1, 2), jnp.float32)
    s = np.asarray(acf(v32, n_deltas), np.float64)  # (rep, res, D)
    n_vals = n_frames - np.arange(1, n_deltas + 1)
    ct = np.mean(-0.5 + 1.5 * s / n_vals, axis=0).T
    ref, _ = ac.ct_palmer_direct(jnp.asarray(vecs, jnp.float64))
    np.testing.assert_allclose(ct, np.asarray(ref), atol=2e-6, rtol=0)


def test_streamed_f32_error_bars_no_cancellation(rng):
    """Near-rigid vectors (per-chunk C(t) ~ 1, tiny spread): the f32
    STREAMED accumulators must reproduce the f64 two-pass error bars.
    With raw x/x^2 sums the f32 E[x^2]-E[x]^2 subtraction cancels at the
    rounding floor of x^2 (same order as the variance itself — a few
    per cent of dCt on the f32 streamed path); the
    shifted-by-1 palmer_pooled_stats convention keeps the squares
    variance-sized, so this pins a <2% agreement that the unshifted
    convention cannot pass."""
    import jax.numpy as jnp

    v64 = random_unit_walk(rng, n_rep=8, n_frames=64, n_res=4, step=0.02)
    ct64, dct64 = ac.ct_palmer(jnp.asarray(v64))  # f64 two-pass truth
    v32 = jnp.asarray(v64, jnp.float32)
    m32, d32 = ac.ct_palmer_streamed(iter([v32[:4], v32[4:]]), 64)
    np.testing.assert_allclose(np.asarray(m32), np.asarray(ct64), atol=2e-6)
    rel = np.abs(np.asarray(d32) - np.asarray(dct64)) / np.asarray(dct64)
    assert np.nanmax(rel) < 0.02


def test_static_vectors_give_ct_one(rng):
    # A rigid vector has P2 autocorrelation identically 1.
    v = rng.normal(size=(2, 1, 3, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    vecs = np.broadcast_to(v, (2, 30, 3, 3)).copy()
    ct, dct = ac.ct_palmer(vecs)
    np.testing.assert_allclose(np.asarray(ct), 1.0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dct), 0.0, atol=1e-10)


def test_lag_times():
    got = np.asarray(ac.lag_times(2.0, 20.0))
    np.testing.assert_allclose(got, [2.0, 4.0, 6.0, 8.0, 10.0])


def test_reformat_by_tau(rng):
    v1 = rng.normal(size=(25, 4, 3))
    v2 = rng.normal(size=(17, 4, 3))
    out = ac.reformat_by_tau([v1, v2], delta_t=1.0, tau_memory=10.0)
    assert out.shape == (3, 10, 4, 3)
    np.testing.assert_array_equal(out[0], v1[:10])
    np.testing.assert_array_equal(out[1], v1[10:20])
    np.testing.assert_array_equal(out[2], v2[:10])


def test_s2_outer_matches_reference(rng):
    vecs = random_unit_walk(rng, 1, 200, 6)[0]  # (nF, nRes, 3)
    # Reference formula (calculate-Ct-from-traj.py:129-132)
    tmp = np.einsum("ijk,ijl->jkl", vecs, vecs) / vecs.shape[0]
    want = 1.5 * np.einsum("...ij,...ij->...", tmp, tmp) - 0.5
    got = np.asarray(ac.s2_outer(vecs))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_s2_blocked_matches_reference(rng):
    vecs = random_unit_walk(rng, 1, 120, 4)[0]
    dt, tau = 1.0, 30.0
    got = np.asarray(ac.s2_outer_blocked(vecs, dt, tau))
    # Reference (calculate-Ct-from-traj.py:134-142)
    npb = int(tau / dt)
    nb = vecs.shape[0] // npb
    v = vecs[: nb * npb].reshape(nb, npb, 4, 3)
    tmp = np.einsum("ijkl,ijkm->iklm", v, v) / npb
    tmp = 1.5 * np.einsum("...ij,...ij->...", tmp, tmp) - 0.5
    S2 = np.mean(tmp, axis=0)
    dS2 = np.std(tmp, axis=0) / (np.sqrt(nb) - 1.0)
    np.testing.assert_allclose(got[:, 0], S2, atol=1e-12)
    np.testing.assert_allclose(got[:, 1], dS2, atol=1e-12)


def test_rigid_s2_is_one(rng):
    v = rng.normal(size=(1, 1, 2, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    vecs = np.broadcast_to(v, (1, 50, 2, 3))[0]
    np.testing.assert_allclose(np.asarray(ac.s2_outer(vecs)), 1.0, atol=1e-12)


def test_synthetic_exponential_recovery(rng):
    """Vectors diffusing on a cone around z: C(t) should decay towards a
    plateau ~S2 — sanity check that lag structure is physically right."""
    n_rep, n_frames, n_res = 8, 256, 2
    theta0 = 0.4
    phi = np.cumsum(rng.normal(scale=0.5, size=(n_rep, n_frames, n_res)), axis=1)
    vecs = np.stack(
        [
            np.sin(theta0) * np.cos(phi),
            np.sin(theta0) * np.sin(phi),
            np.full_like(phi, np.cos(theta0)),
        ],
        axis=-1,
    )
    ct, _ = ac.ct_palmer(vecs)
    ct = np.asarray(ct)
    # Free azimuthal diffusion on a ring: only the m=0 spherical component
    # survives, so the plateau is P2(cos theta0)^2.
    s2_cone = (1.5 * np.cos(theta0) ** 2 - 0.5) ** 2
    # Early lags near 1, late lags near the cone-model S2 plateau.
    assert np.all(ct[0] > 0.9)
    np.testing.assert_allclose(ct[-20:].mean(axis=0), s2_cone, atol=0.05)


def test_streamed_matches_full(rng):
    vecs = random_unit_walk(rng, n_rep=6, n_frames=40, n_res=4)
    ct1, dct1 = ac.ct_palmer(vecs)

    def chunks():
        yield vecs[:2]
        yield vecs[2:5]
        yield vecs[5:]

    ct2, dct2 = ac.ct_palmer_streamed(chunks(), n_frames_per_chunk=40)
    np.testing.assert_allclose(np.asarray(ct2), np.asarray(ct1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(dct2), np.asarray(dct1), atol=1e-9)


def test_iter_trajectory_npy(tmp_path, rng):
    from spinrelax_tpu.io.trajectory import iter_trajectory

    xyz = rng.normal(size=(25, 7, 3)).astype(np.float32)
    fn = str(tmp_path / "traj.npy")
    np.save(fn, xyz)
    got = list(iter_trajectory(fn, chunk_frames=10, timestep=2.0))
    assert [g[0].shape[0] for g in got] == [10, 10, 5]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), xyz)
    assert got[0][1] == 2.0


def test_single_chunk_sem_is_nan_on_every_path(rng):
    """nReplicates=1: the reference's sqrt(1)-1 denominator gives 0/0 =
    NaN dCt (calculate-Ct-from-traj.py:228); the pooled/streamed paths
    must agree with ct_palmer instead of reporting zero error bars."""
    import numpy as np

    from spinrelax_tpu.ops.autocorr import ct_palmer, ct_palmer_streamed

    v = rng.normal(size=(1, 32, 4, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    _, d1 = ct_palmer(v)
    _, d2 = ct_palmer_streamed(iter([v]), 32)
    assert np.all(np.isnan(np.asarray(d1)))
    assert np.all(np.isnan(np.asarray(d2)))


def test_streamed_empty_iterator_raises():
    import pytest as _pytest

    from spinrelax_tpu.ops.autocorr import ct_palmer_streamed

    with _pytest.raises(ValueError, match="empty chunk iterator"):
        ct_palmer_streamed(iter([]), 32)


def test_acf_fft_oracle_matches_production_paths():
    """_acf_sums_fft (straight jnp.fft correlation) is kept as an
    independently-derived oracle for the production matmul-DFT path —
    this parity pin is what keeps it from being dead code."""
    import jax.numpy as jnp

    from spinrelax_tpu.ops.autocorr import _acf_sums_fft, _acf_sums_xla

    rng = np.random.default_rng(12)
    v = rng.normal(size=(3, 50, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.asarray(v)
    nd = 25
    np.testing.assert_allclose(
        np.asarray(_acf_sums_fft(v, nd)),
        np.asarray(_acf_sums_xla(v, nd)),
        rtol=1e-9, atol=1e-9,
    )


@pytest.mark.parametrize("n_frames,n_deltas", [(5, 4), (64, 32), (333, 100)])
def test_matmul_dft_dc_split_is_exact(n_frames, n_deltas):
    """The matmul-DFT correlates the CENTRED components and adds the
    mean's share back in closed form from prefix sums; in float64 that
    split is exact against the straight FFT form for DC-heavy vectors,
    at odd lengths and up to the longest lag the closed form indexes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n_frames)
    v = np.array([0.3, -0.5, 0.8]) + 0.2 * rng.normal(size=(2, n_frames, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.asarray(v)
    want = np.asarray(ac._acf_sums_fft(v, n_deltas))
    got = np.asarray(ac._acf_sums_xla(v, n_deltas))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
