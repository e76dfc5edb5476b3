"""chip_smoke.py on the CPU backend: every phase at a tiny size, the
refusal to run without a GPU, and the exact shape of its last line.

The phases' device-vs-host comparisons degenerate to CPU-vs-CPU here; what
these tests pin is that each phase drives its entry points end to end and
reports every check.  The card itself is exercised by running
``python chip_smoke.py`` on it."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _assert_phase(rec, phase):
    assert rec["phase"] == phase
    assert rec["checks"], rec
    for c in rec["checks"]:
        assert set(c) == {"name", "err", "tol", "ok"}
    assert rec["ok"], [c for c in rec["checks"] if not c["ok"]]
    json.dumps(rec, default=float)  # printable as one JSON line


def test_phase_runall_tiny(tmp_path):
    rec = cs.phase_runall(
        str(tmp_path / "ra"), n_res=4, n_atoms=40, n_frames=2000,
        cases=((200.0, ("-stream", "2")), (100.0, ())),
        bfields=(600.133,), warm=0)
    _assert_phase(rec, "P1_runall")
    for tag in ("tmem200", "tmem100"):
        assert rec["runs"][tag]["rc"] == 0
        assert rec["runs"][tag]["missing"] == []
        assert rec["runs"][tag]["compiles"]["n"] > 0


def test_phase_ct_tiny():
    rec = cs.phase_ct(shapes=((2, 64, 8), (2, 96, 4)), n_check=4, reps=1)
    _assert_phase(rec, "P2_ct")
    assert set(rec["run_s"]) == {"xla_2x64x8", "fft_2x64x8",
                                 "xla_2x96x4", "fft_2x96x4"}


def test_phase_ladder_tiny():
    rec = cs.phase_ladder(n_res=16, n_lags=40, n_cmp=8, reps=1)
    _assert_phase(rec, "P3_ladder")


def test_phase_rates_tiny():
    rec = cs.phase_rates(n_res=6, n_samp=16, reps=1)
    _assert_phase(rec, "P4_rates")


def test_phase_dq_tiny(tmp_path):
    rec = cs.phase_dq(str(tmp_path), n_frames=20000, tau=200.0, reps=1)
    _assert_phase(rec, "P5_dq")
    assert rec["shapes"]["n_lags"] == 100


def test_phase_four_on_virtual_devices():
    """The --four phase on 4 of conftest's virtual CPU devices."""
    rec = cs.phase_four(n_bonds=16, n_frames=64, g=4, n_groups=2,
                        n_res_fit=8, n_samp=16)
    _assert_phase(rec, "four_mesh")
    assert rec["shapes"]["mesh"] == {"rep": 2, "res": 2}
    assert len(rec["peak_bytes_per_device"]) == 4


def test_main_refuses_cpu_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_rejects_unknown_arguments(capsys):
    assert cs.main(["--eight"]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_ok_line_shape():
    line = cs.ok_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}


def test_acf_host_reference_matches_direct_loop(rng):
    """The f64 numpy reference P2 compares against equals the literal lag
    loop (ct_palmer_direct)."""
    import jax.numpy as jnp

    from spinrelax_tpu.ops import autocorr as ac

    v = rng.normal(size=(2, 40, 3, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    s = cs._acf_sums_host(np.swapaxes(v, 1, 2), 20)  # (rep, res, D)
    n_vals = 40 - np.arange(1, 21)
    ct = np.mean(-0.5 + 1.5 * s / n_vals, axis=0).T
    ref, _ = ac.ct_palmer_direct(jnp.asarray(v))
    np.testing.assert_allclose(ct, np.asarray(ref), atol=1e-12)


def test_ladder_cohort_layout():
    dt, y, sg = cs.ladder_cohort(10, 30)
    assert dt.shape == (30,) and y.shape == sg.shape == (10, 30)
    assert y.dtype == np.float32
    np.testing.assert_array_equal(sg[:5], 5e-4 * np.ones((5, 30), np.float32))
    np.testing.assert_array_equal(sg[5:], 1e-4 * np.ones((5, 30), np.float32))


def test_artefact_parsing(tmp_path):
    good = tmp_path / "a.dat"
    good.write_text('@s0 legend "2"\n# hdr\n1 0.5 0.1\n2 0.25 0.1\n&\n')
    bad = tmp_path / "b.dat"
    bad.write_text("1 nan\n")
    empty = tmp_path / "c.dat"
    empty.write_text("# only a header\n")
    np.testing.assert_array_equal(cs._numbers(str(good)),
                                  [1, 0.5, 0.1, 2, 0.25, 0.1])
    assert cs._artefact_ok(str(good))
    assert not cs._artefact_ok(str(bad))
    assert not cs._artefact_ok(str(empty))
    assert not cs._artefact_ok(str(tmp_path / "missing.dat"))


def test_bond_vectors_unit_and_layout():
    import jax

    v = np.asarray(cs._bond_vectors(jax.random.PRNGKey(0), 3, 50, 4))
    assert v.shape == (3, 50, 4, 3) and v.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-6)


def test_simulate_quats_unit_and_seeded():
    from spinrelax_tpu.utils.synthetic import simulate_quats

    q = simulate_quats(500, [1e-4] * 3, 1.0, seed=3)
    assert q.shape == (500, 4)
    np.testing.assert_allclose(q[0], [1.0, 0, 0, 0])
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(q, simulate_quats(500, [1e-4] * 3, 1.0,
                                                    seed=3))
