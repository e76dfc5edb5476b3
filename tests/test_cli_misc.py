"""CLI-level tests: check/rho/rotate/hydronmr/plot-ct commands, dq
histogram/tensor outputs, and eta cross-correlated rates."""

import os
import subprocess
import sys

import numpy as np
import pytest

from spinrelax_tpu.constants import NucleusPair, field_from_mhz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, cwd, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [
            sys.executable, "-c",
            "import jax; jax.config.update('jax_platforms','cpu');"
            "from spinrelax_tpu.pipeline.cli import main; main()",
        ]
        + args,
        cwd=str(cwd),
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_check_command(tmp_path):
    out = run_cli(["check"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PASSED" in out.stdout


def test_rho_command(tmp_path):
    # Build a rate table from a known J and verify rho recovery.
    fn = tmp_path / "exp.dat"
    with open(fn, "w") as fp:
        fp.write("# resid R1 R2 NOE\n")
        fp.write("2 1.4 12.0 0.77\n3 1.5 11.5 0.80\n")
    out = run_cli(["rho", "-f", str(fn), "-o", "rho.dat"], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    data = np.loadtxt(tmp_path / "rho.dat")
    assert data.shape == (2, 2)
    assert np.all(np.isfinite(data[:, 1]))


def test_rotate_command(tmp_path):
    from spinrelax_tpu.io import pdb as pdbio

    rng = np.random.default_rng(0)
    n = 5
    top = pdbio.Topology(
        atom_names=["CA"] * n,
        res_seqs=np.arange(1, n + 1),
        res_names=["ALA"] * n,
        chain_ids=["A"] * n,
        occupancies=np.ones(n),
        elements=["C"] * n,
    )
    xyz = rng.normal(size=(1, n, 3))
    pdbio.write_pdb(str(tmp_path / "in.pdb"), top, xyz)
    out = run_cli(
        ["rotate", "-f", "in.pdb", "-q", "0.7071068,0,0,0.7071068", "-o", "out.pdb"],
        tmp_path,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    _, xyz2 = pdbio.read_pdb(str(tmp_path / "out.pdb"))
    com = xyz[0].mean(axis=0)
    # 90-degree rotation about z around the COM.
    rel = xyz[0] - com
    want = np.stack([-rel[:, 1], rel[:, 0], rel[:, 2]], axis=-1) + com
    np.testing.assert_allclose(xyz2[0], want, atol=2e-3)  # PDB %.3f precision


def test_hydronmr_parser(tmp_path):
    res = tmp_path / "output.res"
    with open(res, "w") as fp:
        fp.write(
            "  Structural file: 1abc.pdb\n"
            " Dx  1.5e7   eigenvector:  0.0 0.0 1.0\n"
            " Dy  2.5e7   eigenvector:  1.0 0.0 0.0\n"
            " Dz  2.0e7   eigenvector:  0.0 1.0 0.0\n"
        )
    from spinrelax_tpu.io.hydronmr import read_hydronmr_results, translate_D

    D, mat, pdb = read_hydronmr_results(str(res))
    assert pdb == "1abc.pdb"
    np.testing.assert_allclose(D, [1.5e7, 2.0e7, 2.5e7])
    # Rows stay unit length after the reorder rotation.
    np.testing.assert_allclose(np.linalg.norm(mat, axis=-1), 1.0, atol=1e-12)
    Dp = translate_D(D * 1e-12)
    np.testing.assert_allclose(Dp[0], 2.0e-5)


def test_eta_rates():
    import jax.numpy as jnp

    from spinrelax_tpu.ops import relaxation as rx

    pair = NucleusPair(B0=field_from_mhz(600.133), time_unit="ps")
    J = jnp.asarray(np.array([3000.0, 800.0, 40.0, 50.0, 30.0]))
    # Reference formulas (spectral_densities.py:1758-1773).
    r_m = 1.02e-10
    fact = (
        -1.0545718e-41 * pair.gamma_b * pair.gamma_a**2 * r_m**-3.0
        * pair.B0 * pair.csa_value * 0.4
    )
    want_z = fact * (1.5 - 0.5) * 800.0
    want_xy = fact / 6.0 * (1.5 - 0.5) * (4 * 3000.0 + 3 * 800.0)
    np.testing.assert_allclose(float(rx.eta_z_from_j(J, pair)), want_z, rtol=1e-12)
    np.testing.assert_allclose(float(rx.eta_xy_from_j(J, pair)), want_xy, rtol=1e-12)


@pytest.mark.slow
def test_dq_hist_and_tensor(tmp_path, rng):
    # Small quaternion random walk -> colvar -> dq with hist + fulltensor.
    n = 600
    q = np.zeros((n, 4))
    q[0] = [1, 0, 0, 0]
    for t in range(1, n):
        w = rng.normal(scale=0.05, size=3)
        th = np.linalg.norm(w)
        dq = np.concatenate([[np.cos(th / 2)], w / th * np.sin(th / 2)])
        w1, x1, y1, z1 = q[t - 1]
        w2, x2, y2, z2 = dq
        q[t] = [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ]
        q[t] /= np.linalg.norm(q[t])
    with open(tmp_path / "colvar", "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(n):
            fp.write(" %f %f %f %f %f\n" % (t * 1.0, *q[t]))
    out = run_cli(
        [
            "dq", "-f", "colvar", "-o", "dq", "--iso" if False else "--mindt", "20",
            "--maxdt", "200", "--skip", "60", "--hist", "-n", "21",
            "-o2", "dx", "--fulltensor",
        ],
        tmp_path,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    hists = [f for f in os.listdir(tmp_path) if f.startswith("dq-hist-")]
    assert len(hists) >= 3
    assert os.path.exists(tmp_path / "dq-tensor.dat")
    from spinrelax_tpu.io.dx import read_dx

    data, dims, orig, abc = read_dx(str(tmp_path / hists[0]), units="nm")
    assert tuple(dims) == (21, 21, 21)
    assert np.all(np.isfinite(data))


def test_dq_stream_cli_flag(tmp_path, rng):
    """'spinrelax dq --stream N' end-to-end through the CLI parser."""
    import numpy as np
    from spinrelax_tpu.pipeline import cli

    n = 3000
    th = np.cumsum(rng.normal(scale=0.05, size=n))
    q = np.stack([np.cos(th/2), np.sin(th/2)*0.6, np.sin(th/2)*0.8, np.zeros(n)], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fn = str(tmp_path / "colvar-qorient")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(n):
            fp.write(" %f %f %f %f %f\n" % (t*1.0, *q[t]))
    cli.main(["dq", "-f", fn, "-o", str(tmp_path / "out"),
              "--mindt", "5", "--maxdt", "100", "--skip", "5",
              "--stream", "700"])
    assert (tmp_path / "out-iso.dat").exists()
    assert (tmp_path / "out-aniso2.dat").exists()


def test_dq_iso_aniso_gating(tmp_path, rng):
    """--iso alone writes only -iso.dat (reference flag semantics)."""
    import numpy as np
    from spinrelax_tpu.pipeline import cli

    n = 2000
    th = np.cumsum(rng.normal(scale=0.05, size=n))
    q = np.stack([np.cos(th/2), np.sin(th/2), np.zeros(n), np.zeros(n)], axis=1)
    fn = str(tmp_path / "colvar-qorient")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w q.x q.y q.z\n")
        for t in range(n):
            fp.write(" %f %f %f %f %f\n" % (t*1.0, *q[t]))
    cli.main(["dq", "-f", fn, "-o", str(tmp_path / "i"),
              "--mindt", "5", "--maxdt", "50", "--skip", "5", "--iso"])
    assert (tmp_path / "i-iso.dat").exists()
    assert not (tmp_path / "i-aniso2.dat").exists()
    cli.main(["dq", "-f", fn, "-o", str(tmp_path / "b"),
              "--mindt", "5", "--maxdt", "50", "--skip", "5"])
    assert (tmp_path / "b-iso.dat").exists()
    assert (tmp_path / "b-aniso2.dat").exists()


def test_cli_center(tmp_path, rng):
    """spinrelax center: native center-solute-gromacs.bash over npz+PDB."""
    from spinrelax_tpu.io.pdb import Topology, write_pdb
    from spinrelax_tpu.ops.pbc import minimum_image_distance, molecule_ids
    from spinrelax_tpu.pipeline import cli

    box = np.array([5.0, 5.0, 5.0])
    chain = np.cumsum(rng.normal(scale=0.1, size=(20, 3)), axis=0) + 4.8
    waters = np.concatenate(
        [np.stack([o, o + [0.08, 0, 0], o + [0, 0.08, 0]])
         for o in rng.uniform(0, 5, size=(10, 3))]
    )
    xyz = np.mod(np.concatenate([chain, waters]), box)
    top = Topology(
        atom_names=["CA"] * 20 + [n for _ in range(10) for n in ("OW", "HW1", "HW2")],
        res_seqs=np.concatenate([np.arange(1, 21), np.repeat(np.arange(50, 60), 3)]),
        res_names=["GLY"] * 20 + ["SOL"] * 30,
        chain_ids=["A"] * 20 + ["W"] * 30,
        occupancies=np.ones(50),
        elements=[""] * 50,
    )
    write_pdb(str(tmp_path / "top.pdb"), top, xyz[None])
    np.savez(tmp_path / "in.npz", xyz=np.stack([xyz, xyz]),
             time=np.array([0.0, 1.0]), box=np.stack([box, box]))
    cli.main(["center", "-f", str(tmp_path / "in.npz"),
              "-s", str(tmp_path / "top.pdb"),
              "-o", str(tmp_path / "out.npz")])
    out = np.load(tmp_path / "out.npz")["xyz"]
    assert out.shape == (2, 50, 3)
    x = out[0]
    mol = molecule_ids(top)
    for m in range(mol.max() + 1):
        idx = np.where(mol == m)[0]
        d = x[idx] - x[idx[0]]
        np.testing.assert_allclose(
            d, np.asarray(minimum_image_distance(x[idx], x[idx[0]], box)),
            atol=1e-5)
    np.testing.assert_allclose(x[:20].mean(axis=0), box / 2, atol=1e-5)
    # solute-only output group (the reference's stage-1 Solute selection)
    cli.main(["center", "-f", str(tmp_path / "in.npz"),
              "-s", str(tmp_path / "top.pdb"), "--output-group", "solute",
              "-o", str(tmp_path / "sol.npz")])
    assert np.load(tmp_path / "sol.npz")["xyz"].shape == (2, 20, 3)


def test_compile_cache_helper(tmp_path, monkeypatch):
    """enable_default sets no directory of its own when
    JAX_COMPILATION_CACHE_DIR is set, falls back to <checkout>/.jax_cache
    otherwise, and the kill switch wins."""
    import jax

    from spinrelax_tpu.utils import compile_cache

    monkeypatch.delenv("SPINRELAX_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_CHECKOUT", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
        assert compile_cache.cache_dir() == str(tmp_path / "x")
        assert compile_cache.enable_default()
        assert jax.config.jax_compilation_cache_dir == prev
        assert not (tmp_path / ".jax_cache").exists()
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert compile_cache.enable_default()
        assert jax.config.jax_compilation_cache_dir == str(
            tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()
        monkeypatch.setenv("SPINRELAX_NO_COMPILE_CACHE", "1")
        assert compile_cache.cache_dir() is None
        assert not compile_cache.enable_default()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


_CACHE_PROBE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from spinrelax_tpu.utils import compile_cache
compile_cache._CHECKOUT = sys.argv[1]
assert compile_cache.enable_default()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
print(float(jax.jit(lambda x: (x * 3.0).sum())(jax.numpy.ones(7))))
"""


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(tmp_path, from_env):
    """Compiled entries land in JAX_COMPILATION_CACHE_DIR when it is set
    and nowhere else; without it, under <checkout>/.jax_cache."""
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPINRELAX_NO_COMPILE_CACHE",
                        "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = REPO
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "x")
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE, str(checkout)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = tmp_path / "x" if from_env else checkout / ".jax_cache"
    other = checkout / ".jax_cache" if from_env else tmp_path / "x"
    assert want.is_dir() and any(want.iterdir())
    assert not other.exists()


def test_s2_zeta_semantics(tmp_path, rng):
    """`spinrelax s2` applies zeta=1 by default and the libration factor
    only under its boolean --zeta switch (calculate-S2.py:265,288-292),
    while the ct stage's --prefact DEFAULTS to that factor
    (calculate-Ct-from-traj.py:317)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_runall import build_synthetic_system

    ref_fn, trj_fn, _ = build_synthetic_system(
        tmp_path, rng, n_res=4, n_frames=200
    )
    zeta = (1.02 / 1.04) ** 6

    def s2_of(outpref, cmd):
        out = run_cli(cmd + ["-o", outpref], tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        return np.loadtxt(tmp_path / (outpref + "_S2.dat"),
                          comments=("#", "&", "@"))

    base = ["-s", ref_fn, "-f", trj_fn, "-t", "50"]
    plain = s2_of("plain", ["s2"] + base)
    scaled = s2_of("scaled", ["s2"] + base + ["--zeta"])
    ct_default = s2_of("ctdef", ["ct", "--S2"] + base)

    # s2 --zeta == zeta * s2 default; ct's default already carries zeta.
    np.testing.assert_allclose(scaled, plain * [1.0, zeta, zeta], rtol=1e-5)
    np.testing.assert_allclose(ct_default, scaled, rtol=1e-5)
    # an explicit --prefact passthrough beats the switch
    pre = s2_of("pre", ["s2"] + base + ["--prefact", "0.5"])
    np.testing.assert_allclose(pre, plain * [1.0, 0.5, 0.5], rtol=1e-5)

    # tau is OPTIONAL (calculate-S2.py:259-262): without it the S2 is
    # computed unblocked over all frames and carries no error column
    # (calculate-S2.py:122-125,441-443), and C(t) is refused
    # (calculate-Ct-from-traj.py:358-360).
    nofield = s2_of("nofield", ["s2", "-s", ref_fn, "-f", trj_fn])
    assert nofield.shape == (plain.shape[0], 2)  # resid + value only
    np.testing.assert_allclose(nofield[:, 0], plain[:, 0])
    assert np.all((nofield[:, 1] > 0.0) & (nofield[:, 1] <= 1.0))
    # unblocked sees the full-trajectory decorrelation, so it sits at or
    # below the block-averaged mean on a decaying C(t)
    assert np.all(nofield[:, 1] <= plain[:, 1] + 1e-6)
    bad = run_cli(["ct", "--Ct", "-s", ref_fn, "-f", trj_fn, "-o", "x"],
                  tmp_path)
    assert bad.returncode != 0
    assert "Refusing to do C(t)-analysis" in (bad.stderr + bad.stdout)


def test_plot_ct_flag_surface(tmp_path):
    """plot-ct accepts the reference's full cosmetic flag surface
    (plot-fittedCt-values.py:29-65) and renders each variant."""
    from spinrelax_tpu.io.fittedct import write_fittedct
    from spinrelax_tpu.models.ctmodel import CtModelSet
    from spinrelax_tpu.pipeline.plotting import main as plot_main

    cts = CtModelSet.from_lists(
        ["2", "3", "4"],
        [0.82, 0.78, 0.85],
        [[0.10, 0.05], [0.12, 0.0], [0.08, 0.04]],
        [[50.0, 1500.0], [80.0, 1.0], [30.0, 900.0]],
    )
    fn = tmp_path / "toy_fittedCt.dat"
    write_fittedct(str(fn), cts)

    plot_main(["-f", str(fn), "-o", str(tmp_path / "a.png"), "-v",
               "--smin", "3", "--smax", "12", "--xmin", "1", "--xmax", "6",
               "--xlabel", "Residue", "--title", "toy", "--tu", "ns"])
    assert (tmp_path / "a.png").stat().st_size > 0

    # sequence tick labels + xshift + explicit tau window (shifts the
    # 1 ps component into S2_fast and the 1500 ps one into S2_slow)
    plot_main(["-f", str(fn), "-o", str(tmp_path / "b.png"),
               "--sequence", "ALA GLY SER", "--xshift", "2",
               "--tmin", "10", "--tmax", "1000"])
    assert (tmp_path / "b.png").stat().st_size > 0

    plot_main(["-f", str(fn), "-o", str(tmp_path / "c.png"), "--noshift"])
    assert (tmp_path / "c.png").stat().st_size > 0


def test_cli_missing_file_bails_reference_style(tmp_path):
    """A missing input file must produce the reference's '= = = ERROR'
    bail (spectral_densities.py:1818-1823 _BAIL convention), not a raw
    FileNotFoundError traceback."""
    import subprocess
    import sys as _sys

    r = subprocess.run(
        [_sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from spinrelax_tpu.pipeline.cli import main; main()",
         "fit-ct", "-f", str(tmp_path / "nope_Ctint.dat"), "-o", "x"],
        capture_output=True, text=True,
    )
    assert r.returncode != 0
    assert "= = = ERROR: file not found" in r.stderr
    assert "Traceback" not in r.stderr
