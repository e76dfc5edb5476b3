"""Regression tests for the round-3 fourth-review findings batch.

Each test pins one fixed behaviour:
- iter_colvar_chunks refuses multi-replica files (silent replica mixing);
- manifest params survive non-string keys + writes are atomic;
- load_trajectory/.npy and iter_trajectory timestep contracts;
- read_pdb fails clearly on empty / inhomogeneous-MODEL files;
- bond_indices repair is keyed on (chain, resSeq), not resSeq alone;
- lambert_histogram counts are integer (no f32 2^24 saturation);
- bond_vectors' rotate-only-differences fast path equals the full
  superpose computation.
"""

import os

import jax.numpy as jnp

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Free the process's accumulated compiled-executable state before
    this module (round-5 finding): after ~700 tests in one process the
    XLA:CPU JIT segfaulted inside backend_compile_and_load compiling
    ct_palmer here — reproducibly at this module, never in isolation or
    in module-pair runs, with the new native code ASAN-clean — i.e. an
    upstream compiler crash under accumulated code-space state.
    Clearing jax's caches re-traces a handful of programs (seconds) and
    sidesteps the edge."""
    import jax

    jax.clear_caches()


from spinrelax_tpu.core import quaternion as qt
from spinrelax_tpu.core.geometry import lambert_histogram
from spinrelax_tpu.io import colvar, trajectory
from spinrelax_tpu.io.pdb import Topology, bond_indices, read_pdb, write_pdb
from spinrelax_tpu.ops import orient
from spinrelax_tpu.pipeline.manifest import record_stage, stage_is_current


def test_iter_colvar_chunks_header_semantics(tmp_path):
    # Identical repeated header = restart continuation: accepted (with a
    # warning), streamed as ONE trajectory — matching read_colvar, which
    # ignores all # lines.
    fn = str(tmp_path / "restart.colvar")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w\n0.0 1.0\n1.0 0.9\n")
        fp.write("#! FIELDS time q.w\n2.0 1.0\n3.0 0.8\n")
    with pytest.warns(UserWarning, match="restart continuation"):
        chunks = list(colvar.iter_colvar_chunks(fn, chunk_frames=64))
    assert sum(c.shape[0] for _, c in chunks) == 4
    # A DIFFERING header mid-file is incompatible: hard error.
    fn2 = str(tmp_path / "mixed.colvar")
    with open(fn2, "w") as fp:
        fp.write("#! FIELDS time q.w\n0.0 1.0\n")
        fp.write("#! FIELDS time q.w q.x\n0.0 1.0 0.5\n")
    with pytest.raises(ValueError, match="changed mid-file"):
        for _ in colvar.iter_colvar_chunks(fn2, chunk_frames=64):
            pass
    # Single-replica files stream fine.
    fn1 = str(tmp_path / "one.colvar")
    with open(fn1, "w") as fp:
        fp.write("#! FIELDS time q.w\n")
        for i in range(5):
            fp.write(f"{i}.0 1.0\n")
    chunks = list(colvar.iter_colvar_chunks(fn1, chunk_frames=2))
    assert sum(c.shape[0] for _, c in chunks) == 5
    # Data before any FIELDS header: hard error (read_colvar raises on
    # headerless files; the streamed reader must not guess columns).
    fn3 = str(tmp_path / "headerless.colvar")
    with open(fn3, "w") as fp:
        fp.write("0.0 1.0\n#! FIELDS time q.w\n1.0 0.9\n")
    with pytest.raises(ValueError, match="before any FIELDS"):
        for _ in colvar.iter_colvar_chunks(fn3, chunk_frames=64):
            pass


def test_manifest_nonstring_keys_stable(tmp_path):
    inp = tmp_path / "in.dat"
    inp.write_text("x")
    pref = str(tmp_path / "run")
    out = tmp_path / "out.dat"
    out.write_text("y")
    params = {1: "a", (2, 3): [4, 5]}
    record_stage(pref, "s", [str(inp)], params=params)
    # Same params must compare current forever (not a permanent miss).
    assert stage_is_current(pref, "s", [str(inp)], [str(out)], params=params)
    assert not stage_is_current(
        pref, "s", [str(inp)], [str(out)], params={1: "b", (2, 3): [4, 5]}
    )


def test_manifest_write_is_atomic(tmp_path):
    inp = tmp_path / "in.dat"
    inp.write_text("x")
    pref = str(tmp_path / "run")
    record_stage(pref, "s", [str(inp)], params={"k": 1})
    # No temp file left behind; manifest parses.
    assert not os.path.exists(pref + ".manifest.json.tmp")
    import json

    with open(pref + ".manifest.json") as fp:
        json.load(fp)


def test_load_trajectory_npy(tmp_path):
    xyz = np.random.default_rng(0).normal(size=(4, 3, 3))
    fn = str(tmp_path / "t.npy")
    np.save(fn, xyz)
    got, dt = trajectory.load_trajectory(fn)
    np.testing.assert_array_equal(got, xyz)
    assert dt == 1.0


def test_iter_trajectory_npz_timestep_contract(tmp_path):
    xyz = np.zeros((6, 2, 3))
    # npz WITHOUT time info: explicit timestep param wins.
    fn = str(tmp_path / "no_time.npz")
    np.savez(fn, xyz=xyz)
    chunks = list(trajectory.iter_trajectory(fn, 4, timestep=2.5))
    assert all(dt == 2.5 for _, dt in chunks)
    # npz WITH a time axis: the file wins.
    fn2 = str(tmp_path / "with_time.npz")
    np.savez(fn2, xyz=xyz, time=np.arange(6) * 0.5)
    chunks = list(trajectory.iter_trajectory(fn2, 4, timestep=2.5))
    assert all(dt == 0.5 for _, dt in chunks)


def test_read_pdb_empty_and_inhomogeneous(tmp_path):
    empty = tmp_path / "empty.pdb"
    empty.write_text("REMARK nothing here\nEND\n")
    with pytest.raises(ValueError, match="no ATOM records"):
        read_pdb(str(empty))

    bad = tmp_path / "bad.pdb"
    bad.write_text(
        "MODEL     1\n"
        "ATOM      1  N   ALA A   1       0.000   0.000   0.000  1.00  0.00           N\n"
        "ATOM      2  H   ALA A   1       1.000   0.000   0.000  1.00  0.00           H\n"
        "ENDMDL\n"
        "MODEL     2\n"
        "ATOM      1  N   ALA A   1       0.000   0.000   0.000  1.00  0.00           N\n"
        "ENDMDL\n"
    )
    with pytest.raises(ValueError, match="inconsistent atom counts"):
        read_pdb(str(bad))


def _two_chain_top():
    """Chains A and B both number their residues 1..2; chain B residue 1
    is a PRO (no H-N pair)."""
    names, seqs, rnames, chains = [], [], [], []
    for ch, resn_by_seq in (("A", {1: "ALA", 2: "GLY"}), ("B", {1: "PRO", 2: "ALA"})):
        for seq, resn in resn_by_seq.items():
            for at in ("N", "H"):
                if resn == "PRO" and at == "H":
                    continue
                names.append(at)
                seqs.append(seq)
                rnames.append(resn)
                chains.append(ch)
    n = len(names)
    return Topology(
        atom_names=names,
        res_seqs=np.array(seqs),
        res_names=rnames,
        chain_ids=chains,
        occupancies=np.ones(n),
        elements=[a[0] for a in names],
    )


def test_bond_indices_repair_keys_on_chain(tmp_path):
    top = _two_chain_top()
    idx_h, idx_x, res = bond_indices(top, "name H", "name N and not resname PRO")
    # Chain B residue 1 is PRO: its N is excluded, and no H exists for it
    # either — the repair must drop that residue in BOTH chains' keyspace
    # without pairing chain-A atoms against chain-B atoms.
    assert len(idx_h) == len(idx_x) == 3
    chains = np.asarray(top.chain_ids)
    np.testing.assert_array_equal(chains[idx_h], chains[idx_x])
    np.testing.assert_array_equal(top.res_seqs[idx_h], top.res_seqs[idx_x])
    for h, x in zip(idx_h, idx_x):
        assert top.atom_names[h] == "H" and top.atom_names[x] == "N"


def test_lambert_histogram_integer_counts():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(2, 500, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    hist, ep, ec = lambert_histogram(jnp.asarray(v, dtype=jnp.float32), 24, 12)
    assert jnp.issubdtype(hist.dtype, jnp.integer)
    np.testing.assert_array_equal(np.asarray(hist).sum(axis=(-2, -1)), 500)


def test_bond_vectors_fast_path_matches_superpose(rng=np.random.default_rng(11)):
    """Rotating only the bond differences must equal differencing the
    fully superposed frames (rotation is linear; translation cancels)."""
    n_at = 24
    ref = rng.normal(size=(n_at, 3))
    ref -= ref.mean(axis=0)
    frames = []
    for _ in range(6):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        ang = rng.uniform(0, np.pi)
        q = np.concatenate([[np.cos(ang / 2)], ax * np.sin(ang / 2)])
        frames.append(
            np.asarray(qt.rotate_vector(jnp.asarray(ref), jnp.asarray(q)))
            + rng.normal(size=3)  # translation
            + 0.01 * rng.normal(size=(n_at, 3))  # internal motion
        )
    frames = np.stack(frames)
    idx_h = np.arange(0, 12, 2)
    idx_x = np.arange(1, 13, 2)
    w = rng.uniform(0.5, 1.5, size=n_at)

    bv = orient.bond_vectors(
        frames, ref, jnp.asarray(idx_h), jnp.asarray(idx_x), jnp.asarray(w)
    )
    fitted_frames = np.asarray(orient.superpose(frames, ref, jnp.asarray(w)))
    expect = fitted_frames[:, idx_h, :] - fitted_frames[:, idx_x, :]
    expect /= np.linalg.norm(expect, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(bv.fitted), expect, atol=1e-6)


# --- fifth-review batch ----------------------------------------------------


def test_with_diso_ellipsoid_rescales():
    import jax.numpy as jnp

    from spinrelax_tpu.models.diffusion import Diffusion

    d = Diffusion.ellipsoid(jnp.asarray([1e-5, 2e-5, 3e-5]))
    d2 = d.with_diso(4e-5)
    np.testing.assert_allclose(float(jnp.mean(d2.dxyz)), 4e-5, rtol=1e-12)
    # Shape preserved: ratios unchanged.
    np.testing.assert_allclose(
        np.asarray(d2.dxyz) / np.asarray(d.dxyz),
        (4e-5 / float(d.diso)) * np.ones(3),
        rtol=1e-12,
    )
    with pytest.raises(ValueError, match="ellipsoid"):
        d.with_aniso(1.5)


def test_fittedct_nons2fast_literal_zero_error(tmp_path):
    """Fitted non-S2fast models print the literal '+- 0.0' for S2_0
    (reference report(style='xmgrace'), fitting_Ct_functions.py:251)
    even when a nonzero dS2 is carried internally."""
    from spinrelax_tpu.io.fittedct import write_fittedct
    from spinrelax_tpu.models import CtModelSet

    cts = CtModelSet.from_lists(
        names=["5"], S2=[0.8], C_list=[[0.2]], tau_list=[[50.0]],
        s2fast=[False], dS2=[0.0123], dC_list=[[0.01]],
        dtau_list=[[5.0]], chisq=[0.5],
    )
    fn = str(tmp_path / "f.dat")
    write_fittedct(fn, cts)
    text = open(fn).read()
    assert "# Param S2_0: 0.8 +- 0.0\n" in text
    assert "0.0123" not in text


def test_fittedct_legend_indices_without_targets(tmp_path):
    from spinrelax_tpu.io.fittedct import write_fittedct
    from spinrelax_tpu.models import CtModelSet

    cts = CtModelSet.from_lists(
        names=["1", "2", "3"], S2=[0.8, 0.7, 0.6],
        C_list=[[0.2], [0.3], [0.4]], tau_list=[[50.0], [60.0], [70.0]],
    )
    dt = np.arange(1.0, 5.0)
    fn = str(tmp_path / "f.dat")
    write_fittedct(fn, cts, dt=dt)
    sets = [l.split()[0] for l in open(fn) if l.startswith("@s")]
    assert sets == ["@s0", "@s1", "@s2"]
    fn2 = str(tmp_path / "g.dat")
    write_fittedct(fn2, cts, dt=dt, targets=np.ones((3, 4)) * 0.7)
    sets = [l.split()[0] for l in open(fn2) if l.startswith("@s")]
    assert sets == ["@s0", "@s2", "@s4"]


def _mini_trr_frame(fp, natoms, time, x=None, v=None):
    import struct

    def xdr_string(s):
        b = s.encode()
        return (
            struct.pack(">i", len(b) + 1)
            + struct.pack(">i", len(b))
            + b + b"\x00" * ((4 - len(b) % 4) % 4)
        )

    box = np.eye(3, dtype=">f4")
    fp.write(struct.pack(">i", 1993))
    fp.write(xdr_string("GMX_trn_file"))
    fp.write(struct.pack(
        ">13i", 0, 0, 36, 0, 0, 0, 0,
        natoms * 12 if x is not None else 0,
        natoms * 12 if v is not None else 0,
        0, natoms, 0, 0,
    ))
    fp.write(struct.pack(">2f", time, 0.0))
    fp.write(box.tobytes())
    if x is not None:
        fp.write(np.asarray(x, dtype=">f4").tobytes())
    if v is not None:
        fp.write(np.asarray(v, dtype=">f4").tobytes())


def test_iter_trr_skips_coordinate_less_frames(tmp_path):
    """A velocity-only TRR frame (nstxout != nstvout) is skipped, not
    fabricated as all-zero coordinates."""
    from spinrelax_tpu.io.gmx import read_trr

    fn = str(tmp_path / "t.trr")
    x0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    with open(fn, "wb") as fp:
        _mini_trr_frame(fp, 2, 0.0, x=x0)
        _mini_trr_frame(fp, 2, 1.0, v=np.ones((2, 3)))  # v only
        _mini_trr_frame(fp, 2, 2.0, x=x0 + 1.0)
    xyz, boxes, times = read_trr(fn)
    assert xyz.shape == (2, 2, 3)
    np.testing.assert_array_equal(times, [0.0, 2.0])
    np.testing.assert_allclose(xyz[1], x0 + 1.0)


def test_iter_trr_rejects_legacy_blocks(tmp_path):
    import struct

    from spinrelax_tpu.io.gmx import read_trr

    fn = str(tmp_path / "t.trr")
    with open(fn, "wb") as fp:
        b = "GMX_trn_file".encode()
        fp.write(struct.pack(">i", 1993))
        fp.write(struct.pack(">i", len(b) + 1) + struct.pack(">i", len(b)) + b)
        fp.write(struct.pack(">13i", 99, 0, 36, 0, 0, 0, 0, 24, 0, 0, 2, 0, 0))
        fp.write(struct.pack(">2f", 0.0, 0.0))
    with pytest.raises(ValueError, match="legacy TRR blocks"):
        read_trr(fn)


def test_experiment_duplicate_peaks_first_wins():
    import jax.numpy as jnp

    from spinrelax_tpu.io.experiments import ExperimentData
    from spinrelax_tpu.models import CtModelSet
    from spinrelax_tpu.models.diffusion import Diffusion
    from spinrelax_tpu.models.experiments import ExperimentSet

    cts = CtModelSet.from_lists(
        names=["1", "2"], S2=[0.8, 0.7], C_list=[[0.2], [0.3]],
        tau_list=[[50.0], [60.0]],
    )
    e = ExperimentData(
        expt_type="R1", nuclei_a="15N", nuclei_b="1H",
        frequency=600.133, freq_unit="MHz",
        names=np.array(["1", "1", "7"]),
        values=np.array([1.5, 9.9, 2.0]),
        errors=None,
    )
    with pytest.warns(UserWarning):
        es = ExperimentSet.build([e], cts, Diffusion.isotropic(tau=1000.0))
    a = es.experiments[0]
    # First duplicate wins (reference np.where(...)[0][0] semantics);
    # the unmatched peak '7' is dropped.
    assert float(a.target[0]) == 1.5
    assert float(a.mask[1]) == 0.0


def test_build_lib_atomic(tmp_path):
    from spinrelax_tpu.io.native import _build_lib

    src = tmp_path / "m.cpp"
    src.write_text('extern "C" int forty() { return 40; }\n')
    out = str(tmp_path / "libm.so")
    _build_lib(str(src), out)
    assert os.path.exists(out)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    import ctypes

    assert ctypes.CDLL(out).forty() == 40


# --- sixth-review batch ----------------------------------------------------


def test_hydronmr_rotate_all_models(tmp_path, monkeypatch):
    """--rotate rotates EVERY model about its own COG, not just model 0
    (the reference leaves models 1.. all-zero; bug not replicated)."""
    from spinrelax_tpu.io import pdb as pdbio
    from spinrelax_tpu.io.hydronmr import main as hmain

    res = tmp_path / "output.res"
    res.write_text(
        "  Structural file: multi.pdb\n"
        " Dx  1.5e7   eigenvector:  1.0 0.0 0.0\n"
        " Dy  2.0e7   eigenvector:  0.0 1.0 0.0\n"
        " Dz  2.5e7   eigenvector:  0.0 0.0 1.0\n"
    )
    n = 4
    top = pdbio.Topology(
        atom_names=["CA"] * n,
        res_seqs=np.arange(1, n + 1),
        res_names=["ALA"] * n,
        chain_ids=["A"] * n,
        occupancies=np.ones(n),
        elements=["C"] * n,
    )
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(2, n, 3))
    pdbio.write_pdb(str(tmp_path / "multi.pdb"), top, xyz)
    monkeypatch.chdir(tmp_path)
    hmain(["-f", "output.res", "--rotate", "-o", "rot.pdb"])
    _, out = pdbio.read_pdb(str(tmp_path / "rot.pdb"))
    assert out.shape == (2, n, 3)
    # Model 1 must NOT be all-zero and must be a rigid rotation of the
    # input about its own COG (here mat == identity-ordered frame, but
    # COG preservation is the invariant we can check independent of mat).
    assert np.abs(out[1]).max() > 1e-3
    np.testing.assert_allclose(out[1].mean(axis=0), xyz[1].mean(axis=0), atol=2e-3)


def test_ired_matrix_q_identity():
    """The vec(vv^T) collapsed form equals the direct P2 Gram matrix."""
    from spinrelax_tpu.ops.ired import _ired_matrix

    rng = np.random.default_rng(7)
    v = rng.normal(size=(50, 6, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    got = np.asarray(_ired_matrix(jnp.asarray(v)))
    dots = np.einsum("tik,tjk->tij", v, v)
    want = (1.5 * dots**2 - 0.5).mean(axis=0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_ired_single_block_nan_ds2():
    from spinrelax_tpu.ops.ired import calculate_s2_ired

    rng = np.random.default_rng(5)
    v = rng.normal(size=(40, 8, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # window_factor*tau = 40 frames -> exactly ONE block.
    res = calculate_s2_ired(v, delta_t=1.0, tau=8.0)
    assert np.all(np.isnan(np.asarray(res.dS2)))
    # tau=4 -> 20-frame windows -> two blocks -> finite spread.
    res2 = calculate_s2_ired(v, delta_t=1.0, tau=4.0)
    assert np.all(np.isfinite(np.asarray(res2.dS2)))


def test_bmrb_missing_frequency_raises():
    from spinrelax_tpu.io import nmrstar
    from spinrelax_tpu.io.bmrb import parse_bmrb_entry

    text = """data_test
save_T1_1
_Heteronucl_T1_list.Sf_category   heteronucl_T1_relaxation
save_
"""
    entry = nmrstar.parse(text)
    with pytest.raises(ValueError, match="Spectrometer_frequency_1H"):
        parse_bmrb_entry(entry, "pref")


def test_scalar_constants_are_python_floats():
    """fit.scalar module constants must not be jnp arrays: evaluating a
    jnp op at import time initialises the backend before callers can pin
    the platform."""
    from spinrelax_tpu.fit import scalar

    assert type(scalar._INVPHI) is float
    assert type(scalar._INVPHI2) is float


def test_host_stream_delegates_to_stream_accumulate():
    """host_stream and ct_palmer_streamed share ONE accumulation loop."""
    from spinrelax_tpu.ops.autocorr import ct_palmer_streamed, palmer_pooled_stats
    from spinrelax_tpu.parallel.ingest import host_stream

    rng = np.random.default_rng(9)
    chunks = [rng.normal(size=(2, 16, 3, 3)).astype(np.float32) for _ in range(3)]
    for c in chunks:
        c /= np.linalg.norm(c, axis=-1, keepdims=True)
    part = host_stream(iter(chunks), 16)
    mean, dCt = palmer_pooled_stats(
        jnp.asarray(part.acc_s), jnp.asarray(part.acc_s2), float(part.count)
    )
    m2, d2 = ct_palmer_streamed(iter(chunks), 16)
    np.testing.assert_allclose(np.asarray(mean.T), np.asarray(m2), atol=1e-7)
    with pytest.raises(ValueError, match="no chunks"):
        host_stream(iter([]), 16)


def _mini_pdb(tmp_path, chains):
    """chains: list of (chain_id, [resSeq, ...]) — one N + one H per residue."""
    lines, serial = [], 0
    for cid, seqs in chains:
        for rs in seqs:
            for nm, el in (("N", "N"), ("H", "H")):
                serial += 1
                lines.append(
                    f"ATOM  {serial:5d}  {nm:<3s} ALA {cid}{rs:4d}    "
                    f"{1.0:8.3f}{1.0:8.3f}{1.0:8.3f}  1.00  0.00"
                    f"           {el}"
                )
    fn = str(tmp_path / "mini.pdb")
    with open(fn, "w") as fp:
        fp.write("\n".join(lines) + "\nEND\n")
    return fn


def test_select_resid_is_zero_based_index(tmp_path):
    """'resid' must use mdtraj's 0-based internal residue index (the
    semantics reference selection strings are written in), 'resSeq' the
    PDB author numbering — previously both mapped to resSeq, silently
    shifting migrated 'resid i to j' selections."""
    from spinrelax_tpu.io import pdb as pdbio

    fn = _mini_pdb(tmp_path, [("A", [5, 6, 9])])  # indices 0,1,2
    top, _ = pdbio.read_pdb(fn)
    np.testing.assert_array_equal(top.res_indices, [0, 0, 1, 1, 2, 2])
    # resid 1 = SECOND residue (resSeq 6)
    sel = top.select("name N and resid 1")
    np.testing.assert_array_equal(top.res_seqs[sel], [6])
    sel = top.select("name N and resid 1 to 2")
    np.testing.assert_array_equal(top.res_seqs[sel], [6, 9])
    # resSeq keeps author numbering
    sel = top.select("name N and resSeq 6")
    np.testing.assert_array_equal(top.res_seqs[sel], [6])


def test_bond_indices_warns_on_duplicate_res_ids(tmp_path):
    """Homodimer chains with overlapping numbering pair correctly (keys
    are chain-aware) but must WARN: stage artefacts key by resSeq alone."""
    import warnings as _w

    from spinrelax_tpu.io import pdb as pdbio

    fn = _mini_pdb(tmp_path, [("A", [1, 2]), ("B", [1, 2])])
    top, _ = pdbio.read_pdb(fn)
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        idx_h, idx_x, res_h = pdbio.bond_indices(top)
    assert any("duplicate residue numbers" in str(r.message) for r in rec)
    np.testing.assert_array_equal(res_h, [1, 2, 1, 2])
    # Single chain: no warning.
    fn2 = _mini_pdb(tmp_path, [("A", [1, 2])])
    top2, _ = pdbio.read_pdb(fn2)
    with _w.catch_warnings(record=True) as rec2:
        _w.simplefilter("always")
        pdbio.bond_indices(top2)
    assert not rec2


def test_xvg_empty_and_mixed_dy_raise(tmp_path):
    """Header-only tables raise a named error (not 'too many indices');
    sets mixing with/without dy columns raise instead of silently
    broadcasting the wrong error bars (reference defect, SURVEY §2.7)."""
    from spinrelax_tpu.io import xvg

    empty = tmp_path / "empty.dat"
    empty.write_text("# header only\n@ legend\n")
    with pytest.raises(ValueError, match="no data rows"):
        xvg.load_xy(str(empty))

    mixed = tmp_path / "mixed.dat"
    mixed.write_text(
        '@ s0 legend "R 1"\n1 2 0.1\n2 3 0.2\n&\n'
        '@ s1 legend "R 2"\n1 4\n2 5\n&\n'
    )
    with pytest.raises(ValueError, match="dy column"):
        xvg.load_sxydylist(str(mixed))


def test_empty_fit_selection_raises(tmp_path):
    """A typo'd fit selection must raise, not hand an all-zero weight
    vector to the jitted orientation kernel (0/0 -> every quaternion and
    all downstream C(t)/S2 silently NaN)."""
    from spinrelax_tpu.pipeline import stages

    fn = _mini_pdb(tmp_path, [("A", [1, 2])])
    xyz = np.ones((3, 4, 3), np.float32)
    np.savez(tmp_path / "traj.npz", xyz=xyz, time=np.arange(3.0))
    with pytest.raises(ValueError, match="matches no atoms"):
        stages.stage_orientation(
            [str(tmp_path / "traj.npz")], fn,
            str(tmp_path / "colvar"), fit_sel="name CA1",
        )


def test_ctmodel_from_lists_dc_dtau_independent():
    """dC_list and dtau_list are independent: either alone must fill its
    own array (previously dC-only crashed under sort and dtau-only was
    silently dropped)."""
    from spinrelax_tpu.models import CtModelSet

    kw = dict(names=["1"], S2=[0.8], C_list=[[0.1, 0.05]],
              tau_list=[[200.0, 20.0]])
    only_dc = CtModelSet.from_lists(**kw, dC_list=[[0.01, 0.02]])
    np.testing.assert_allclose(np.asarray(only_dc.dC), [[0.02, 0.01]])
    assert only_dc.dtau is None
    only_dt = CtModelSet.from_lists(**kw, dtau_list=[[1.0, 2.0]])
    np.testing.assert_allclose(np.asarray(only_dt.dtau), [[2.0, 1.0]])
    assert only_dt.dC is None


def test_ctmodel_select_boolean_mask():
    """select() with a boolean mask must subset names consistently with
    the arrays (previously names were int()-indexed by the mask)."""
    from spinrelax_tpu.models import CtModelSet

    cts = CtModelSet.from_lists(
        names=["A", "B", "C"], S2=[0.1, 0.2, 0.3],
        C_list=[[0.5], [0.6], [0.7]], tau_list=[[10.0], [20.0], [30.0]],
    )
    sub = cts.select(np.array([True, False, True]))
    assert sub.names == ["A", "C"]
    np.testing.assert_allclose(np.asarray(sub.S2), [0.1, 0.3])


def test_charmm_ion_names_are_solvent():
    from spinrelax_tpu.ops.pbc import WATER_ION_RESNAMES

    for rn in ("SOD", "CLA", "POT", "CES", "CAL"):
        assert rn in WATER_ION_RESNAMES


def test_make_whole_restarts_per_molecule():
    """Molecule m's net whole-box correction must not translate
    molecule m+1 (segmented cumsum restart)."""
    import jax.numpy as jnp

    from spinrelax_tpu.ops.pbc import _make_whole_frame

    box = jnp.asarray([10.0, 10.0, 10.0])
    # mol 0: two atoms broken across the boundary (9.8 -> 0.2: the
    # second atom is imaged down by one box, net corr -10 on x).
    # mol 1: intact pair far from boundaries — must be untouched.
    xyz = jnp.asarray([
        [9.8, 5.0, 5.0], [0.2, 5.0, 5.0],
        [4.0, 4.0, 4.0], [4.2, 4.0, 4.0],
    ])
    mol_start = jnp.asarray([True, False, True, False])
    out = np.asarray(_make_whole_frame(xyz, box, mol_start))
    np.testing.assert_allclose(out[0], [9.8, 5.0, 5.0], atol=1e-6)
    np.testing.assert_allclose(out[1], [10.2, 5.0, 5.0], atol=1e-6)
    np.testing.assert_allclose(out[2:], np.asarray(xyz)[2:], atol=1e-6)


def test_trr_velocity_only_double_frame_keeps_sync(tmp_path):
    """Precision detection must follow GROMACS's x->v->f->box chain: a
    double-precision velocity-only frame (no x, no box) previously fell
    back to single-precision time/lambda reads and desynced the stream."""
    import struct

    from spinrelax_tpu.io import gmx

    natoms = 5
    rng = np.random.default_rng(2)
    xyz = rng.uniform(0, 3, (natoms, 3))

    def frame(x_size, v_size, box_size, payload):
        out = bytearray()
        out += struct.pack(">i", 1993)
        out += struct.pack(">i", 13)
        out += struct.pack(">i", 12) + b"GMX_trn_file"
        out += struct.pack(">13i", 0, 0, box_size, 0, 0, 0, 0,
                           x_size, v_size, 0, natoms, 0, 0)
        out += struct.pack(">2d", 1.0, 0.0)  # double time/lambda
        out += payload
        return bytes(out)

    # frame 1: velocities only (nstvout snapshot), double precision
    vel = struct.pack(f">{natoms*3}d", *(np.zeros(natoms * 3) + 0.25))
    f1 = frame(0, natoms * 3 * 8, 0, vel)
    # frame 2: normal coordinate frame, double precision
    box = np.diag([3.0, 3.0, 3.0])
    pay = struct.pack(">9d", *box.reshape(9))
    pay += struct.pack(f">{natoms*3}d", *xyz.reshape(-1))
    f2 = frame(natoms * 3 * 8, 0, 9 * 8, pay)

    fn = str(tmp_path / "vonly.trr")
    with open(fn, "wb") as fp:
        fp.write(f1 + f2)
    frames = list(gmx.iter_trr(fn))
    assert len(frames) == 1  # v-only frame skipped, not desynced
    np.testing.assert_allclose(frames[0][0], xyz.astype(np.float32), atol=1e-6)


def test_bmrb_atom_type_without_isotope_column(tmp_path):
    """A loop carrying Atom_type_1='C' but NO Atom_isotope_number column
    must use the element fallback (13C), not silently default to 15N."""
    from spinrelax_tpu.io import bmrb

    star = """data_test
save_T1_set
   _Heteronucl_T1_list.Sf_category heteronucl_T1_relaxation
   _Heteronucl_T1_list.Spectrometer_frequency_1H 600.13
   _Heteronucl_T1_list.T1_val_units s
   loop_
      _T1.Comp_index_ID
      _T1.Atom_type
      _T1.T1_val
      _T1.T1_val_err
      2 C 0.5 0.01
      3 C 0.4 0.01
   stop_
save_
"""
    fn = tmp_path / "entry.str"
    fn.write_text(star)
    bmrb.main(["-f", str(fn), "-o", str(tmp_path / "expt")])
    written = [p for p in (tmp_path).iterdir() if p.name.startswith("expt")]
    assert written, "no experiment file written"
    text = written[0].read_text()
    assert "13C" in text and "15N" not in text


def test_manifest_corrupt_is_stale(tmp_path):
    """An existing-but-unparseable manifest must force a re-run, not
    silently bless possibly-stale artefacts."""
    from spinrelax_tpu.pipeline import manifest

    pref = str(tmp_path / "run")
    inp = tmp_path / "in.dat"
    outp = tmp_path / "out.dat"
    inp.write_text("1\n")
    outp.write_text("2\n")
    manifest.record_stage(pref, "stage", [str(inp)], {})
    assert manifest.stage_is_current(pref, "stage", [str(inp)], [str(outp)], {})
    mf = manifest._manifest_path(pref)
    with open(mf, "w") as fp:
        fp.write("{not json")
    assert not manifest.stage_is_current(
        pref, "stage", [str(inp)], [str(outp)], {}
    )


def test_hydronmr_degenerate_oblate_ordering():
    """D = (2, 1, 2) (d1 < d0 == d2) must order via z90, not raise."""
    from spinrelax_tpu.io.hydronmr import reorder_axes

    D, mat = reorder_axes(np.array([2.0, 1.0, 2.0]), np.eye(3))
    np.testing.assert_allclose(D, [1.0, 2.0, 2.0])
    # z90 rotation applied
    assert not np.allclose(mat, np.eye(3))


def test_colvar_skip_rules_consistent(tmp_path):
    """'@' xvg-legend lines must be skipped by the numpy fallback and
    count_colvar_rows exactly like the native fast path, and a comment
    merely CONTAINING the word FIELDS is not a header."""
    from spinrelax_tpu.io import colvar as colvario
    from spinrelax_tpu.io import native

    fn = str(tmp_path / "c.colvar")
    with open(fn, "w") as fp:
        fp.write("#! FIELDS time q.w\n")
        fp.write("# note: FIELDS unchanged from previous run\n")
        fp.write('@ s0 legend "q.w"\n')
        fp.write("0.0 1.0\n1.0 0.9\n&\n")
    names, data = colvario.read_colvar(fn)
    assert names == ["time", "q.w"]
    assert data.shape == (2, 2)
    assert colvario.count_colvar_rows(fn) == 2
    if native.available():
        n = native.count_fields_headers(fn)
        assert n == 1  # annotation comment not counted


def test_dx_surplus_values_raise(tmp_path):
    from spinrelax_tpu.io import dx as dxio

    fn = str(tmp_path / "h.dx")
    data = np.arange(8.0).reshape(2, 2, 2)
    dxio.write_dx(fn, data, data.shape, np.zeros(3), np.eye(3))
    back, dims, orig, abc = dxio.read_dx(fn)  # footer tolerated
    np.testing.assert_allclose(back, data)
    # inject surplus numeric values before the footer
    lines = open(fn).read().splitlines()
    k = max(i for i, l in enumerate(lines)
            if l and l[0].isdigit() or l.startswith("-"))
    lines.insert(k + 1, "9 9 9")
    fn2 = str(tmp_path / "bad.dx")
    open(fn2, "w").write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="more data values"):
        dxio.read_dx(fn2)


def test_dx_truncated_data_raises(tmp_path):
    """A DX file cut off mid-data-section must raise, not return
    silently zero-padded densities."""
    from spinrelax_tpu.io import dx as dxio

    fn = str(tmp_path / "h.dx")
    data = np.arange(27.0).reshape(3, 3, 3)
    dxio.write_dx(fn, data, data.shape, np.zeros(3), np.eye(3))
    lines = open(fn).read().splitlines()
    follows = next(i for i, l in enumerate(lines) if "data follows" in l)
    # keep the header + only the first two data rows
    fn2 = str(tmp_path / "cut.dx")
    open(fn2, "w").write("\n".join(lines[: follows + 3]) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        dxio.read_dx(fn2)


def test_fastio_exact_page_long_token(tmp_path):
    """A table whose file size is an exact page multiple, ending in a
    >=32-char numeric token with no trailing newline, must parse (not
    walk strtod past the mapping)."""
    from spinrelax_tpu.io import native

    if not native.available():
        pytest.skip("no compiler for libfastio")
    val = "0." + "1" * 38  # 40-char token
    row = "3.5 " + val
    pad = 4096 - (len(row) % 4096)
    content = ("# " + "x" * (pad - 3) + "\n") + row if pad >= 4 else row
    # Re-pad exactly: comment line of length pad, then the row, no newline.
    content = "#" + "x" * (4096 - len(row) - 2) + "\n" + row
    fn = str(tmp_path / "page.dat")
    with open(fn, "w") as fp:
        fp.write(content)
    assert os.path.getsize(fn) % 4096 == 0
    table = native.load_table(fn, skip_chars="#@&")
    assert table is not None
    np.testing.assert_allclose(table[0, 0], 3.5)
    np.testing.assert_allclose(table[0, 1], float(val))


def test_sharded_rates_jit_diffusion_is_argument():
    """run_sharded_finish must treat Diffusion as a jit ARGUMENT: two
    calls with different Diso (fresh objects) share one compiled entry
    and return DIFFERENT rates (a closure-baked diffusion returned the
    first call's rates forever)."""
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.parallel import streamed
    from spinrelax_tpu.parallel.mesh import make_mesh
    from spinrelax_tpu.parallel.streamed import ShardedCtStream, run_sharded_finish

    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    n_frames, n_res = 32, 5
    # Smooth wobble around fixed directions -> S2 well above 0, so the
    # global Diso actually enters J (pure noise fits S2 ~ 0 and then any
    # Diso multiplies a zero amplitude).
    base = rng.normal(size=(1, 1, n_res, 3))
    v = base + 0.15 * rng.normal(size=(4, n_frames, n_res, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    stream = ShardedCtStream(mesh, n_frames, n_res, dtype=np.float64)
    stream.update(v)

    kw = dict(n_res=n_res, delta_t=1.0, names=[str(i) for i in range(n_res)])
    out1 = run_sharded_finish(
        mesh, *stream.accumulators(),
        diffusion=Diffusion.isotropic(diso=4e-5), **kw,
    )
    n_cache = len(streamed._JIT_CACHE)
    out2 = run_sharded_finish(
        mesh, *stream.accumulators(),
        diffusion=Diffusion.isotropic(diso=8e-5), **kw,
    )
    assert len(streamed._JIT_CACHE) == n_cache  # no new entry per object
    assert not np.allclose(out1.R1, out2.R1)  # new Diso actually used


def test_sharded_stream_ragged_group_keeps_shape_anchor():
    """A smaller final group must pad UP to the first-seen group size
    (one compiled shard_map shape), with exact statistics."""
    from spinrelax_tpu.ops.autocorr import ct_palmer
    from spinrelax_tpu.parallel.mesh import make_mesh
    from spinrelax_tpu.parallel.streamed import ShardedCtStream

    mesh = make_mesh(8)
    rng = np.random.default_rng(4)
    n_frames, n_res = 16, 3
    chunks = rng.normal(size=(9, n_frames, n_res, 3))
    chunks /= np.linalg.norm(chunks, axis=-1, keepdims=True)
    stream = ShardedCtStream(mesh, n_frames, n_res, dtype=np.float64)
    stream.update(chunks[:8])
    anchor = stream._g_canon
    stream.update(chunks[8:])  # g=1 -> padded to the anchor, not rep_dim
    assert stream._g_canon == anchor
    mean, dct = stream.finalize()
    ref_mean, ref_dct = ct_palmer(chunks)
    np.testing.assert_allclose(mean, np.asarray(ref_mean), rtol=1e-10)
    np.testing.assert_allclose(dct, np.asarray(ref_dct), rtol=1e-10)


def test_stream_update_program_is_shared():
    """stream_accumulate's fused update is cached at module level — two
    streams of the same shape must reuse ONE jitted program."""
    from spinrelax_tpu.ops.autocorr import _stream_update_jit

    assert _stream_update_jit(16, 8) is _stream_update_jit(16, 8)


def test_parse_diffusion_flavors():
    """-D parsing follows each reference front-end's own convention:
    relax 2-value = (Diso, Daniso); multifield 2-value = (Dpar, Dperp)
    converted like bConvert (spectral_densities.py:477); 3-value is the
    documented (Diso, Daniso, Drhomb)."""
    import argparse

    from spinrelax_tpu.pipeline.cli import (
        _dxyz_from_iso_aniso_rhomb, _parse_diffusion,
    )

    ns = argparse.Namespace(D="4.0e-5,3.0e-5", tau=None, aniso=None)
    d_relax = _parse_diffusion(ns, flavor="relax")
    assert d_relax.kind == "axisymmetric"
    np.testing.assert_allclose(float(d_relax.diso), 4.0e-5)
    np.testing.assert_allclose(float(d_relax.aniso), 3.0e-5)

    d_mf = _parse_diffusion(ns, flavor="multifield")
    # bConvert: Diso = (2*Dperp + Dpar)/3, aniso = Dpar/Dperp
    np.testing.assert_allclose(
        float(d_mf.diso), (2 * 3.0e-5 + 4.0e-5) / 3.0
    )
    np.testing.assert_allclose(float(d_mf.aniso), 4.0 / 3.0)

    # 3-value: (Diso, aniso, rhomb) -> Dxyz, exact inverse of the
    # reference's translate_D.
    dxyz = np.asarray(_dxyz_from_iso_aniso_rhomb(4.0e-5, 1.5, 0.4))
    np.testing.assert_allclose(np.mean(dxyz), 4.0e-5)
    np.testing.assert_allclose(2 * dxyz[2] / (dxyz[0] + dxyz[1]), 1.5)
    np.testing.assert_allclose(
        3 * (dxyz[1] - dxyz[0]) / (2 * dxyz[2] - dxyz[0] - dxyz[1]), 0.4
    )


def test_multifield_without_tumbling_exits_cleanly(tmp_path):
    from spinrelax_tpu.pipeline.cli import main

    ct = tmp_path / "f.dat"
    ct.write_text("# Residue: 1\n# Param S2_0: 0.8 +- 0.0\n")
    exp = tmp_path / "e.dat"
    exp.write_text("# Type R1\n1 1.0 0.1\n")
    with pytest.raises(SystemExit, match="tumbling"):
        main(["multifield", "-f", str(ct), str(exp)])


def test_center_npz_single_box_matrix(tmp_path):
    """A single (3,3) box matrix in an npz must broadcast to every frame
    (previously became a 1-frame box -> vmap crash), and npz timestep
    without a time array must survive into the output."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from spinrelax_tpu.pipeline.cli import main

    rng = np.random.default_rng(8)
    nf, na = 5, 8
    xyz = rng.uniform(0, 4, (nf, na, 3)).astype(np.float32)
    np.savez(tmp_path / "in.npz", xyz=xyz, box=np.diag([4.0, 4.0, 4.0]),
             timestep=10.0)
    lines = []
    for i in range(na):
        lines.append(
            f"ATOM  {i+1:5d}  C{i:<2d} ALA A{1:4d}    "
            f"{1.0:8.3f}{1.0:8.3f}{1.0:8.3f}  1.00  0.00           C"
        )
    (tmp_path / "top.pdb").write_text("\n".join(lines) + "\nEND\n")
    out = tmp_path / "out.npz"
    rc = main(["center", "-f", str(tmp_path / "in.npz"),
               "-s", str(tmp_path / "top.pdb"), "-o", str(out)])
    assert rc in (0, None)
    got = np.load(out)
    assert got["xyz"].shape == (nf, na, 3)
    np.testing.assert_allclose(float(got["timestep"]), 10.0)


def test_make_ref_frame_out_of_range(tmp_path):
    from spinrelax_tpu.pipeline.cli import main

    rng = np.random.default_rng(9)
    xyz = rng.uniform(0, 4, (3, 4, 3)).astype(np.float32)
    np.savez(tmp_path / "t.npz", xyz=xyz, time=np.arange(3.0))
    lines = [
        f"ATOM  {i+1:5d}  C{i:<2d} ALA A{1:4d}    "
        f"{1.0:8.3f}{1.0:8.3f}{1.0:8.3f}  1.00  0.00           C"
        for i in range(4)
    ]
    (tmp_path / "top.pdb").write_text("\n".join(lines) + "\nEND\n")
    with pytest.raises(SystemExit, match="out of range"):
        main(["make-ref", "-f", str(tmp_path / "t.npz"),
              "-s", str(tmp_path / "top.pdb"), "--frame", "500",
              "-o", str(tmp_path / "ref.pdb")])
