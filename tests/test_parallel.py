"""Multi-device sharding tests on the 8-device virtual CPU mesh, plus the
fused pipeline's numerical agreement with the staged path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spinrelax_tpu.parallel.mesh import make_mesh, vecs_sharding
from spinrelax_tpu.parallel.pipeline import make_forward, make_sharded_forward


def make_vecs(rng, n_rep=4, n_frames=64, n_res=8):
    # Smooth random walks so the fits see real decays.
    v = rng.normal(size=(n_rep, 1, n_res, 3))
    out = [v / np.linalg.norm(v, axis=-1, keepdims=True)]
    for _ in range(n_frames - 1):
        nxt = out[-1] + 0.12 * rng.normal(size=(n_rep, 1, n_res, 3))
        nxt /= np.linalg.norm(nxt, axis=-1, keepdims=True)
        out.append(nxt)
    return np.concatenate(out, axis=1)


def test_mesh_construction():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("rep", "res")
    # 8 -> (4, 2) balanced split
    assert sorted(mesh.devices.shape) == [2, 4]


def test_pipeline_single_device(rng):
    vecs = make_vecs(rng)
    fwd = jax.jit(make_forward(tau_iso=500.0))
    out = fwd(jnp.asarray(vecs))
    assert out.R1.shape == (8,)
    assert np.all(np.isfinite(np.asarray(out.R1)))
    assert np.all(np.asarray(out.S2) >= 0) and np.all(np.asarray(out.S2) <= 1)


def test_sharded_matches_single_device(rng):
    vecs = make_vecs(rng, n_rep=4, n_frames=64, n_res=8)
    fwd1 = jax.jit(make_forward(tau_iso=500.0))
    ref = fwd1(jnp.asarray(vecs))

    mesh = make_mesh(8)
    fwd8 = make_sharded_forward(mesh, tau_iso=500.0)
    vd = jax.device_put(jnp.asarray(vecs), vecs_sharding(mesh))
    out = fwd8(vd)
    np.testing.assert_allclose(np.asarray(out.Ct), np.asarray(ref.Ct), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(out.R1), np.asarray(ref.R1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out.NOE), np.asarray(ref.NOE), rtol=1e-6)


def test_streamed_sharded_matches_single_device(rng):
    """The PRODUCTION path: ShardedCtStream over the 8-device mesh with
    uneven groups and non-divisible residue count must equal single-device
    ct_palmer, and the sharded finish must equal the fused forward's
    rates."""
    from spinrelax_tpu.ops.autocorr import ct_palmer, ct_palmer_streamed
    from spinrelax_tpu.parallel.streamed import (
        ShardedCtStream, make_sharded_finish, run_streamed_pipeline,
    )

    vecs = make_vecs(rng, n_rep=10, n_frames=64, n_res=11)
    ref_ct, ref_dct = ct_palmer(jnp.asarray(vecs))

    mesh = make_mesh(8)
    groups = [vecs[:3], vecs[3:9], vecs[9:]]  # 3 + 6 + 1 chunks
    Ct, dCt = ct_palmer_streamed(iter(groups), 64, mesh=mesh)
    np.testing.assert_allclose(np.asarray(Ct), np.asarray(ref_ct), atol=1e-10)
    np.testing.assert_allclose(np.asarray(dCt), np.asarray(ref_dct), atol=1e-10)

    # Full streamed pipeline vs the fused single-device forward.
    out = run_streamed_pipeline(iter(groups), mesh, 64, 11, tau_iso=500.0)
    fwd = jax.jit(make_forward(tau_iso=500.0))
    ref = fwd(jnp.asarray(vecs))
    np.testing.assert_allclose(out.R1, np.asarray(ref.R1), rtol=1e-6)
    np.testing.assert_allclose(out.NOE, np.asarray(ref.NOE), rtol=1e-6)
    # S2 of these fast-decorrelating walks fits to ~0; compare absolutely.
    np.testing.assert_allclose(out.S2, np.asarray(ref.S2), atol=1e-6)


def test_ct_palmer_scan_mesh(rng):
    from spinrelax_tpu.ops.autocorr import ct_palmer, ct_palmer_scan

    vecs = make_vecs(rng, n_rep=8, n_frames=32, n_res=8)
    ref_ct, ref_dct = ct_palmer(jnp.asarray(vecs))
    mesh = make_mesh(8)
    Ct, dCt = ct_palmer_scan(jnp.asarray(vecs), batch=4, mesh=mesh)
    np.testing.assert_allclose(np.asarray(Ct), np.asarray(ref_ct), atol=1e-10)
    np.testing.assert_allclose(np.asarray(dCt), np.asarray(ref_dct), atol=1e-10)


def test_multihost_ingest_pools_to_single_host(rng):
    """Two simulated hosts each stream half the replicas; the pooled
    accumulators (host-side reduction AND the psum-expressed DCN
    reduction) must equal the single-host result exactly."""
    from spinrelax_tpu.ops.autocorr import ct_palmer
    from spinrelax_tpu.parallel.ingest import (
        host_stream, reduce_partials, reduce_partials_collective,
    )

    vecs = make_vecs(rng, n_rep=6, n_frames=32, n_res=5)
    ref_ct, ref_dct = ct_palmer(jnp.asarray(vecs))

    # Host A gets 4 chunks (in two groups), host B gets 2.
    pa = host_stream(iter([vecs[:2], vecs[2:4]]), 32)
    pb = host_stream(iter([vecs[4:]]), 32)
    Ct, dCt = reduce_partials([pa, pb])
    np.testing.assert_allclose(Ct, np.asarray(ref_ct), atol=1e-12)
    np.testing.assert_allclose(dCt, np.asarray(ref_dct), atol=1e-12)

    # Collective form needs one partial per "rep" row: 4-host mesh row.
    mesh = make_mesh(8)  # (4, 2): rep=4
    pc = host_stream(iter([vecs[0:1]]), 32)
    pd = host_stream(iter([vecs[1:3]]), 32)
    pe = host_stream(iter([vecs[3:5]]), 32)
    pf = host_stream(iter([vecs[5:]]), 32)
    Ct2, dCt2 = reduce_partials_collective([pc, pd, pe, pf], mesh)
    np.testing.assert_allclose(Ct2, np.asarray(ref_ct), atol=1e-12)
    np.testing.assert_allclose(dCt2, np.asarray(ref_dct), atol=1e-12)


def test_graft_entry_compiles():
    import importlib.util, os

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    compiled = jax.jit(fn).lower(*args).compile()
    out = compiled(*args)
    assert np.all(np.isfinite(np.asarray(out.R1)))
    # dryrun path (8 virtual devices already active in the test session)
    mod.dryrun_multichip(8)


def test_sharded_multifield_fit_matches_single_device(rng):
    """Residue-sharded multi-field fit (parallel/fit.shard_experiment_set)
    over the 8-device mesh: chi-square and the full one-dispatch device
    fit equal the unsharded results (GSPMD residue parallelism of the
    fit stage — SURVEY §3.5's memory/compute sink at >10^3 residues)."""
    from spinrelax_tpu.fit.globalfit import GlobalFitter, chisq_total
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.models.experiments import ExperimentSet
    from spinrelax_tpu.parallel.fit import shard_experiment_set
    from tests.test_globalfit import make_setup, synth_experiments

    # 11 residues: NOT divisible by 8 devices — exercises the padding.
    names, cts, diff, v, w = make_setup(rng, n_res=11, diso=4e-5, aniso=1.5)
    expts = synth_experiments(names, cts, diff, v, w)
    start = Diffusion.axisymmetric(diso=4.6e-5, aniso=1.3)
    es = ExperimentSet.build(expts, cts, start, vecs=v, weights=w)

    mesh = make_mesh(8)
    es_sh = shard_experiment_set(es, mesh)
    assert es_sh.n_residues % 8 == 0 and es_sh.n_residues >= 11

    csa = np.full(es.n_residues, -170e-6)
    csa_sh = np.full(es_sh.n_residues, -170e-6)
    c0 = float(chisq_total(es, 4.6e-5, 1.3, cts.zeta, jnp.asarray(csa)))
    c1 = float(
        chisq_total(es_sh, 4.6e-5, 1.3, cts.zeta, jnp.asarray(csa_sh))
    )
    np.testing.assert_allclose(c1, c0, rtol=1e-10)

    f_plain = GlobalFitter(es, ["Diso", "Daniso"]).run(method="device")
    f_shard = GlobalFitter(es_sh, ["Diso", "Daniso"]).run(method="device")
    np.testing.assert_allclose(f_shard.diso, f_plain.diso, rtol=1e-8)
    np.testing.assert_allclose(f_shard.aniso, f_plain.aniso, rtol=1e-8)
    np.testing.assert_allclose(f_shard.diso, 4e-5, rtol=1e-4)


def test_stream_step_shared_across_instances():
    """Two ShardedCtStream instances with the same (mesh, frames, dtype)
    must share ONE jitted step: stage_ct_streamed builds two streams per
    call (ext/int) and fresh ones per call — per-instance jits recompiled
    the identical shard_map program each time)."""
    from spinrelax_tpu.parallel.mesh import make_mesh
    from spinrelax_tpu.parallel.streamed import ShardedCtStream

    mesh = make_mesh(8)
    a = ShardedCtStream(mesh, 16, 9, dtype=np.float64)
    b = ShardedCtStream(mesh, 16, 9, dtype=np.float64)
    assert a._step is b._step
    c = ShardedCtStream(mesh, 32, 9, dtype=np.float64)
    assert c._step is not a._step  # different shapes = different program


def test_pad_and_shard_rejects_scalars():
    from spinrelax_tpu.parallel.mesh import make_mesh, pad_and_shard

    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="0-d"):
        pad_and_shard(mesh, [np.float64(1.7e-4)])


def test_fetch_single_process(rng):
    """parallel.mesh.fetch == np.asarray on every single-process form
    (host numpy, device array, mesh-sharded array) — the multi-process
    all-gather branch is pinned by test_multihost_process.py."""
    from spinrelax_tpu.parallel.mesh import fetch, make_mesh

    a = rng.normal(size=(16, 5))
    np.testing.assert_array_equal(fetch(a), a)
    np.testing.assert_array_equal(fetch(jnp.asarray(a)), a)
    mesh = make_mesh(8)
    sharded = jax.device_put(
        a, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(("rep", "res"), None))
    )
    assert sharded.is_fully_addressable  # single-process: asarray branch
    np.testing.assert_array_equal(fetch(sharded), a)


def test_flagship_finish_accepts_scalar_csa(rng):
    """predict_rates documents csa as None/scalar/(nRes,); the sharded
    wrapper must accept the scalar form too (it previously died with an
    opaque IndexError inside pad_and_shard)."""
    from spinrelax_tpu.parallel.mesh import make_mesh
    from spinrelax_tpu.parallel.streamed import (
        ShardedCtStream, run_sharded_finish,
    )
    from spinrelax_tpu.models import Diffusion

    mesh = make_mesh(8)
    n_frames, n_res = 16, 5
    chunks = rng.normal(size=(3, n_frames, n_res, 3))
    chunks /= np.linalg.norm(chunks, axis=-1, keepdims=True)
    stream = ShardedCtStream(mesh, n_frames, n_res, dtype=np.float64)
    stream.update(chunks)
    out = run_sharded_finish(
        mesh, *stream.accumulators(), n_res=n_res, delta_t=1.0,
        diffusion=Diffusion.isotropic(diso=4e-5), csa=np.float64(-1.7e-4),
    )
    assert np.all(np.isfinite(np.asarray(out.R1)))


def test_multifield_stage_devices_byte_identical(tmp_path, rng):
    """`spinrelax multifield --devices N` (stage_multifield(devices=N)):
    the residue-sharded optimisation must leave every exported artefact
    byte-identical to the single-device stage (VERDICT r2 #6 surface,
    extended from ct/run-all to the multifield fit)."""
    from spinrelax_tpu.core import geometry
    from spinrelax_tpu.io import fittedct as fctio
    from spinrelax_tpu.io import vectors as vecio
    from spinrelax_tpu.io.experiments import write_experiment
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.pipeline.stages import stage_multifield
    from tests.test_globalfit import make_setup, synth_experiments

    # 11 residues: NOT divisible by 8 -> exercises fit-side padding.
    names, cts, diff, v, w = make_setup(rng, n_res=11, diso=4e-5, aniso=1.5)
    vec_fn = str(tmp_path / "vecs.npz")
    hist, ep, ec = geometry.lambert_histogram(jnp.asarray(v.reshape(11, -1, 3)), 24, 12)
    vecio.save_histogram(vec_fn, names, np.asarray(hist), np.asarray(ep), np.asarray(ec))
    _, v_used, w_used = vecio.load_vector_distribution(vec_fn)

    expt_files = []
    for i, e in enumerate(synth_experiments(names, cts, diff, v_used, w_used)):
        fn = str(tmp_path / f"expt_{i}.dat")
        write_experiment(fn, e)
        expt_files.append(fn)
    fitted_fn = str(tmp_path / "in_fittedCt.dat")
    dt = np.arange(1.0, 50.0)
    fctio.write_fittedct(fitted_fn, cts, dt=dt, targets=np.asarray(cts.eval(dt)))

    start = Diffusion.axisymmetric(diso=4.6e-5, aniso=1.3)
    outs = {}
    for tag, ndev in (("plain", 0), ("mesh", 8)):
        pref = str(tmp_path / tag)
        final = stage_multifield(
            fitted_fn, expt_files, pref, start, vec_file=vec_fn,
            zeta=float(cts.zeta), opt_params=["Diso", "rsCSA"],
            max_cycles=4, method="device",
        ) if ndev == 0 else stage_multifield(
            fitted_fn, expt_files, pref, start, vec_file=vec_fn,
            zeta=float(cts.zeta), opt_params=["Diso", "rsCSA"],
            max_cycles=4, method="device", devices=8,
        )
        assert len(final["csa"]) == 11
        outs[tag] = sorted(p.name.split("_", 1)[1] for p in tmp_path.glob(tag + "_*"))
    assert outs["plain"] == outs["mesh"] and outs["plain"]

    for suffix in outs["plain"]:
        a = (tmp_path / f"plain_{suffix}").read_bytes()
        b = (tmp_path / f"mesh_{suffix}").read_bytes()
        assert a == b, f"artefact {suffix} differs between --devices 0 and 8"

    with pytest.raises(ValueError, match="devices"):
        stage_multifield(
            fitted_fn, expt_files, str(tmp_path / "bad"), start,
            vec_file=vec_fn, zeta=float(cts.zeta), devices=8,
        )


def test_fitct_cli_devices_byte_identical(tmp_path, rng):
    """`spinrelax fit-ct --devices N`: the residue-sharded DoF ladder
    must write a byte-identical _fittedCt.dat (completes the CLI mesh
    surface: ct/run-all/multifield already have it)."""
    from spinrelax_tpu.io import xvg
    from spinrelax_tpu.pipeline import cli

    # 11 residues (not divisible by 8 -> padding) with two-timescale
    # decays so the ladder actually walks past the first rung.
    dt = np.arange(0.0, 120.0, 2.0)
    n = 11
    tau1 = rng.uniform(3.0, 8.0, n)
    tau2 = rng.uniform(30.0, 60.0, n)
    s2 = rng.uniform(0.7, 0.85, n)
    c1 = rng.uniform(0.05, 0.12, n)
    y = (
        s2[:, None]
        + c1[:, None] * np.exp(-dt[None] / tau1[:, None])
        + (1.0 - s2 - c1)[:, None] * np.exp(-dt[None] / tau2[:, None])
    )
    y += rng.normal(0.0, 4e-4, y.shape)
    dy = np.full_like(y, 4e-4)
    names = [str(i + 1) for i in range(n)]
    ct_fn = str(tmp_path / "in_Ctint.dat")
    xvg.print_sxylist(ct_fn, names, dt, np.stack([y, dy], axis=-1))

    for tag, extra in (("one", []), ("mesh", ["--devices", "8"])):
        cli.cmd_fit_ct(["-f", ct_fn, "-o", str(tmp_path / tag)] + extra)
    a = (tmp_path / "one_fittedCt.dat").read_bytes()
    b = (tmp_path / "mesh_fittedCt.dat").read_bytes()
    assert a == b and a
