"""Workflow stages: pure functions with file artefacts at the boundaries.

Each stage mirrors one reference CLI script (SURVEY §2.3) but runs its
compute as jitted device code; the artefact formats are byte-compatible
with the reference so the two toolchains interoperate.  Stage resume
follows the reference's output-file-existence convention
(run-all.bash:322,382,475,487,509).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from ..constants import BOND_ISOTOPES, DEFAULT_ZETA, NucleusPair, field_from_mhz
from ..core import geometry
from ..core import quaternion as qt
from ..fit.expfit import fit_ct_ladder
from ..io import colvar as colvario
from ..io import fittedct as fctio
from ..io import pdb as pdbio
from ..io import trajectory as trajio
from ..io import vectors as vecio
from ..io import xvg
from ..models import CtModelSet, Diffusion
from ..ops import autocorr, dq as dqops, observables, orient

import jax

# Frame-axis contractions must not take a reduced-precision f32 default
# (TF32 on the GPU).
_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Stage 1: orientation quaternions (replaces GROMACS+PLUMED external step)
# ---------------------------------------------------------------------------


def _fit_weights(top, fit_sel: str) -> np.ndarray:
    """0/1 fit-weight vector for the orientation/superpose kernels.
    Raises on an empty selection: an all-zero weight vector makes the
    jitted weight normalisation 0/0, so every quaternion — and all
    downstream C(t)/S2 — would be silently NaN."""
    fit_idx = top.select(fit_sel)
    if len(fit_idx) == 0:
        raise ValueError(
            f"fit selection {fit_sel!r} matches no atoms — orientation "
            "fitting needs at least one reference atom"
        )
    w = np.zeros(top.n_atoms)
    w[fit_idx] = 1.0
    return w


def stage_orientation(
    traj_files: Sequence[str],
    ref_pdb: str,
    out_colvar: str,
    fit_sel: str = "occupancy > 0",
    force: bool = False,
    timestep: Optional[float] = None,
) -> str:
    """Compute q(t) of each trajectory vs the reference structure and write
    a PLUMED-format colvar (concatenated for multiple trajectories, as
    run-all.bash:366 does with `cat`).

    ``timestep`` overrides the frame spacing — REQUIRED for formats with
    no time axis (.pdb/.xyz/bare .npy/...): the colvar's time column is
    what `spinrelax dq` later reads delta_t from, so silently stamping
    1 ps here would mis-scale every downstream lag time and D tensor."""
    if os.path.exists(out_colvar) and not force:
        return out_colvar
    top, ref_xyz = pdbio.read_structure(ref_pdb)
    weights = _fit_weights(top, fit_sel)
    mode = "w"
    for fn in traj_files:
        if timestep is None and trajio.is_timeless(fn):
            raise ValueError(
                f"{fn!r}: this format carries no time axis — pass "
                "timestep explicitly (the colvar's time column defines "
                "the dq stage's delta_t)"
            )
        xyz, dt = trajio.load_trajectory(fn, top_fn=ref_pdb)
        if timestep is not None:
            dt = timestep
        q = np.asarray(
            orient.orientation_quats(
                jnp.asarray(xyz), jnp.asarray(ref_xyz[0]), jnp.asarray(weights)
            )
        )
        t = np.arange(q.shape[0]) * dt
        data = np.concatenate([t[:, None], q], axis=1)
        from ..io.zopen import topen

        with topen(out_colvar, mode) as fp:
            print("#! FIELDS time q.w q.x q.y q.z", file=fp)
        # One bulk write: per-frame Python formatting dominates the
        # stage at 10^6 frames.  The native buffered snprintf writer
        # produces the same "%16g"-joined rows as the reference's
        # PLUMED-style output; np.savetxt is the no-compiler fallback.
        from ..io import native as fastio

        if not fastio.write_table(out_colvar, data, append=True):
            with topen(out_colvar, "a") as fp:
                np.savetxt(fp, data, fmt="%16g", delimiter=" ")
        mode = "a"
    return out_colvar


# ---------------------------------------------------------------------------
# Stage 2: Delta-q -> D tensor (calculate-dq-distribution.py)
# ---------------------------------------------------------------------------


def _format_dq_headers(res: dqops.DqResult) -> Tuple[List[str], List[str]]:
    """Reproduce the reference's iso/aniso header formats exactly — the
    run-all driver greps Diso/Dani_L/Drho_L/Dani_S/Drho_S and the PAF
    quaternion out of them (run-all.bash:393,412-416;
    calculate-dq-distribution.py:221-275)."""
    has_chunks = res.iso_tau_chunks.size > 0

    def flex_bounds(x, samples):
        mean, sig = np.mean(samples), np.std(samples)
        return x, sig + x - mean, sig + mean - x

    iso_lines = []
    if has_chunks:
        b = flex_bounds(res.iso_tau, res.iso_tau_chunks)
        iso_lines.append("# model fit, tau = %e +- %e %e [ps]" % b)
        dvals = 0.5e12 / res.iso_tau_chunks
        b = flex_bounds(res.D_iso, dvals)
        iso_lines.append("# Converted D_iso = %e +- %e %e [s^-1]" % b)
        for i, d in enumerate(dvals):
            iso_lines.append("# Chunk_%d D_iso = %e [s^-1]" % (i, d))
    else:
        iso_lines.append("# model fit, tau = %e [ps]" % res.iso_tau)
        iso_lines.append("# Converted D_iso = %e [s^-1]" % res.D_iso)
    iso_lines.append("# t cos(th) P2[cos(th)] cos(th/2) th")

    aniso_lines = []
    Dval = res.D_axes
    if has_chunks:
        Dch = 0.5e12 / res.aniso_tau_chunks  # (nChunk, 3)
        for i in range(3):
            b = flex_bounds(res.aniso_taus[i], res.aniso_tau_chunks[:, i])
            aniso_lines.append("# model fit, e_%i tau = %e +- %e %e [ps]" % ((i,) + b[:3]))
            b = flex_bounds(Dval[i], Dch[:, i])
            aniso_lines.append("# Converted D_%i = %e +- %e %e [s^-1]" % ((i,) + b[:3]))
        if res.anis_chunk_samples is not None:
            anis = res.anisotropies
            anis_samp = res.anis_chunk_samples
        else:
            order = np.argsort(Dval)
            anis = dqops.calculate_anisotropies(jnp.asarray(np.sort(Dval)))
            anis_samp = np.stack(
                [
                    np.asarray(dqops.calculate_anisotropies(jnp.asarray(d[order])))
                    for d in Dch
                ]
            )
        errs = np.std(anis_samp, axis=0)
        labels = ["Diso", "Dani_L", "Drho_L", "Dani_S", "Drho_S"]
        fmts = ["# Converted %s = %e +- %e [s^-1]", "# Converted %s = %f +- %f",
                "# Converted %s = %f +- %f", "# Converted %s = %f +- %f",
                "# Converted %s = %f +- %f"]
        for lab, fmt, v, e in zip(labels, fmts, anis, errs):
            aniso_lines.append(fmt % (lab, float(np.asarray(v)), e))
        for j in range(Dch.shape[0]):
            for i in range(3):
                aniso_lines.append("# Chunk_%d D_%d = %e [s^-1]" % (j, i, Dch[j, i]))
    else:
        for i in range(3):
            aniso_lines.append("# model fit, e_%i tau = %e [ps]" % (i, res.aniso_taus[i]))
            aniso_lines.append("# Converted D_%i = %e [s^-1]" % (i, Dval[i]))
        anis = res.anisotropies
        aniso_lines.append("# Converted Diso = %e [s^-1]" % anis[0])
        aniso_lines.append("# Converted Dani_L = %f" % anis[1])
        aniso_lines.append("# Converted Drho_L = %f" % anis[2])
        aniso_lines.append("# Converted Dani_S = %f" % anis[3])
        aniso_lines.append("# Converted Drho_S = %f" % anis[4])
    aniso_lines.append("# t <1-2x^2> <1-2y^2> <1-2z^2>")
    aniso_lines.append(
        "# Quaternion orientation frame: %f %f %f %f" % tuple(res.q_frame)
    )
    return iso_lines, aniso_lines


def _print_graphs(fn, header, x, groups):
    """print_model_fits_gen equivalent
    (calculate-dq-distribution.py:277-328): groups is a list of 2D arrays
    (nPlots, nPts); one graph per group."""
    with open(fn, "w") as fp:
        for line in header:
            print(line, file=fp)
        if len(groups) == 1:
            s = 0
            for row in groups[0]:
                print("@target g0.s%d" % s, file=fp)
                for xi, yi in zip(x, row):
                    print("%g %g" % (xi, yi), file=fp)
                print("&", file=fp)
                s += 1
        else:
            for g in range(len(groups)):
                print("@g%d on" % g, file=fp)
            for g, grp in enumerate(groups):
                s = 0
                for row in grp:
                    print("@target g%d.s%d" % (g, s), file=fp)
                    for xi, yi in zip(x, row):
                        print("%g %g" % (xi, yi), file=fp)
                    print("&", file=fp)
                    s += 1
            print("@arrange(%i, %i, 0.1, 0.1, 0.1)" % (2, int(0.5 * len(groups) + 0.5)), file=fp)
            for i in range(len(groups)):
                print("@with g%i" % i, file=fp)
                if i == 0:
                    print('@subtitle "Aggregate Data"', file=fp)
                print("@autoscale", file=fp)


def stage_dq(
    colvar_file: str,
    out_prefix: str,
    min_dt: float,
    max_dt: float,
    skip_dt: float,
    n_chunks: int = 0,
    multi: bool = False,
    do_hist: bool = False,
    hist_bins: int = 101,
    hist_format: str = "dat",  # 'dx' | 'dat' | 'none'
    do_full_tensor: bool = False,
    force: bool = False,
    stream_chunk: int = 0,
    do_iso: bool = True,
    do_aniso: bool = True,
) -> dqops.DqResult:
    """Global tumbling analysis; writes {pref}-iso.dat, {pref}-aniso2.dat,
    {pref}-aniso_q.dat, {pref}-moi.xyz; optionally per-lag 3D delta-q
    histograms ({pref}-hist-<dt>ps.dx/.dat) and the full 3x3 tensor trace
    ({pref}-tensor.dat).

    stream_chunk > 0 enables the constant-memory streaming path: the
    colvar is read and analysed in blocks of that many frames.  Chunked
    uncertainties (n_chunks), per-lag histograms, the full-tensor trace
    AND multi-replica aggregates all work in this mode (single-colvar
    uncertainties add one cheap frame-counting pre-pass; the multi path
    needs none — whole-replica grouping pools per-replica sums).

    Resume lives in the orchestrator (runall.stage_is_current over the
    content-hash manifest) — this stage always computes; ``force`` is
    accepted for signature symmetry with the other stages.
    """

    def _load_q(fn):
        """(delta_t, q (N,4)) from a PLUMED colvar or a GROMACS
        ``gmx rotmat`` .xvg (rotation matrices -> INVERSE quaternions,
        calculate-dq-distribution.py:389-407,490-495)."""
        if fn.endswith((".xvg", ".xvg.gz")):
            t, ys = xvg.load_xys(fn)
            R = np.asarray(ys, dtype=np.float64).reshape(len(t), 3, 3)
            q = np.asarray(qt.qconj(qt.mat_to_quat(jnp.asarray(R))))
            return float(t[1] - t[0]), q
        fields, data = colvario.read_colvar(fn)
        return float(data[0, 1] - data[0, 0]), data[1:5].T.astype(np.float64)

    if stream_chunk > 0 and multi:
        # Constant-memory multi-replica path: the aggregate colvar (the
        # reference's run-all concatenates every replica's colvar,
        # run-all.bash:312-367) is precisely the input that outgrows RAM
        # first.  Replica boundaries = FIELDS headers, exactly like
        # read_colvar_multi; per-replica streamed sums pool like
        # analyse_dq_multi (whole-replica n_chunks grouping included).
        if colvar_file.endswith((".xvg", ".xvg.gz")):
            raise ValueError(
                "--multi reads aggregate PLUMED colvars; gmx-rotmat .xvg "
                "files are single-trajectory (no replica headers)"
            )
        if stream_chunk < 2:
            raise ValueError("--stream chunk size must be >= 2")
        it = colvario.iter_colvar_chunks_multi(colvar_file, stream_chunk)
        try:
            rep0, _fields0, first = next(it)
        except StopIteration:
            raise ValueError(f"{colvar_file!r}: no data rows") from None
        if first.shape[0] < 2:
            raise ValueError(
                f"{colvar_file!r}: need >= 2 data rows in the first "
                "replica block to infer the timestep"
            )
        delta_t = float(first[1, 0] - first[0, 0])

        def rep_chunks():
            yield rep0, first[:, 1:5]
            for rep, _f, block in it:
                yield rep, block[:, 1:5]

        res = dqops.analyse_dq_multi_streamed(
            rep_chunks(), delta_t, min_dt, max_dt, skip_dt,
            chunk_frames=stream_chunk, n_chunks=n_chunks,
        )
    elif stream_chunk > 0:
        n_total = None
        if colvar_file.endswith((".xvg", ".xvg.gz")):
            delta_t, q_all = _load_q(colvar_file)
            n_total = q_all.shape[0]

            def q_chunks():
                for off in range(0, q_all.shape[0], stream_chunk):
                    yield q_all[off : off + stream_chunk]
        else:
            if n_chunks > 0:
                # Sub-chunk uncertainties need the total length up front
                # (the reference's blocking is defined on it, calculate-
                # dq-distribution.py:128-144): one counting pre-pass at
                # I/O speed — no float parsing (the old pre-pass
                # loadtxt-parsed the whole file twice).
                n_total = colvario.count_colvar_rows(colvar_file)
            if stream_chunk < 2:
                # delta_t is inferred from the first block's first two
                # rows, and one-row chunks would make every lag span
                # block boundaries anyway.
                raise ValueError("--stream chunk size must be >= 2")
            it = colvario.iter_colvar_chunks(colvar_file, stream_chunk)
            try:
                fields0, first = next(it)
            except StopIteration:
                raise ValueError(f"{colvar_file!r}: no data rows") from None
            if first.shape[0] < 2:
                raise ValueError(
                    f"{colvar_file!r}: need >= 2 data rows to infer the "
                    "timestep"
                )
            delta_t = float(first[1, 0] - first[0, 0])

            def q_chunks():
                yield first[:, 1:5]
                for _, block in it:
                    yield block[:, 1:5]

        res = dqops.analyse_dq_streamed(
            q_chunks(), delta_t, min_dt, max_dt, skip_dt,
            chunk_frames=stream_chunk, n_chunks=n_chunks, n_total=n_total,
            hist_bins=(hist_bins if do_hist and hist_format != "none" else 0),
        )
    elif multi:
        fields, data = colvario.read_colvar_multi(colvar_file)
        # (nReplicas, nTime, nFields): analyse per replica then aggregate
        # delta-q samples — equivalent capability to
        # calculate-dq-distribution-multi.py (which as shipped crashes on
        # an import, SURVEY §2.7).  We concatenate replica trajectories as
        # independent segments by analysing each and averaging tensors.
        qs = [d[:, 1:5] for d in data]
        delta_t = float(data[0][1, 0] - data[0][0, 0])
        res = dqops.analyse_dq_multi(qs, delta_t, min_dt, max_dt, skip_dt, n_chunks)
    else:
        delta_t, q = _load_q(colvar_file)
        if q.shape[0] >= 200_000:
            # The lag-vmapped statistics program over 10^6-frame inputs
            # compiles the FIRST time a shape is seen; without a notice
            # the stage can look hung.  Later processes reuse the
            # persistent compile cache (utils/compile_cache).
            print(
                f"= = Analysing {q.shape[0]} frames: the first run of "
                "this shape compiles the statistics program; subsequent "
                "runs reuse the persistent compile cache.", flush=True,
            )
        res = dqops.analyse_dq(q, delta_t, min_dt, max_dt, skip_dt, n_chunks)

    iso_hdr, aniso_hdr = _format_dq_headers(res)
    x = res.lag_times
    if do_iso:
        # Fitted model curves ride along in DqResult (one packed device
        # fetch in _finalise_dq) — per-chunk eager evals each paid a
        # dispatch + fetch.
        if res.iso_models is not None:
            iso_curves = res.iso_models
        else:
            taus = np.concatenate([[res.iso_tau], res.iso_tau_chunks])
            iso_curves = np.asarray(
                dqops.isotropic_decay(jnp.asarray(x)[None, :],
                                      jnp.asarray(taus)[:, None])
            )
        groups = [np.stack([res.iso, iso_curves[0]])]
        for i in range(res.iso_chunks.shape[0] if res.iso_chunks.size else 0):
            groups.append(np.stack([res.iso_chunks[i], iso_curves[1 + i]]))
        _print_graphs(out_prefix + "-iso.dat", iso_hdr, x, groups)

    if do_aniso:
        if res.aniso_models is not None:
            aniso_curves = res.aniso_models
        else:
            taus = np.concatenate(
                [res.aniso_taus[None], res.aniso_tau_chunks], axis=0
            )
            aniso_curves = np.asarray(
                dqops.anisotropic_decay(jnp.asarray(x)[None, None, :],
                                        jnp.asarray(taus)[..., None])
            )
        groups = [np.concatenate([res.aniso, aniso_curves[0]])]
        for i in range(res.aniso_chunks.shape[0] if res.aniso_chunks.size else 0):
            groups.append(
                np.concatenate([res.aniso_chunks[i], aniso_curves[1 + i]])
            )
        _print_graphs(out_prefix + "-aniso2.dat", aniso_hdr, x, groups)

        # Per-lag PAF quaternions; first line carries the locked PAF, which
        # run-all extracts with `head -n 1 ... | awk '{print $2,$3,$4,$5}'`.
        xvg.print_xylist(out_prefix + "-aniso_q.dat", x, res.q_per_lag.T, cols=True)

        with open(out_prefix + "-moi.xyz", "w") as fp:
            for axes in res.axes_per_lag:
                print("3", file=fp)
                print("AXES", file=fp)
                for lab, row in zip("XYZ", axes):
                    print("%s %g %g %g" % (lab, row[0], row[1], row[2]), file=fp)

    if do_full_tensor and do_aniso and res.M is not None:
        # <(Rv)(Rv)^T> components per lag in the locked PAF
        # (calculate-dq-distribution.py:610-611,722-723).  The raw M per
        # lag is carried on DqResult, so this works identically for the
        # in-memory, streamed and multi-replica paths without a second
        # pass over the trajectory.
        R = np.asarray(qt.quat_to_mat(jnp.asarray(res.q_frame)))
        lags = np.rint(res.lag_times / delta_t).astype(int)
        MR = np.einsum("ab,lbc,dc->lad", R, np.asarray(res.M), R)
        xvg.print_xylist(
            out_prefix + "-tensor.dat", res.lag_times,
            MR.reshape(len(lags), 9).T, cols=True,
        )

    if do_hist and hist_format != "none" and not multi:
        from ..io import dx as dxio

        lags = np.rint(res.lag_times / delta_t).astype(int)
        hedges = tuple(np.linspace(-1.0, 1.0, hist_bins + 1) for _ in range(3))
        for li, delta in enumerate(lags):
            if res.hist is not None:
                # streamed: analyse_dq_streamed already density-normalised
                # the pooled counts (ops/dq.py) — do NOT normalise again.
                hist = res.hist[li]
            else:
                v = dqops.dq_vectors(np.asarray(q, dtype=np.float64), int(delta))
                hist, hedges = np.histogramdd(
                    v, bins=(hist_bins,) * 3, range=((-1, 1),) * 3, density=True
                )
            out_file = "%s-hist-%sps.%s" % (out_prefix, res.lag_times[li], hist_format)
            if hist_format == "dx":
                xmin = [0.5 * (e[0] + e[1]) for e in hedges]
                abc = np.diag([(e[-1] - e[0]) / hist_bins for e in hedges])
                dxio.write_dx(out_file, hist, (hist_bins,) * 3, xmin, abc, units="nm")
            else:
                xvg.print_gplot_hist(out_file, hist, hedges)
    return res


# ---------------------------------------------------------------------------
# Stage 3: trajectory -> C(t), S2, vector distributions
# (calculate-Ct-from-traj.py)
# ---------------------------------------------------------------------------


def stage_ct(
    traj_files: Sequence[str],
    ref_pdbs: Sequence[str],
    out_prefix: str,
    tau_memory: Optional[float],
    q_rot: Optional[np.ndarray] = None,
    h_sel: str = "name H",
    x_sel: str = "name N and not resname PRO",
    fit_sel: str = "occupancy > 0",
    zeta: float = DEFAULT_ZETA,
    do_ct: bool = True,
    do_s2: bool = True,
    s2_mode: str = "outer",  # outer | ired | wired
    do_vec_dist: bool = True,
    do_vec_avg: bool = True,
    vec_storage: str = "Histogram",  # Histogram | PhiTheta | TextPhiTheta
    hist_bins: int = 72,
    force: bool = False,
    timestep: Optional[float] = None,
):
    """Compute bond-vector statistics.  Writes {pref}_Ctext.dat,
    {pref}_Ctint.dat, {pref}_vecHistogram.npz / _vecPhiTheta.*,
    {pref}_avgvec.dat, {pref}_S2.dat.

    ``timestep`` overrides the frame spacing reported by the trajectory
    loader (for formats that carry no time axis)."""
    if len(ref_pdbs) == 1:
        ref_pdbs = list(ref_pdbs) * len(traj_files)

    res_ids = None
    delta_t = None
    vec_raw_list, vec_fit_list = [], []
    for trj_fn, ref_fn in zip(traj_files, ref_pdbs):
        top, ref_xyz = pdbio.read_structure(ref_fn)
        idx_h, idx_x, res_h = pdbio.bond_indices(top, h_sel, x_sel)
        w = _fit_weights(top, fit_sel)
        if timestep is None and trajio.is_timeless(trj_fn):
            raise ValueError(
                f"{trj_fn!r}: this format carries no time axis — pass "
                "timestep explicitly"
            )
        xyz, dt = trajio.load_trajectory(trj_fn, top_fn=ref_fn)
        if timestep is not None:
            dt = timestep
        # Host-reduced observables (NH diffs + 3x3 Horn correlations)
        # instead of shipping the full coordinate block to the device —
        # the same contract the streamed stage uses.
        raw_diff, S = orient.bond_obs_host(xyz, ref_xyz[0], idx_h, idx_x, w)
        bv = orient.bond_vectors_from_obs(
            jnp.asarray(raw_diff), jnp.asarray(S)
        )
        if res_ids is None:
            res_ids, delta_t = list(res_h), dt
        elif list(res_h) != res_ids or (
            # Relative tolerance, not exact equality: f32 timestamps of a
            # late-starting segment differ in the last ulp (same fix as
            # the streamed path below).
            abs(dt - delta_t) > 1e-9 * max(abs(dt), abs(delta_t))
        ):
            raise ValueError("trajectories disagree in residues or timestep")
        vec_raw_list.append(np.asarray(bv.raw))
        vec_fit_list.append(np.asarray(bv.fitted))

    if tau_memory is None:
        # No memory time (calculate-Ct-from-traj.py:509-514,643-644 /
        # calculate-S2.py:423-425,441-443): statistics run unblocked over
        # all frames; C(t) is refused at :358-360.
        if do_ct:
            raise ValueError(
                "C(t) analysis needs a memory time (tau_memory=None)"
            )
        vec_raw = np.concatenate(vec_raw_list, axis=0)[None]
        vec_fit = np.concatenate(vec_fit_list, axis=0)[None]
        dt_lags = None
    else:
        vec_raw = autocorr.reformat_by_tau(vec_raw_list, delta_t, tau_memory)
        vec_fit = autocorr.reformat_by_tau(vec_fit_list, delta_t, tau_memory)
        dt_lags = np.asarray(autocorr.lag_times(delta_t, tau_memory))

    out = {}
    if do_ct:
        Ct, dCt = autocorr.ct_palmer(jnp.asarray(vec_raw))
        xvg.print_sxylist(
            out_prefix + "_Ctext.dat", res_ids, dt_lags,
            np.stack([np.asarray(Ct).T, np.asarray(dCt).T], axis=-1),
        )
        Ct, dCt = autocorr.ct_palmer(jnp.asarray(vec_fit))
        xvg.print_sxylist(
            out_prefix + "_Ctint.dat", res_ids, dt_lags,
            np.stack([np.asarray(Ct).T, np.asarray(dCt).T], axis=-1),
        )
        out["Ct"] = np.asarray(Ct)
        out["dCt"] = np.asarray(dCt)

    # Flatten chunks for the remaining statistics
    flat = vec_fit.reshape(-1, vec_fit.shape[-2], vec_fit.shape[-1])
    if q_rot is not None:
        flat = np.asarray(
            qt.rotate_vector(jnp.asarray(flat), jnp.asarray(q_rot))
        )

    if do_vec_avg:
        avg = np.asarray(qt.vecnorm(jnp.asarray(np.mean(flat, axis=0))))
        xvg.print_xylist(out_prefix + "_avgvec.dat", res_ids, avg.T, cols=True)
        out["avgvec"] = avg

    if do_vec_dist:
        per_res = np.swapaxes(flat, 0, 1)  # (nRes, nFrames, 3)
        if vec_storage == "Histogram":
            hist, ep, ec = geometry.lambert_histogram(
                jnp.asarray(per_res), hist_bins, hist_bins // 2
            )
            vecio.save_histogram(
                out_prefix + "_vecHistogram.npz", res_ids,
                np.asarray(hist), np.asarray(ep), np.asarray(ec),
            )
            out["vec_file"] = out_prefix + "_vecHistogram.npz"
        elif vec_storage == "PhiTheta":
            pt = np.asarray(geometry.xyz_to_pt(jnp.asarray(per_res)))
            vecio.save_phitheta(out_prefix + "_vecPhiTheta.npz", res_ids, pt)
            out["vec_file"] = out_prefix + "_vecPhiTheta.npz"
        elif vec_storage == "TextPhiTheta":
            rtp = np.asarray(geometry.xyz_to_rtp(jnp.asarray(per_res)))
            fn = out_prefix + "_vecPhiTheta.dat"
            with open(fn, "w") as fp:
                for i, rid in enumerate(res_ids):
                    print('@s%d legend "%s"' % (i, rid), file=fp)
                    for j in range(rtp.shape[1]):
                        print("%g %g" % (rtp[i, j, 1], rtp[i, j, 2]), file=fp)
                    print("&", file=fp)
            out["vec_file"] = fn
        else:
            raise ValueError(f"unknown vec_storage {vec_storage!r}")

    if do_s2:
        if s2_mode == "outer":
            if tau_memory is None:
                # Unblocked S2, value only (calculate-S2.py:122-125,143).
                s2 = np.asarray(autocorr.s2_outer(jnp.asarray(flat)))
            else:
                s2 = np.asarray(
                    autocorr.s2_outer_blocked(
                        jnp.asarray(flat), delta_t, tau_memory
                    )
                )
        elif s2_mode in ("ired", "wired"):
            if tau_memory is None:
                raise ValueError("iRED/wiRED S2 needs a memory time")
            from ..ops import ired as iredops

            # iRED works on raw (lab-frame) vectors: the tumbling modes are
            # separated spectrally, no superposition needed.
            raw_flat = vec_raw.reshape(-1, vec_raw.shape[-2], vec_raw.shape[-1])
            tau_est = tau_memory / 10.0
            fn = (
                iredops.calculate_s2_ired
                if s2_mode == "ired"
                else iredops.calculate_s2_wired
            )
            res_i = fn(jnp.asarray(raw_flat), delta_t, tau_est)
            s2 = _ired_spectrum_artefact(out_prefix, res_i)
        else:
            raise ValueError(f"unknown s2_mode {s2_mode!r}")
        xvg.print_xylist(out_prefix + "_S2.dat", res_ids, (s2.T) * zeta, cols=True)
        out["S2"] = s2

    out["res_ids"] = res_ids
    out["delta_t"] = delta_t
    return out


def _ired_spectrum_artefact(out_prefix: str, res_i) -> np.ndarray:
    """Write {pref}_iREDspectrum.dat (block-mean eigenvalues, descending,
    with sqrt(n)-1 SEM; the reorientational 5-mode subspace leads) and
    return the (nRes, 2) [S2, dS2] array — shared by the in-memory and
    streamed C(t) stages."""
    s2 = np.stack([np.asarray(res_i.S2), np.asarray(res_i.dS2)], axis=-1)
    vals = np.asarray(res_i.eigenvalues)  # (nBlocks, nRes)
    lam = np.mean(vals, axis=0)
    dlam = np.std(vals, axis=0) / max(np.sqrt(vals.shape[0]) - 1.0, 1.0)
    xvg.print_xydy(
        out_prefix + "_iREDspectrum.dat",
        np.arange(1, lam.shape[0] + 1), lam, dlam,
        header="# iRED eigenmode spectrum (descending); "
               "modes 1-5 span global reorientation",
    )
    return s2


# ---------------------------------------------------------------------------
# Stage 4: C(t) -> fitted multi-exponential parameters
# (calculate-fitted-Ct.py)
# ---------------------------------------------------------------------------


def stage_fit_ct(
    ct_files: Sequence[str],
    out_prefix: str,
    n_components: Optional[int] = None,
    use_s2fast: bool = True,
    force: bool = False,
    optimiser: str = "lm",
    n_starts: int = 1,
    retry_starts: int = 8,
    mesh=None,
) -> CtModelSet:
    out_fn = out_prefix + "_fittedCt.dat"
    legs, dts, cts, dcts = xvg.load_sxydylist(ct_files[0], "legend")
    dt = np.asarray(dts)[0]
    decays = np.asarray(cts)
    ddecays = np.asarray(dcts) if len(dcts) else None
    if len(ct_files) > 1:
        # Replica averaging with error pooling
        # (calculate-fitted-Ct.py:113-147).
        all_ct, all_dct = [decays], [ddecays]
        for fn in ct_files[1:]:
            l2, d2, c2, e2 = xvg.load_sxydylist(fn, "legend")
            if l2 != legs or not np.allclose(np.asarray(d2)[0], dt):
                raise ValueError(f"{fn}: time/legend entries differ")
            all_ct.append(np.asarray(c2))
            all_dct.append(np.asarray(e2) if len(e2) else None)
        stack = np.stack(all_ct)
        decays = np.mean(stack, axis=0)
        if any(d is None for d in all_dct):
            ddecays = np.std(stack, axis=0)
        else:
            from ..core.stats import simple_total_mean_square

            ddecays = np.sqrt(
                np.asarray(
                    simple_total_mean_square(jnp.asarray(stack), jnp.asarray(np.stack(all_dct)))
                )
            )
        # Averaged-C(t) report artefact in the reference's INTENDED
        # format (calculate-fitted-Ct.py:140-147: bare float prints,
        # one '&' per leg) — intended because the reference's whole
        # multi-file path dies on the undefined `dt_prev` at :118
        # before ever reaching this write.
        with open(out_prefix + "_averageCt.dat", "w") as fp:
            for i in range(len(legs)):
                for j in range(decays.shape[1]):
                    print(dt[j], decays[i][j], ddecays[i][j], file=fp)
                print("&", file=fp)

    model = fit_ct_ladder(
        names=legs,
        dt=dt,
        decays=decays,
        ddecays=ddecays,
        use_s2fast=use_s2fast,
        n_components=n_components,
        optimiser=optimiser,
        n_starts=n_starts,
        retry_starts=retry_starts,
        mesh=mesh,
    )
    fctio.write_fittedct(out_fn, model, dt=dt, targets=decays)
    return model


# ---------------------------------------------------------------------------
# Stage 5: relaxation prediction / fitting (calculate-relaxations-from-Ct)
# ---------------------------------------------------------------------------


def stage_relax(
    fittedct_file: str,
    out_prefix: str,
    diffusion: Diffusion,
    vec_file: Optional[str] = None,
    q_rot: Optional[np.ndarray] = None,
    freq_mhz: float = 600.133,
    nuclei: str = "NH",
    time_unit: str = "ps",
    zeta: float = DEFAULT_ZETA,
    csa: Optional[np.ndarray] = None,
    jomega: bool = False,
    shift_res: int = 0,
    expt_file: Optional[str] = None,
    opt_mode: Optional[str] = None,
    max_cycles: int = 100,
    tol: float = 1e-6,
    opt_method: str = "powell",
    force: bool = False,
    vec_avg_file: Optional[str] = None,
    ref_pdb: Optional[str] = None,
    traj_file: Optional[str] = None,
    ref_hsel: str = "name H",
    ref_xsel: str = "name N and not resname PRO",
):
    """Predict R1/R2/NOE/rho (or J(w)) at one field; writes
    {pref}_R1.dat, _R2.dat, _NOE.dat, _rho.dat or _Jw.dat.

    Vector sources, in reference precedence
    (calculate-relaxations-from-Ct.py:636-656): ``vec_avg_file`` (-v,
    average X-H vectors as an xvg table), then ``vec_file`` (--distfn
    npz distribution), then ``ref_pdb`` [+ ``traj_file``] (vectors taken
    directly from structure/trajectory, no fitting).

    With ``expt_file`` + ``opt_mode``, first fits global parameters
    against a 3/6-column experimental table (legacy modes Diso / DisoS2 /
    DisoCSA / DisoS2CSA / new, calculate-relaxations-from-Ct.py:865-1000).
    """
    cts = fctio.read_fittedct(fittedct_file).with_zeta(zeta)
    iso_a = BOND_ISOTOPES[nuclei]
    pair = NucleusPair(
        isotope_a=iso_a, B0=field_from_mhz(freq_mhz), time_unit=time_unit
    )

    vecs = weights = None
    if diffusion.kind != "isotropic":
        names = None
        if vec_avg_file is not None:
            res_v, block = xvg.load_xys(vec_avg_file)
            names = [str(int(x) + shift_res) for x in res_v]
            vecs = np.asarray(block[:, :3], dtype=np.float64)
            vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)
        elif vec_file is not None:
            names, vecs, weights = vecio.load_vector_distribution(vec_file)
            names = [str(int(x) + shift_res) for x in names]
        elif ref_pdb is not None:
            # Vectors straight from the structure (no fitting); with a
            # trajectory, every frame contributes an ensemble sample
            # (reference's extract_vectors_from_structure, :44-69 — left
            # unreachable there by a bug referencing an undefined `ref`;
            # implemented as intended here).
            top, ref_xyz = pdbio.read_structure(ref_pdb)
            idx_h, idx_x, res_h = pdbio.bond_indices(top, ref_hsel, ref_xsel)
            if traj_file is not None:
                xyz, _ = trajio.load_trajectory(traj_file, top_fn=ref_pdb)
            else:
                xyz = ref_xyz
            v = xyz[:, idx_h, :] - xyz[:, idx_x, :]
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            names = [str(int(x) + shift_res) for x in res_h]
            vecs = v[0] if v.shape[0] == 1 else np.swapaxes(v, 0, 1)
        if vecs is not None:
            if names != cts.names:
                raise ValueError(
                    "resid mismatch between fittedCt and vector source"
                )
            if q_rot is not None:
                vecs = np.asarray(qt.rotate_vector(jnp.asarray(vecs), jnp.asarray(q_rot)))

    sim_resid = cts.names
    opt_header = ""
    if expt_file is not None and opt_mode is not None:
        from ..fit.legacyfit import fit_legacy

        exp_resid, expblock = xvg.load_xys(expt_file)
        exp_names = [str(int(x)) for x in exp_resid]
        ny = expblock.shape[1]
        if ny == 6:
            exp = expblock.reshape(len(exp_resid), 3, 2)[..., 0]
            exp_err = expblock.reshape(len(exp_resid), 3, 2)[..., 1]
        elif ny == 3:
            exp, exp_err = expblock, None
        else:
            raise ValueError(f"{expt_file}: expected 3 or 6 data columns")

        # Residue-intersection filtering
        # (calculate-relaxations-from-Ct.py:801-851).
        shared = [n for n in sim_resid if n in exp_names]
        if not shared:
            raise ValueError("no overlap between experimental and simulated residues")
        sim_idx = np.array([sim_resid.index(n) for n in shared])
        exp_idx = np.array([exp_names.index(n) for n in shared])
        f_cts = cts.select(sim_idx)
        f_vecs = None if vecs is None else vecs[sim_idx]
        f_weights = None if weights is None else weights[sim_idx]
        f_csa = None if csa is None else np.asarray(csa)[sim_idx]
        result = fit_legacy(
            opt_mode, pair, diffusion, f_cts,
            exp[exp_idx], None if exp_err is None else exp_err[exp_idx],
            vecs=f_vecs, weights=f_weights, csa0=f_csa,
            max_cycles=max_cycles, tol=tol, method=opt_method,
        )
        diffusion = diffusion.with_diso(result.diso)
        zeta_eff = zeta * result.s2_scale
        cts = cts.with_zeta(zeta_eff)
        if csa is None:
            csa = np.full(len(sim_resid), pair.csa_value)
        csa = np.asarray(csa, dtype=float).copy()
        csa[sim_idx] = result.csa
        if opt_mode == "new":
            xvg.print_xy(out_prefix + "_CSA_values.dat", sim_resid, csa)
        fitted_flags = dict(
            Diso=True,
            zeta="S2" in opt_mode,
            CSA="CSA" in opt_mode or opt_mode == "new",
        )
        lines = []
        for name, val, scale, unit, was_fit in (
            ("Diso", result.diso, 1.0, "ps^-1", fitted_flags["Diso"]),
            ("zeta", zeta_eff, 1.0, "a.u.", fitted_flags["zeta"]),
            ("CSA", float(np.mean(csa)), 1e6, "ppm", fitted_flags["CSA"]),
            ("chi", np.sqrt(result.chisq), 1.0, "a.u.", True),
        ):
            status = "Optimised" if was_fit else "Fixed"
            lines.append("# %s %s: %g %s" % (status, name, val * scale, unit))
        opt_header = "\n".join(lines)
        print(opt_header)

    if jomega:
        J, dJ = observables.predict_jomega(
            pair, diffusion, cts, vecs=vecs, weights=weights
        )
        omega = np.abs(np.asarray(pair.omega5()))
        order = np.argsort(omega)
        # ONE device fetch each — per-element J[i, j] reads would pay a
        # device-to-host transfer per value.
        J_np = np.asarray(J)
        dJ_np = None if dJ is None else np.asarray(dJ)
        with open(out_prefix + "_Jw.dat", "w") as fp:
            if dJ_np is not None:
                print("@type xydy", file=fp)
            for i, rid in enumerate(sim_resid):
                print('@s%d legend "Resid: %s"' % (i, rid), file=fp)
                for j in order:
                    if dJ_np is not None:
                        print("%g %g %g" % (omega[j], J_np[i, j], dJ_np[i, j]), file=fp)
                    else:
                        print("%g %g" % (omega[j], J_np[i, j]), file=fp)
                print("&", file=fp)
        return J

    rates = observables.predict_rates(
        pair, diffusion, cts, vecs=vecs, weights=weights, csa=csa
    )
    have_err = rates.dR1 is not None
    if have_err:
        xvg.print_xydy(out_prefix + "_R1.dat", sim_resid, np.asarray(rates.R1), np.asarray(rates.dR1), header=opt_header)
        xvg.print_xydy(out_prefix + "_R2.dat", sim_resid, np.asarray(rates.R2), np.asarray(rates.dR2), header=opt_header)
        xvg.print_xydy(out_prefix + "_NOE.dat", sim_resid, np.asarray(rates.NOE), np.asarray(rates.dNOE), header=opt_header)
        xvg.print_xydy(out_prefix + "_rho.dat", sim_resid, np.asarray(rates.rho), np.asarray(rates.drho))
    else:
        xvg.print_xy(out_prefix + "_R1.dat", sim_resid, np.asarray(rates.R1), header=opt_header)
        xvg.print_xy(out_prefix + "_R2.dat", sim_resid, np.asarray(rates.R2), header=opt_header)
        xvg.print_xy(out_prefix + "_NOE.dat", sim_resid, np.asarray(rates.NOE), header=opt_header)
        xvg.print_xy(out_prefix + "_rho.dat", sim_resid, np.asarray(rates.rho))
    return rates


def stage_relax_theoretical(
    diffusion: Diffusion,
    freq_mhz: float = 600.133,
    nuclei: str = "NH",
    zeta: float = DEFAULT_ZETA,
):
    """Rigid-baseline shortcut (--theoretical,
    calculate-relaxations-from-Ct.py:671-687): relaxation of a rigid body
    with no internal motion.  Isotropic -> one triple; axisymmetric ->
    per-axis triples for the three lab axes."""
    iso_a = BOND_ISOTOPES[nuclei]
    pair = NucleusPair(isotope_a=iso_a, B0=field_from_mhz(freq_mhz), time_unit="ps")
    if diffusion.kind == "isotropic":
        cts = CtModelSet.from_lists(["1"], [zeta], [[0.0]], [[99999.0]])
        rates = observables.predict_rates(pair, diffusion, cts)
    else:
        cts = CtModelSet.from_lists(
            ["1", "2", "3"], [zeta] * 3, [[0.0]] * 3, [[99999.0]] * 3
        )
        rates = observables.predict_rates(
            pair, diffusion, cts, vecs=np.eye(3)
        )
    return rates


# ---------------------------------------------------------------------------
# Stage 6: multi-field global fitting (calculate-relaxations-multi-field)
# ---------------------------------------------------------------------------


def stage_multifield(
    fittedct_file: str,
    expt_files: Sequence[str],
    out_prefix: str,
    diffusion: Diffusion,
    vec_file: Optional[str] = None,
    zeta: float = DEFAULT_ZETA,
    csa: Optional[np.ndarray] = None,
    opt_params: Optional[Sequence[str]] = None,
    max_cycles: int = 10,
    tol: float = 1e-6,
    method: str = "powell",
    include_expt: bool = False,
    ref_pdb: Optional[str] = None,
    devices: int = 0,
):
    """Fit global parameters against N experiments and export per-experiment
    xvg predictions (+ optimised CSA table when rsCSA is fitted).

    ``ref_pdb`` is the --refpdb alternative vector source (single X-H
    vector per residue straight from the structure,
    calculate-relaxations-multi-field.py:126-129).

    ``devices``: when > 0 the OPTIMISATION runs residue-sharded over a
    ``devices``-device mesh (parallel/fit.shard_experiment_set) — same
    numbers, GSPMD splits the per-residue work.  The final evaluation /
    export always runs on the unsharded set so artefacts stay
    byte-identical to the single-device stage."""
    from ..fit.globalfit import (
        EXPORT_SCALING,
        EXPORT_UNITS,
        ALLOWED_VARIABLES,
        GlobalFitter,
    )
    from ..io.experiments import read_experiment
    from ..models.experiments import ExperimentSet

    cts = fctio.read_fittedct(fittedct_file).with_zeta(zeta)
    vecs = weights = vec_names = None
    if vec_file is not None:
        vec_names, vecs, weights = vecio.load_vector_distribution(vec_file)
    elif ref_pdb is not None:
        top, ref_xyz = pdbio.read_structure(ref_pdb)
        idx_h, idx_x, res_h = pdbio.bond_indices(top)
        v = ref_xyz[0, idx_h, :] - ref_xyz[0, idx_x, :]
        vecs = v / np.linalg.norm(v, axis=-1, keepdims=True)
        vec_names = np.asarray(res_h)
    expts = [read_experiment(f) for f in expt_files]
    es = ExperimentSet.build(
        expts, cts, diffusion, vecs=vecs, weights=weights,
        vec_names=vec_names, csa=csa,
    )

    fitter = None
    if devices and not opt_params:
        raise ValueError(
            "devices/--devices shards the optimisation: it requires "
            "opt_params/--opt (the plain evaluation is a single cheap "
            "dispatch)"
        )
    if opt_params:
        es_fit = es
        if devices:
            from ..parallel.fit import shard_experiment_set
            from ..parallel.mesh import make_mesh

            es_fit = shard_experiment_set(es, make_mesh(int(devices)))
        fitter = GlobalFitter(es_fit, list(opt_params))
        state = fitter.run(max_cycles=max_cycles, tol=tol, method=method)
        final = dict(
            diso=state.diso, aniso=state.aniso, zeta=state.zeta,
            # padded residues (mask 0 everywhere) ride along in the
            # sharded fit; drop them before export.
            csa=np.asarray(state.csa)[: es.n_residues],
            chisq=state.chisq,
        )
    else:
        csa0 = es.csa
        if csa0 is None:
            csa0 = np.full(es.n_residues, es.experiments[0].pair.csa_value)
        final = dict(
            diso=float(np.asarray(diffusion.diso)),
            aniso=float(np.asarray(diffusion.aniso)),
            zeta=float(np.asarray(cts.zeta)),
            csa=np.asarray(csa0),
            chisq=None,
        )

    # Evaluate predictions at the final parameters and export per
    # experiment (export_xvg, spectral_densities.py:1178-1194).
    from ..fit.globalfit import _eval_all

    preds = _eval_all(
        es, final["diso"], final["aniso"], final["zeta"], jnp.asarray(final["csa"])
    )
    opt_list = list(opt_params) if opt_params else []
    for e, (v, dv) in zip(es.experiments, preds):
        mhz = round(e.pair.B0 * 267.513 / (2.0 * np.pi))
        suffix = "_%s%s_%iMHz_%s" % (
            e.pair.isotope_a, e.pair.isotope_b, mhz, e.expt_type,
        )
        fn = "%s%s.xvg" % (out_prefix, suffix)
        with open(fn, "w") as fp:
            print("# Type %s" % e.expt_type, file=fp)
            print("# NucleiA %s" % e.pair.isotope_a, file=fp)
            print("# NucleiB %s" % e.pair.isotope_b, file=fp)
            print("# Frequency %g %s" % (e.pair.B0 * 267.513 / (2 * np.pi), "MHz"), file=fp)
            for name in ("Diso", "Daniso", "zeta", "CSA"):
                val = {
                    "Diso": final["diso"],
                    "Daniso": final["aniso"],
                    "zeta": final["zeta"],
                    "CSA": float(np.mean(final["csa"])),
                }[name]
                status = "Optimised" if name in opt_list else "Fixed"
                if name == "CSA" and "rsCSA" in opt_list:
                    status = "OptimisedMean"
                print(
                    "# %s %s: %g %s"
                    % (status, name, val * EXPORT_SCALING[name], EXPORT_UNITS[name]),
                    file=fp,
                )
            if final["chisq"] is not None:
                print("# Optimised chi: %g a.u." % np.sqrt(final["chisq"]), file=fp)
            print("", file=fp)
            print("@target s0", file=fp)
            va = np.asarray(v)
            if dv is not None:
                print("@type xydy", file=fp)
                dva = np.asarray(dv)
                for n, (yy, ee) in zip(cts.names, zip(va, dva)):
                    print("%s %g %g" % (n, yy, ee), file=fp)
            else:
                print("@type xy", file=fp)
                for n, yy in zip(cts.names, va):
                    print("%s %g" % (n, yy), file=fp)
            print("&", file=fp)
            if include_expt and e.raw is not None:
                print("@target s1", file=fp)
                d = e.raw
                if d.errors is not None:
                    print("@type xydy", file=fp)
                    for n, yy, ee in zip(d.names, d.values, d.errors):
                        print("%s %g %g" % (n, yy, ee), file=fp)
                    print("&", file=fp)
                else:
                    print("@type xy", file=fp)
                    for n, yy in zip(d.names, d.values):
                        print("%s %g" % (n, yy), file=fp)
                    print("&", file=fp)

    if opt_params and "rsCSA" in opt_list:
        xvg.print_xy(out_prefix + "_CSA_opt.dat", cts.names, final["csa"])
    return final


# ---------------------------------------------------------------------------
# Streaming variant of stage 3 for larger-than-memory trajectories
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _streamed_update_program(fpc, do_ct_here, do_s2, do_vec_avg,
                             do_vec_dist, vec_storage, hist_nb_x,
                             hist_nb_y):
    """ONE jitted per-group program for :func:`stage_ct_streamed`: C(t)
    ACF + Palmer stats + S2 blocks + average vector + Lambert histogram
    all update DEVICE-resident accumulators in a single dispatch — and the
    histogram pools on device in int32 instead of paying a device->host
    fetch per group (spilled to the int64 host total before overflow, see
    _spill_hist).

    Module-level lru_cache so repeated stage calls with the same static
    config reuse ONE jit cache (a per-call closure would recompile the
    whole program on every invocation — run-all with several
    trajectories / library loops paid it each time).  The cache is
    bounded — each entry pins compiled executables and trace constants
    for the process lifetime."""

    @jax.jit
    def _fused_update(vec_raw_g, vec_fit_g, w_g, q_rot_j, acc_in):
        # w_g: (g,) 1.0 for real chunks, 0.0 for the zero-padded tail
        # chunks of a partial final group — padding keeps ONE compiled
        # program for every group (a changed g would recompile the whole
        # fused program; same zero-weight trick as ShardedCtStream).
        g = vec_raw_g.shape[0]
        n_deltas = fpc // 2
        n_vals = fpc - jnp.arange(1, n_deltas + 1, dtype=vec_raw_g.dtype)
        out = dict(acc_in)
        extras = {}

        if do_ct_here:
            for key, vv in (("ext", vec_raw_g), ("int", vec_fit_g)):
                s = autocorr._acf_sums(jnp.swapaxes(vv, 1, 2), n_deltas)
                # palmer_pooled_stats convention: e = per - 1, e**2.
                e = -1.5 + 1.5 * s / n_vals  # (g, nBonds, nDeltas)
                w = w_g[:, None, None]
                out[f"ct_{key}_s"] = acc_in[f"ct_{key}_s"] + jnp.sum(
                    w * e, axis=0
                )
                out[f"ct_{key}_s2"] = acc_in[f"ct_{key}_s2"] + jnp.sum(
                    w * e**2, axis=0
                )

        flat = vec_fit_g.reshape(-1, vec_fit_g.shape[-2], 3)
        if q_rot_j is not None:
            flat = qt.rotate_vector(flat, q_rot_j)
        wf = jnp.repeat(w_g, fpc)  # per-frame weights

        if do_s2:
            blocks = flat.reshape(g, fpc, flat.shape[-2], 3)
            outer = jnp.einsum("ijkl,ijkm->iklm", blocks, blocks,
                               precision=_HI) / fpc
            # palmer_pooled_stats convention: e = S2_block - 1, e**2.
            e2b = 1.5 * jnp.sum(outer**2, axis=(-2, -1)) - 1.5  # (g, nBonds)
            out["s2_s"] = acc_in["s2_s"] + jnp.sum(w_g[:, None] * e2b, axis=0)
            out["s2_s2"] = acc_in["s2_s2"] + jnp.sum(
                w_g[:, None] * e2b**2, axis=0
            )

        if do_vec_avg:
            out["vec_sum"] = acc_in["vec_sum"] + jnp.sum(
                wf[:, None, None] * flat, axis=0
            )

        if do_vec_dist:
            if vec_storage == "Histogram":
                per_res = jnp.swapaxes(flat, 0, 1)  # (nBonds, frames, 3)
                h, ep, ec = geometry.lambert_histogram(
                    per_res, hist_nb_x, hist_nb_y, valid=(wf > 0)[None, :]
                )
                out["hist"] = acc_in["hist"] + jnp.asarray(h, jnp.int32)
                extras["edges"] = (ep, ec)
            else:
                extras["pt"] = geometry.xyz_to_pt(flat)
        return out, extras

    return _fused_update


def stage_ct_streamed(
    traj_files: Sequence[str],
    ref_pdbs: Sequence[str],
    out_prefix: str,
    tau_memory: float,
    chunk_groups: int = 4,
    timestep: Optional[float] = None,
    q_rot: Optional[np.ndarray] = None,
    h_sel: str = "name H",
    x_sel: str = "name N and not resname PRO",
    fit_sel: str = "occupancy > 0",
    zeta: float = DEFAULT_ZETA,
    do_ct: bool = True,
    do_s2: bool = True,
    s2_mode: str = "outer",  # outer | ired | wired
    do_vec_dist: bool = True,
    do_vec_avg: bool = True,
    vec_storage: str = "Histogram",
    hist_bins: int = 72,
    mesh=None,
):
    """Streaming equivalent of :func:`stage_ct`: trajectories are consumed
    in groups of Palmer chunks (``chunk_groups`` chunks of tau_memory each
    per device step) with running accumulators for C(t), S2, the average
    vector and the Lambert histograms — the full trajectory never exists
    in host or device memory.  Replaces the reference's ``--split`` memory
    workaround (calculate-Ct-from-traj.py:426-453) with true streaming.

    ``timestep`` is required for bare .npy inputs (no time axis).

    ``mesh``: optional ("rep", "res") jax.sharding.Mesh — the C(t)
    accumulation (the dominant cost) then runs through the sharded
    shard_map group step of :class:`parallel.streamed.ShardedCtStream`
    (chunks over "rep", bonds over "res", one psum, NCCL over NVLink), producing
    identical statistics; the remaining light accumulators (S2,
    histograms, average vector) stay single-device.
    """
    if len(ref_pdbs) == 1:
        ref_pdbs = list(ref_pdbs) * len(traj_files)

    res_ids = None
    delta_t = None
    fpc = None  # frames per Palmer chunk
    acc = {}
    ct_streams = {}
    n_chunks_total = 0
    q_rot_j = None if q_rot is None else jnp.asarray(q_rot)
    pt_writer = None  # lazy PhiTheta stream writer (storage != Histogram)

    hist_nb_x, hist_nb_y = hist_bins, hist_bins // 2

    # The fused per-group program comes from a MODULE-LEVEL lru_cache
    # keyed on the static config (_streamed_update_program): defining the
    # jit inside this function would give every stage_ct_streamed call a
    # fresh jit cache, recompiling the whole program per call.  The program
    # is fetched lazily once fpc is known (first trajectory's timestep).
    do_ct_here = bool(do_ct and mesh is None)
    if s2_mode not in ("outer", "ired", "wired"):
        raise ValueError(f"unknown s2_mode {s2_mode!r}")
    # iRED/wiRED S2 bypasses the fused outer-product accumulators: the
    # eigenmode statistics stream through their own per-block
    # (nRes, nRes) accumulator (ops.ired.IredStream).
    do_s2_outer = bool(do_s2 and s2_mode == "outer")
    ired_stream = None

    def _get_fused_update():
        return _streamed_update_program(
            fpc, do_ct_here, do_s2_outer, bool(do_vec_avg),
            bool(do_vec_dist), vec_storage, hist_nb_x, hist_nb_y,
        )

    def _init_accs(n_bonds, dtype):
        n_deltas = fpc // 2
        z = {}
        if do_ct_here:
            for key in ("ext", "int"):
                z[f"ct_{key}_s"] = jnp.zeros((n_bonds, n_deltas), dtype)
                z[f"ct_{key}_s2"] = jnp.zeros((n_bonds, n_deltas), dtype)
        if do_s2_outer:
            z["s2_s"] = jnp.zeros((n_bonds,), dtype)
            z["s2_s2"] = jnp.zeros((n_bonds,), dtype)
        if do_vec_avg:
            z["vec_sum"] = jnp.zeros((n_bonds, 3), dtype)
        if do_vec_dist and vec_storage == "Histogram":
            z["hist"] = jnp.zeros(
                (n_bonds, hist_nb_x, hist_nb_y), jnp.int32
            )
        return z

    def _spill_hist():
        """Fold the int32 device histogram into the int64 host total and
        zero the device accumulator (a >RAM stream can exceed int32; the
        worst case is every frame of one bond in one bin, so spilling
        while frames-since-spill < 2^31 is always safe)."""
        nonlocal hist_host
        if "hist" in acc:
            h = np.asarray(acc["hist"], dtype=np.int64)
            hist_host = h if hist_host is None else hist_host + h
            acc["hist"] = jnp.zeros_like(acc["hist"])

    hist_host = None
    hist_edges = None  # host-side: NOT in acc — acc is the jit pytree,
    # and growing it after group 1 would retrace the fused program.
    frames_since_spill = 0

    def _accumulate(vec_raw_g, vec_fit_g):
        """vec_*_g: (g, fpc, nBonds, 3) device arrays for one group."""
        nonlocal n_chunks_total, pt_writer, frames_since_spill, hist_edges
        nonlocal ired_stream
        g = vec_raw_g.shape[0]

        if do_s2 and s2_mode in ("ired", "wired"):
            # Lab-frame (un-superposed) vectors, exactly like the
            # in-memory stage: iRED separates tumbling spectrally.
            if ired_stream is None:
                from ..ops.ired import IredStream

                wf = 5.0 if s2_mode == "ired" else 2.0
                W = max(int(wf * (tau_memory / 10.0) / delta_t), 2)
                ired_stream = IredStream(vec_raw_g.shape[2], W)
            ired_stream.update(
                vec_raw_g.reshape(-1, vec_raw_g.shape[2], 3)
            )

        if do_ct and mesh is not None:
            for key, vv in (("ext", vec_raw_g), ("int", vec_fit_g)):
                st = ct_streams.get(key)
                if st is None:
                    from ..parallel.streamed import ShardedCtStream

                    st = ct_streams[key] = ShardedCtStream(
                        mesh, fpc, vv.shape[2], dtype=vv.dtype
                    )
                st.update(vv)

        if not acc:
            acc.update(_init_accs(vec_raw_g.shape[2], vec_raw_g.dtype))
        # Zero-pad a partial final group to the fixed group size so the
        # fused program never recompiles; padded chunks carry weight 0.
        g_pad = chunk_groups - g
        if g_pad > 0:
            z = jnp.zeros((g_pad,) + vec_raw_g.shape[1:], vec_raw_g.dtype)
            vec_raw_g = jnp.concatenate([vec_raw_g, z], axis=0)
            vec_fit_g = jnp.concatenate([vec_fit_g, z], axis=0)
        w_g = jnp.asarray(
            np.concatenate([np.ones(g), np.zeros(max(g_pad, 0))]),
            dtype=vec_raw_g.dtype,
        )
        new_acc, extras = _get_fused_update()(
            vec_raw_g, vec_fit_g, w_g, q_rot_j, dict(acc)
        )
        acc.update(new_acc)
        if "edges" in extras and hist_edges is None:
            ep, ec = extras["edges"]
            hist_edges = (np.asarray(ep), np.asarray(ec))
        if "pt" in extras:
            if pt_writer is None:
                if vec_storage == "PhiTheta":
                    pt_writer = vecio.PhiThetaStreamWriter(
                        out_prefix + "_vecPhiTheta.npz", res_ids, fmt="npz"
                    )
                elif vec_storage == "TextPhiTheta":
                    pt_writer = vecio.PhiThetaStreamWriter(
                        out_prefix + "_vecPhiTheta.dat", res_ids, fmt="text"
                    )
                else:
                    raise ValueError(f"unknown vec_storage {vec_storage!r}")
            # Slice off the zero-padded tail frames before writing.
            pt_writer.append(np.asarray(extras["pt"])[: g * fpc])
        frames_since_spill += g * fpc
        if frames_since_spill > 2**31 - 2**24:
            _spill_hist()
            frames_since_spill = 0
        n_chunks_total += g

    for trj_fn, ref_fn in zip(traj_files, ref_pdbs):
        top, ref_xyz = pdbio.read_structure(ref_fn)
        idx_h, idx_x, res_h = pdbio.bond_indices(top, h_sel, x_sel)
        w = _fit_weights(top, fit_sel)
        ref0 = ref_xyz[0]

        if timestep is None and trajio.is_timeless(trj_fn):
            # No time axis in the file: iter_trajectory would echo a
            # silent 1.0 ps back, mis-scaling fpc and every lag time.
            raise ValueError(
                f"{trj_fn!r}: this format carries no time axis — pass "
                "timestep explicitly"
            )
        # Probe the timestep with a single-frame read (each iter_trajectory
        # call restarts the file, so the probe consumes nothing).
        _, dt = next(
            trajio.iter_trajectory(
                trj_fn, chunk_frames=1, top_fn=ref_fn, timestep=timestep or 1.0
            )
        )
        if delta_t is None:
            delta_t = dt if timestep is None else timestep
            fpc = int(tau_memory / delta_t)
            if res_ids is None:
                res_ids = list(res_h)
        elif list(res_h) != res_ids or (
            timestep is None and abs(dt - delta_t) > 1e-9 * max(dt, delta_t)
        ):
            raise ValueError(
                "trajectories disagree in residues or timestep"
            )

        group_frames = fpc * chunk_groups

        def _obs_chunks():
            """Stream (raw_diff, S) group observables.  Plain .xtc input
            with the fused native reader routes the bond_obs reduction
            INTO the decoder (io.native.iter_xtc_obs): the full
            (F, nAtoms, 3) coordinate block never materialises, which
            saves a full single-core numpy pass over the coordinates
            and the cache pressure of pushing the whole trajectory
            through RAM.  Everything else decodes full
            chunks and reduces via bond_obs_host (identical contract).
            """
            from ..io import native as natio

            if trj_fn.endswith(".xtc") and natio.xtc_obs_available():
                A = orient.bond_obs_matrix(ref0, w)
                for raw_diff, S, _times in natio.iter_xtc_obs(
                    trj_fn, group_frames, idx_h, idx_x, A, threads=0,
                ):
                    yield raw_diff, S
                return
            for xyz_chunk, _ in trajio.iter_trajectory(
                trj_fn, chunk_frames=group_frames, top_fn=ref_fn,
                timestep=delta_t,
            ):
                yield orient.bond_obs_host(xyz_chunk, ref0, idx_h, idx_x, w)

        for raw_diff, S in _obs_chunks():
            # Host-reduced observables: only the (F, nBonds, 3) NH diffs
            # + (F, 3, 3) Horn correlations cross host->device — NOT the
            # full (F, nAtoms, 3) coordinate block the decoder produced
            # (~17x less transfer at ubiquitin scale).
            bv = orient.bond_vectors_from_obs(
                jnp.asarray(raw_diff), jnp.asarray(S)
            )
            n_full = (raw_diff.shape[0] // fpc) * fpc
            if n_full == 0:
                continue  # tail shorter than one Palmer chunk: dropped
            g = n_full // fpc
            raw = bv.raw[:n_full].reshape(g, fpc, -1, 3)
            fit = bv.fitted[:n_full].reshape(g, fpc, -1, 3)
            _accumulate(raw, fit)

    if n_chunks_total == 0:
        raise ValueError("no complete Palmer chunks found in the input")

    out = {"res_ids": res_ids, "delta_t": delta_t}
    n_deltas = fpc // 2
    dt_lags = np.asarray(autocorr.lag_times(delta_t, tau_memory))
    R = float(n_chunks_total)

    if do_ct:
        for key, suffix in (("ext", "_Ctext.dat"), ("int", "_Ctint.dat")):
            if mesh is not None:
                # finalize() owns the padded-row slicing + pooling; its
                # (nDeltas, nRes) orientation transposes to the bond-
                # leading layout the writers use.
                ct_mean, ct_dct = ct_streams[key].finalize()
                mean, dct = ct_mean.T, ct_dct.T
            else:
                mean, dct = autocorr.palmer_pooled_stats(
                    jnp.asarray(acc[f"ct_{key}_s"]),
                    jnp.asarray(acc[f"ct_{key}_s2"]), R,
                )  # (nBonds, nDeltas)
            mean, dct = np.asarray(mean), np.asarray(dct)
            xvg.print_sxylist(
                out_prefix + suffix, res_ids, dt_lags,
                np.stack([mean, dct], axis=-1),
            )
            if key == "int":
                out["Ct"], out["dCt"] = mean.T, dct.T

    if do_vec_avg:
        avg = np.asarray(qt.vecnorm(acc["vec_sum"] / (R * fpc)))
        xvg.print_xylist(out_prefix + "_avgvec.dat", res_ids, avg.T, cols=True)
        out["avgvec"] = avg

    if do_vec_dist:
        if vec_storage == "Histogram":
            _spill_hist()  # fold the device int32 into the int64 total
            hist = hist_host
            ep, ec = hist_edges
            vecio.save_histogram(out_prefix + "_vecHistogram.npz", res_ids, hist, ep, ec)
            out["vec_file"] = out_prefix + "_vecHistogram.npz"
        elif pt_writer is not None:
            pt_writer.close()
            out["vec_file"] = pt_writer.fn

    if do_s2:
        if s2_mode == "outer":
            s2, ds2 = autocorr.palmer_pooled_stats(
                jnp.asarray(acc["s2_s"]), jnp.asarray(acc["s2_s2"]), R
            )
            s2, ds2 = np.asarray(s2), np.asarray(ds2)
            arr = np.stack([s2, ds2], axis=-1)
        else:
            arr = _ired_spectrum_artefact(out_prefix, ired_stream.result())
        xvg.print_xylist(out_prefix + "_S2.dat", res_ids, (arr.T) * zeta, cols=True)
        out["S2"] = arr
    return out
