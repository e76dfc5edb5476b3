"""Seeded synthetic inputs at the workflow's real sizes.

Trajectories (reference PDB + XTC) of a rigid solute tumbling under
isotropic rotational diffusion with per-residue N-H wobble, and
quaternion colvars of rotational Brownian motion.  Used by the chip
smoke run and the benchmark tools; everything is vectorised so 10^5-10^6
frame inputs build in seconds to minutes on one core.
"""

import os
import string
import time

import numpy as np


def _qmult_np(a, b):
    """Batched Hamilton product, numpy, (...,4)x(...,4)."""
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


def _qcumprod(dq):
    """Inclusive left-to-right cumulative quaternion product, O(F log F).

    Hillis-Steele scan: associativity of the Hamilton product makes the
    doubling combine exact for the non-commutative case as long as the
    earlier block stays the LEFT factor.  Renormalised per pass."""
    q = dq.copy()
    step = 1
    n = len(q)
    while step < n:
        prod = _qmult_np(q[:-step], q[step:])
        q[step:] = prod
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        step *= 2
    return q


def _quat_to_mat(q):
    """(F, 4) unit quats -> (F, 3, 3) rotation matrices."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    m = np.empty((len(q), 3, 3), dtype=q.dtype)
    m[:, 0, 0] = 1 - 2 * (y * y + z * z)
    m[:, 0, 1] = 2 * (x * y - z * w)
    m[:, 0, 2] = 2 * (x * z + y * w)
    m[:, 1, 0] = 2 * (x * y + z * w)
    m[:, 1, 1] = 1 - 2 * (x * x + z * z)
    m[:, 1, 2] = 2 * (y * z - x * w)
    m[:, 2, 0] = 2 * (x * z - y * w)
    m[:, 2, 1] = 2 * (y * z + x * w)
    m[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def build_trajectory(workdir, n_res, n_pad_atoms, n_frames, dt=1.0,
                     d_iso=3.3e-5, wobble=0.25, tau_int=30.0, seed=11,
                     gen_chunk=1000):
    """Write reference.pdb + traj.xtc; returns (ref_pdb, xtc, setup_info).

    Rigid solute (N/H/CA per residue + n_pad_atoms rigid filler carbons)
    under an isotropic rotational random walk with an AR(1) NH wobble —
    all vectorised (quaternion scan + chunked einsum), so building 10^9+
    coordinates stays minutes-scale on one core."""
    from scipy.signal import lfilter

    from ..io import native
    from ..io import pdb as pdbio

    rng = np.random.default_rng(seed)
    t_setup = time.time()

    # --- topology: N, H, CA per residue, then rigid filler atoms.
    n_atoms = 3 * n_res + n_pad_atoms
    base = np.empty((n_atoms, 3), dtype=np.float64)
    # residue centres + filler on a self-avoiding-ish random ball
    cen = rng.normal(size=(n_res, 3))
    cen *= (1.5 * rng.uniform(0.3, 1.0, (n_res, 1)) ** (1 / 3)
            / np.linalg.norm(cen, axis=1, keepdims=True))
    nh0 = rng.normal(size=(n_res, 3))
    nh0 /= np.linalg.norm(nh0, axis=1, keepdims=True)
    base[0::3][:n_res] = cen
    base[1::3][:n_res] = cen + 0.102 * nh0
    base[2::3][:n_res] = cen + np.array([0.05, -0.03, 0.08])
    if n_pad_atoms:
        fill = rng.normal(size=(n_pad_atoms, 3))
        fill *= (1.5 * rng.uniform(0.1, 1.0, (n_pad_atoms, 1)) ** (1 / 3)
                 / np.linalg.norm(fill, axis=1, keepdims=True))
        base[3 * n_res:] = fill

    names = ["N", "H", "CA"] * n_res + ["C"] * n_pad_atoms
    # PDB's %4d resSeq field caps at 9999 (write_pdb rejects overflow
    # loudly): number residues 2..9999 within a chain and advance the
    # chain id per 9998-residue block — bond pairing downstream is
    # (chain, resSeq)-keyed (io/pdb.bond_indices), so duplicate resSeq
    # values across chains stay unambiguous.
    pool = (string.ascii_uppercase + string.ascii_lowercase
            + string.digits)
    total_res = n_res + n_pad_atoms
    if total_res > 9998 * len(pool):
        raise ValueError(f"{total_res} residues exceed single-char chains")
    gres = np.arange(total_res)
    atoms_per_res = np.concatenate(
        [np.full(n_res, 3, dtype=int), np.ones(n_pad_atoms, dtype=int)]
    )
    res_seqs = np.repeat(2 + (gres % 9998), atoms_per_res)
    chain_ids = list(np.repeat(np.array(list(pool))[gres // 9998],
                               atoms_per_res))
    res_names = ["ALA"] * (3 * n_res) + ["ALA"] * n_pad_atoms
    occs = np.tile([0.0, 0.0, 1.0], n_res)
    occs = np.concatenate([occs, np.ones(n_pad_atoms)])
    elements = ["N", "H", "C"] * n_res + ["C"] * n_pad_atoms
    top = pdbio.Topology(names, res_seqs, res_names, chain_ids,
                         occs, elements)
    ref_pdb = os.path.join(workdir, "reference.pdb")
    pdbio.write_pdb(ref_pdb, top, base)

    # --- global tumbling: random-walk quaternions, one O(F log F) scan.
    sig = np.sqrt(2.0 * d_iso * dt)
    w = rng.normal(scale=sig, size=(n_frames, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    th = np.where(th == 0, 1e-12, th)
    dq = np.concatenate(
        [np.cos(th / 2), np.sin(th / 2) * w / th], axis=1
    )
    q = _qcumprod(dq)
    rot = _quat_to_mat(q).astype(np.float32)  # (F, 3, 3)

    # --- AR(1) wobble angle per residue (exact OU discretisation).
    a = np.exp(-dt / tau_int)
    noise = rng.normal(
        scale=wobble * np.sqrt(1 - a * a), size=(n_frames, n_res)
    ).astype(np.float32)
    noise[0] = wobble * rng.normal(size=n_res)
    phi = lfilter([1.0], [1.0, -a], noise, axis=0).astype(np.float32)

    e1 = np.cross(nh0, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(nh0, e1)
    cw, sw = np.cos(wobble), np.sin(wobble)

    xtc = os.path.join(workdir, "traj.xtc")
    if os.path.exists(xtc):
        os.remove(xtc)
    base32 = base.astype(np.float32)
    nh032, e132, e232 = (x.astype(np.float32) for x in (nh0, e1, e2))
    n_idx = np.arange(0, 3 * n_res, 3)
    h_idx = n_idx + 1
    for lo in range(0, n_frames, gen_chunk):
        hi = min(lo + gen_chunk, n_frames)
        f = hi - lo
        frames = np.broadcast_to(base32, (f, n_atoms, 3)).copy()
        dirs = (cw * nh032
                + sw * (np.cos(phi[lo:hi])[:, :, None] * e132
                        + np.sin(phi[lo:hi])[:, :, None] * e232))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        frames[:, h_idx] = frames[:, n_idx] + 0.102 * dirs
        coords = np.einsum("fij,faj->fai", rot[lo:hi], frames)
        native.write_xtc(
            xtc, coords,
            times=(np.arange(lo, hi, dtype=np.float32) * dt),
            append=lo > 0, step0=lo,
        )
    info = {
        "setup_s": round(time.time() - t_setup, 2),
        "file_bytes": os.path.getsize(xtc),
        "n_atoms": n_atoms,
        "n_frames": n_frames,
        "n_res": n_res,
    }
    return ref_pdb, xtc, info


def simulate_quats(n_frames, d_body, dt, seed):
    """Vectorised rotational Brownian motion: per-step rotation vectors
    ~ N(0, 2 D_i dt) in the body frame, composed by a Hillis-Steele
    cumulative Hamilton product (O(F log F), exact for the
    non-commutative case with the earlier block as the LEFT factor)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=np.sqrt(2.0 * np.asarray(d_body) * dt),
                   size=(n_frames, 3))
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    ax = np.where(th > 0, w / np.maximum(th, 1e-300), [1.0, 0.0, 0.0])
    dq = np.concatenate([np.cos(th / 2), ax * np.sin(th / 2)], axis=-1)
    dq[0] = [1.0, 0, 0, 0]
    return _qcumprod(dq)


def write_colvar_file(fn, q, dt):
    from ..io.colvar import write_colvar

    t = np.arange(q.shape[0], dtype=np.float64) * dt
    write_colvar(fn, ["time", "q.w", "q.x", "q.y", "q.z"],
                 np.concatenate([t[:, None], q], axis=1).T)
