"""File-fed end-to-end benchmark: .xtc on disk -> R1/R2/NOE artefacts.

``bench_northstar.py`` measures the COMPUTE path with device-generated
input (BASELINE.md's metric definition).  This tool measures the SHIPPED
file-fed production path instead — what `spinrelax ct --split` /
`run-all -stream` actually run (pipeline.stages.stage_ct_streamed):

  native XTC decode on the host (io/native.iter_xtc)
    -> bond-vector extraction + Kabsch superposition on device
    -> ONE fused streamed dispatch per chunk group
       (C(t) ext+int, S2 blocks, average vector, Lambert histograms)
    -> DoF-ladder fit (stage_fit_ct) -> R1/R2/NOE (stage_relax)

Decode of group N+1 overlaps device compute of group N for free (the
fused update is dispatched async), so file-fed wall time ~= max(decode,
compute) + fit/relax tails.

Setup writes a synthetic tumbling trajectory once (rigid body random
walk with per-residue NH wobble, fully vectorised) and is NOT part of
the timed section; its cost is reported separately.  A decode-only pass
over the same file is timed for attribution.

Presets:
  --preset ubiquitin   71 NH bonds in a 1231-atom solute x 100k frames
                       (the reference's own scale, README.md:155)
  --preset northstar   10^4 NH bonds (30k-atom solute) x 20k frames
                       (file-fed slice of the BASELINE north star)

Usage: python tools/bench_file_e2e.py [--preset ubiquitin] [--workdir D]
"""

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


from spinrelax_tpu.utils.synthetic import build_trajectory  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="ubiquitin",
                   choices=["ubiquitin", "northstar"])
    p.add_argument("--nres", type=int, default=0, help="override bond count")
    p.add_argument("--frames", type=int, default=0, help="override frames")
    p.add_argument("--workdir", default="/tmp/spinrelax_file_e2e")
    p.add_argument("--keep", action="store_true",
                   help="keep the workdir (reuse the trajectory next run; "
                        "same seed and shape only)")
    p.add_argument("--seed", type=int, default=0,
                   help="trajectory RNG seed (default: fresh from the "
                        "clock)")
    p.add_argument("--tau-mem", type=float, default=1000.0,
                   help="Palmer memory time [ps] (1000-frame chunks at dt=1)")
    p.add_argument("--groups", type=int, default=4, help="chunks per dispatch")
    p.add_argument("--threads", type=int, default=1,
                   help="decoder threads (0 = one per core)")
    a = p.parse_args()

    if a.preset == "ubiquitin":
        n_res, n_pad, n_frames = 71, 1231 - 3 * 71, 100_000
    else:
        n_res, n_pad, n_frames = 10_000, 0, 20_000
    if a.nres:
        n_res, n_pad = a.nres, 0
    if a.frames:
        n_frames = a.frames

    # The CLI enables the persistent XLA compilation cache; this bench
    # measures the same production path, so engage it identically.
    from spinrelax_tpu.utils import compile_cache

    compile_cache.enable_default()

    seed = a.seed if a.seed else (int(time.time()) & 0x7FFFFFFF)

    pre_existing = os.path.isdir(a.workdir)
    os.makedirs(a.workdir, exist_ok=True)
    ref_pdb = os.path.join(a.workdir, "reference.pdb")
    xtc = os.path.join(a.workdir, "traj.xtc")
    meta_fn = os.path.join(a.workdir, "meta.json")
    meta = dict(n_res=n_res, n_pad=n_pad, n_frames=n_frames)
    reuse = False
    if a.keep and os.path.exists(meta_fn):
        with open(meta_fn) as fh:
            stored = json.load(fh)
        stored.pop("seed", None)  # shape match only; seed is informational
        reuse = stored == meta and os.path.exists(xtc)
    meta["seed"] = seed
    if reuse:
        info = {"setup_s": 0.0, "file_bytes": os.path.getsize(xtc),
                "n_atoms": 3 * n_res + n_pad, "n_frames": n_frames,
                "n_res": n_res, "reused": True}
        print(f"= = reusing {xtc}")
    else:
        print(f"= = building {n_frames} frames x {3 * n_res + n_pad} atoms "
              f"({n_res} NH bonds) in {a.workdir} ...")
        ref_pdb, xtc, info = build_trajectory(
            a.workdir, n_res, n_pad, n_frames, seed=seed
        )
        with open(meta_fn, "w") as fh:
            json.dump(meta, fh)
    print(f"= = setup: {info['setup_s']} s, "
          f"{info['file_bytes'] / 1e6:.0f} MB xtc")

    # --- decode-only pass (attribution): pure host-side iter_xtc.
    from spinrelax_tpu.io import native

    t0 = time.time()
    got = 0
    for chunk, _, _ in native.iter_xtc(xtc, 2000, threads=a.threads):
        got += len(chunk)
    decode_s = time.time() - t0
    assert got == n_frames, (got, n_frames)
    print(f"= = decode-only: {decode_s:.2f} s "
          f"({n_frames / decode_s:.0f} frames/s, "
          f"{info['file_bytes'] / decode_s / 1e6:.0f} MB/s)")

    # --- host-prep pass (attribution): decode + bond_obs_host, no device
    # work at all — everything stage_ct_streamed does on the host before
    # its async dispatches.  wall(ct_stream) - prep_s is then the cost
    # the device path adds ON TOP of host prep (transfer serialisation +
    # dispatch + any non-overlapped compute), which is the honest test of
    # the decode-overlaps-compute claim.
    from spinrelax_tpu.io import pdb as pdbio
    from spinrelax_tpu.ops import orient

    top, ref_xyz = pdbio.read_structure(ref_pdb)
    idx_h, idx_x, _res = pdbio.bond_indices(
        top, "name H", "name N and not resname PRO"
    )
    w_fit = np.asarray(top.occupancies) > 0
    t0 = time.time()
    sink = 0.0
    for chunk, _, _ in native.iter_xtc(xtc, 2000, threads=a.threads):
        raw_diff, S = orient.bond_obs_host(
            chunk, ref_xyz[0], idx_h, idx_x, w_fit.astype(float)
        )
        sink += float(raw_diff[0, 0, 0]) + float(S[0, 0, 0])
    prep_s = time.time() - t0
    print(f"= = decode+bond_obs (host prep, no device): {prep_s:.2f} s "
          f"({n_frames / prep_s:.0f} frames/s)")

    # --- the timed end-to-end: streamed ct -> ladder fit -> rates.
    from spinrelax_tpu.models import Diffusion
    from spinrelax_tpu.pipeline import stages

    out_dir = os.path.join(a.workdir, "out")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    prefix = os.path.join(out_dir, "rotdif")

    t0 = time.time()
    stages.stage_ct_streamed(
        [xtc], [ref_pdb], prefix,
        tau_memory=a.tau_mem, chunk_groups=a.groups,
    )
    t_ct = time.time() - t0

    t1 = time.time()
    stages.stage_fit_ct([prefix + "_Ctint.dat"], prefix)
    t_fit = time.time() - t1

    t2 = time.time()
    stages.stage_relax(
        prefix + "_fittedCt.dat", prefix + "-600",
        Diffusion.isotropic(diso=3.3e-5),
        vec_file=prefix + "_vecHistogram.npz",
    )
    t_relax = time.time() - t2
    total = time.time() - t0

    fv = n_frames * n_res
    result = {
        "metric": "file_fed_e2e_seconds",
        "value": round(total, 2),
        "unit": "s",
        "preset": a.preset,
        "n_frames": n_frames,
        "n_res": n_res,
        "n_atoms": info["n_atoms"],
        "file_MB": round(info["file_bytes"] / 1e6, 1),
        "decode_only_s": round(decode_s, 2),
        "host_prep_s": round(prep_s, 2),
        "ct_stream_s": round(t_ct, 2),
        "fit_ladder_s": round(t_fit, 2),
        "relax_s": round(t_relax, 2),
        "frames_per_s": round(n_frames / t_ct, 1),
        "frame_vectors_per_s": round(fv / t_ct, 1),
    }
    print(json.dumps(result))
    if not a.keep:
        if pre_existing:
            # Never rmtree a directory the tool did not create — the
            # user's --workdir may hold unrelated files.
            print(f"= = workdir {a.workdir} pre-existed; left in place "
                  "(pass --keep to silence)", file=sys.stderr)
        else:
            shutil.rmtree(a.workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
