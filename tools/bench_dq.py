"""Stage-level Delta-q benchmark: `spinrelax dq` vs the reference
calculate-dq-distribution.py on the SAME synthetic colvar.

The dq stage is the reference workflow's second compute sink after C(t)
(calculate-dq-distribution.py:554-650: a Python loop over ~100 lags of
full-trajectory quaternion products, then scalar Powell fits whose
objective evaluates the model in a per-data-point Python loop,
:152-167).  This tool measures the product-level stage on identical
inputs and identical outputs (read colvar -> iso+aniso lag statistics
with sub-chunk uncertainties -> exponential fits -> artefact files):

  ours      pipeline.stages.stage_dq (native colvar parser, lag-vmapped
            jitted statistics, batched golden-section fits)
  reference calculate-dq-distribution.py via tools/refshim

Both walls include file read, statistics, fits and artefact writes.
A steady-state (second-call, same process) wall for ours is reported
separately: cold-process jit compile is part of the first call.

Usage: python tools/bench_dq.py [--frames 1000000] [--ref-frames 200000]
                                [--workdir DIR] [--keep]

The reference run is scaled down by default (--ref-frames) because its
wall is dominated by np.genfromtxt on the colvar text; its full-size
wall is extrapolated linearly in frames (read + per-lag statistics both
scale linearly; the Powell fit tail is frame-independent, so the
extrapolation UNDERSTATES the true full-size reference advantage gap).
Set --ref-frames equal to --frames for a direct measurement.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
SHIM = os.path.join(REPO, "tools", "refshim")


from spinrelax_tpu.utils.synthetic import simulate_quats, write_colvar_file  # noqa: E402,E501


def run_ours(colvar, out_prefix, grid, n_chunks):
    from spinrelax_tpu.pipeline.stages import stage_dq

    t0 = time.perf_counter()
    stage_dq(colvar, out_prefix, grid[0], grid[1], grid[2],
             n_chunks=n_chunks)
    return time.perf_counter() - t0


def run_reference(colvar, out_prefix, grid, n_chunks, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = SHIM + ":" + REF
    env["JAX_PLATFORMS"] = "cpu"
    t0 = time.perf_counter()
    out = subprocess.run(
        [
            sys.executable, os.path.join(REF, "calculate-dq-distribution.py"),
            "--iso", "--aniso", "-f", colvar, "-o", out_prefix,
            "--mindt", str(grid[0]), "--maxdt", str(grid[1]),
            "--skip", str(grid[2]), "--num_chunk", str(n_chunks),
        ],
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        sys.exit("reference failed: " + out.stderr[-2000:])
    return wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1_000_000)
    ap.add_argument("--ref-frames", type=int, default=200_000)
    ap.add_argument("--tau", type=float, default=2000.0,
                    help="target tau_c [ps] (sets D_iso = 1/(6 tau))")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--skip-reference", action="store_true")
    a = ap.parse_args()

    work = a.workdir or tempfile.mkdtemp(prefix="benchdq_")
    os.makedirs(work, exist_ok=True)
    dt = 1.0
    d_iso = 1.0 / (6.0 * a.tau)
    # run-all's default lag grid: tau/100 steps out to tau (run-all.bash:97,386)
    grid = (a.tau / 100.0, a.tau, a.tau / 100.0)

    print(f"= generating {a.frames} frames (tau_c={a.tau} ps) ...")
    t0 = time.perf_counter()
    q = simulate_quats(a.frames, [d_iso] * 3, dt, seed=20260819)
    print(f"  ... {time.perf_counter() - t0:.1f} s (not timed)")
    colvar = os.path.join(work, "colvar-qorient")
    t0 = time.perf_counter()
    write_colvar_file(colvar, q, dt)
    print(f"  colvar write: {time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(colvar) / 1e6:.0f} MB, not timed)")

    ours_cold = run_ours(colvar, os.path.join(work, "ours"), grid, a.chunks)
    ours_warm = run_ours(colvar, os.path.join(work, "ours2"), grid, a.chunks)
    n_lags = len(np.arange(max(grid[2], grid[0]), grid[1] + grid[2] / 2,
                           grid[2]))
    result = {
        "metric": "dq_stage_wall_s",
        "frames": a.frames,
        "n_lags": n_lags,
        "ours_cold_s": round(ours_cold, 3),
        "ours_warm_s": round(ours_warm, 3),
    }

    if not a.skip_reference:
        if a.ref_frames == a.frames:
            ref_colvar = colvar
        else:
            ref_colvar = os.path.join(work, "colvar-ref")
            write_colvar_file(ref_colvar, q[: a.ref_frames], dt)
        ref_wall = run_reference(ref_colvar, os.path.join(work, "ref"),
                                 grid, a.chunks, timeout=5400)
        scale = a.frames / a.ref_frames
        result.update(
            ref_frames=a.ref_frames,
            ref_wall_s=round(ref_wall, 3),
            ref_wall_fullsize_extrapolated_s=round(ref_wall * scale, 1),
            speedup_vs_reference=round(ref_wall * scale / ours_warm, 1),
        )

    print(json.dumps(result))
    if not a.keep and a.workdir is None:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
