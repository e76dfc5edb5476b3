"""Benchmark: P2-autocorrelation C(t) throughput of the streamed group step.

Prints the card's name and power limit, then ONE JSON line
{"metric", "value", "unit", "vs_baseline", "device"}.

Headline metric (BASELINE.json): frames x vectors / second for the
Palmer C(t) stage — the #1 compute sink of the reference workflow
(calculate-Ct-from-traj.py:200-238, an O(nDeltas * nFrames) einsum loop).

Baseline: the reference's numpy lag-loop implementation at the same
canonical chunk size (1000 frames/chunk): 2.95e5 frames*vectors/s on a
host CPU core (tools/bench_reference.py).

What is timed: ``stream_accumulate``'s jitted group step
(ops/autocorr._stream_update_jit — ACF + per-chunk Palmer statistics
folded into running sum/sum-of-squares accumulators) on device-resident
(g, nFrames, nRes, 3) groups, the layout the shipped streamed stage
feeds it.  Each timed call ends in block_until_ready.  The run fails
unless JAX's device is a GPU.
"""

import json
import statistics
import subprocess
import sys
import time

REFERENCE_CPU_RATE = 2.95e5

# 32 Palmer chunks x 1000 frames x 1024 bond vectors per step (393 MB f32).
N_REP, N_FRAMES, N_RES = 32, 1000, 1024
N_DELTAS = N_FRAMES // 2
N_ITER = 10


def main():
    import jax
    import jax.numpy as jnp

    from spinrelax_tpu.ops.autocorr import _stream_update_jit
    from spinrelax_tpu.utils.compile_cache import enable_default

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    enable_default()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)

    step = _stream_update_jit(N_FRAMES, N_DELTAS)

    @jax.jit
    def gen(key):
        v = jax.random.normal(key, (N_REP, N_FRAMES, N_RES, 3), jnp.float32)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    keys = jax.random.split(jax.random.PRNGKey(0), N_ITER + 1)
    inputs = [gen(k) for k in keys]
    acc = jnp.zeros((N_RES, N_DELTAS), jnp.float32)
    jax.block_until_ready(step(inputs[-1], acc, acc))  # compile
    times = []
    for x in inputs[:N_ITER]:
        t0 = time.perf_counter()
        jax.block_until_ready(step(x, acc, acc))
        times.append(time.perf_counter() - t0)

    rate = N_REP * N_FRAMES * N_RES / statistics.median(times)
    print(json.dumps({
        "metric": "ct_palmer_frames_x_vectors_per_s",
        "value": rate,
        "unit": "frames*vectors/s",
        "vs_baseline": rate / REFERENCE_CPU_RATE,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
