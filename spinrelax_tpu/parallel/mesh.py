"""Device-mesh construction and sharding helpers.

The reference has no distributed computing (SURVEY §2.5) — its "data
parallelism" is replicate MD trajectories analysed jointly and its
"sequence parallelism" is the Palmer memory-time chunking of the frame
axis.  Both map naturally onto a 2D JAX mesh:

    axis 'rep' : Palmer chunks / replica trajectories  (data parallel)
    axis 'res' : bond vectors / residues               (model parallel)

Collectives (means + SEM over chunks, residue gathers) are inserted by
GSPMD from sharding annotations — no hand-written communication.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most balanced (a, b) with a*b == n."""
    best = (n, 1)
    a = int(np.sqrt(n))
    while a > 1:
        if n % a == 0:
            best = (n // a, a)
            break
        a -= 1
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("rep", "res"),
    devices=None,
) -> Mesh:
    """Build a 2D mesh over the available (or given) devices.

    Asking for more devices than exist is an error, not a silent
    truncation — a CLI `--devices 8` on a 1-chip host must not quietly
    run unsharded while the user believes otherwise."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} JAX device(s) are available "
                f"(jax.devices()={[str(d) for d in devices]})"
            )
        devices = devices[:n_devices]
    n = len(devices)
    shape = _factor2(n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(axis_names))


def pad_and_shard(mesh: Mesh, arrays):
    """Pad every array's LEADING axis to a device-count multiple with
    copies of row 0 (well-conditioned dummies) and device_put it sharded
    over all mesh axes.  Returns (sharded_arrays, n_orig) — slice device
    results back to ``n_orig`` rows.  The shared idiom of the
    residue-parallel fit paths (fit_ct_ladder, run_sharded_finish)."""
    # Device-resident inputs stay device-resident: np.asarray on a jax
    # Array would fetch it to the host only to re-ship it.  device_put
    # with a new sharding reshards
    # jax arrays without a host bounce.
    arrays = [a if isinstance(a, jax.Array) else np.asarray(a)
              for a in arrays]
    if any(a.ndim == 0 for a in arrays):
        raise ValueError(
            "pad_and_shard pads the LEADING axis: 0-d inputs have none "
            "— broadcast scalars to a (n,) residue axis first"
        )
    n_orig = arrays[0].shape[0]
    ndev = int(mesh.devices.size)
    pad = (-n_orig) % ndev
    out = []
    for a in arrays:
        if a.shape[0] != n_orig:
            raise ValueError(
                f"leading axes differ: {a.shape[0]} vs {n_orig}"
            )
        if pad:
            xp = jax.numpy if isinstance(a, jax.Array) else np
            a = xp.concatenate([a, xp.repeat(a[:1], pad, axis=0)], axis=0)
        sh = NamedSharding(
            mesh, P(tuple(mesh.axis_names), *([None] * (a.ndim - 1)))
        )
        out.append(jax.device_put(a, sh))
    return out, n_orig


def fetch(a) -> np.ndarray:
    """Host-fetch that also works on MULTI-PROCESS (multi-host) arrays.

    ``np.asarray`` on a jax array whose shards live on other processes'
    devices raises (the local process cannot address them); the
    multi-host paths (tools/multihost_worker.py --flagship) instead
    all-gather the shards over the distributed backend first.  On
    single-process arrays — the common case — this IS ``np.asarray``,
    with zero extra transfers.  Every process must call this on the
    same array in the same order (it is a collective when the array is
    not fully addressable), which holds because multi-host drivers run
    identical host code in lockstep."""
    if isinstance(a, jax.Array) and not a.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))
    return np.asarray(a)


def vecs_sharding(mesh: Mesh) -> NamedSharding:
    """(nRep, nFrames, nRes, 3): chunk axis over 'rep', residue over 'res'."""
    return NamedSharding(mesh, P("rep", None, "res", None))


def residue_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Arrays with a leading residue axis sharded over BOTH mesh axes
    (residues are embarrassingly parallel in the fit/J stages)."""
    return NamedSharding(mesh, P(("rep", "res"), *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
