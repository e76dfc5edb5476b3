"""Batched scalar minimisation utilities.

``golden_vec`` minimises a vector-valued objective elementwise — every
batch element carries its own bracket — with a fixed iteration count so
the whole search jits to one fused loop.  Used for the residue-specific
CSA local optimisation, where the reference runs nResidues sequential
scalar Powell fits (spectral_densities.py:1371-1382); here all residues
descend together, one batched forward evaluation per iteration.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp

# Python floats, NOT jnp: a jnp op here would initialise the JAX backend
# at import time, before callers can pin the platform (e.g. to CPU).
_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
_INVPHI2 = (3.0 - math.sqrt(5.0)) / 2.0


def golden_vec(f: Callable, lo, hi, n_iter: int = 60):
    """Elementwise golden-section minimisation.

    f        : maps (B,) candidate vector -> (B,) objective values.
    lo, hi   : (B,) bracket bounds per element.
    Returns the (B,) minimising points.

    Classic single-evaluation iteration: the surviving interior point of
    each lane is exactly the next c or d (golden-ratio invariant), so
    only ONE batched f call runs per iteration.  60 iterations shrink
    the bracket by 0.618^60 ~ 3e-13 — below f64 resolution for any
    physical CSA bracket, including the rsCSA expansion ladder.
    """
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi)

    def body(_, state):
        a, b, c, d, fc, fd = state
        sr = fc < fd  # minimum in [a, d]
        a_new = jnp.where(sr, a, c)
        b_new = jnp.where(sr, d, b)
        h = b_new - a_new
        # Kept point: old c becomes the new d when shrinking right; old
        # d becomes the new c otherwise.  Only the other point is fresh.
        c_new = jnp.where(sr, a_new + _INVPHI2 * h, d)
        d_new = jnp.where(sr, c, a_new + _INVPHI * h)
        x_eval = jnp.where(sr, c_new, d_new)
        fx = f(x_eval)
        fc_new = jnp.where(sr, fx, fd)
        fd_new = jnp.where(sr, fc, fx)
        return a_new, b_new, c_new, d_new, fc_new, fd_new

    h0 = hi - lo
    c0 = lo + _INVPHI2 * h0
    d0 = lo + _INVPHI * h0
    state = (lo, hi, c0, d0, f(c0), f(d0))
    a, b, c, d, fc, fd = jax.lax.fori_loop(0, n_iter, body, state)
    x = 0.5 * (a + b)
    return x
