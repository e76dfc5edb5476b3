"""spinrelax_tpu — a JAX/XLA framework for predicting
NMR spin-relaxation observables (R1, R2, hetNOE, rho, J(w)) from molecular
dynamics trajectories, with global parameter fitting against experiment.

A ground-up rebuild of the capabilities of zharmad/SpinRelax
designed for accelerators (run on NVIDIA GPUs):
device-resident arrays instead of file passing, FFT autocorrelation
instead of O(N^2) lag loops, vmapped batched fitting instead of
per-residue scipy, and jax.sharding for multi-device scaling.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
