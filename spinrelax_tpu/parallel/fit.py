"""Residue-sharded multi-field fitting.

Everything downstream of C(t) is embarrassingly parallel per residue
(ARCHITECTURE.md "Parallelism").  :func:`shard_experiment_set` pads the
residue axis and commits every residue-leading array of an
:class:`ExperimentSet` to a mesh sharding over BOTH axes ("rep",
"res"), so the jitted chi-square / GlobalFitter programs
(fit/globalfit.py) run residue-parallel with GSPMD-inserted reductions
— no code change in the fit itself.

Since the round-3 moment collapse (fit/globalfit._eval_all), the
axisymmetric optimiser's per-step cost no longer scales with the
vector-sample axis at all — the (nRes, nSamp, 3) ensembles fold into
per-residue A-moment constants once per fit.  Sharding still carries
the per-residue arrays (targets, masks, CSA, C(t) params) and matters
for the legacy per-sample evaluators and >10^5-residue fits.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..models.experiments import ExperimentSet
from .mesh import residue_sharding


def _pad0(a, pad: int, fill=0.0):
    if a is None or pad == 0:
        return a
    a = np.asarray(a)
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    if fill == "edge":
        return np.pad(a, widths, mode="edge")
    return np.pad(a, widths, constant_values=fill)


def shard_experiment_set(es: ExperimentSet, mesh) -> ExperimentSet:
    """Return an ExperimentSet whose residue axis is padded to the mesh
    device count and committed to a ("rep", "res")-combined sharding.

    Padded residues carry mask 0 everywhere (uncovered), tau 1 and
    C/S2 0, so every statistic (masked means, coverage counts) is
    unchanged; chisq_total / chisq_per_residue / GlobalFitter work on
    the result as-is, with each device holding only its residue slice.
    """
    n_dev = int(np.prod([mesh.shape[k] for k in mesh.shape]))
    n = es.n_residues
    pad = (-n) % n_dev
    sh1 = residue_sharding(mesh, ndim=1)
    sh2 = residue_sharding(mesh, ndim=2)
    sh3 = residue_sharding(mesh, ndim=3)

    def put(a, fill=0.0):
        if a is None:
            return None
        a = _pad0(a, pad, fill)
        return jax.device_put(a, (sh1, sh2, sh3)[a.ndim - 1])

    cts = es.cts
    cts_sharded = dataclasses.replace(
        cts,
        # fill 1: a padded residue must behave like a rigid rotor so its
        # J and R1 stay non-zero — NOE divides by R1 (0/0 -> NaN would
        # poison even masked sums).
        S2=put(cts.S2, fill=1.0),
        C=put(cts.C),
        tau=put(cts.tau, fill=1.0),
        mask=put(cts.mask),
        s2fast=put(cts.s2fast),
        dS2=put(cts.dS2),
        dC=put(cts.dC),
        dtau=put(cts.dtau),
        chisq=put(cts.chisq),
        names=list(cts.names) + [f"_pad{i}" for i in range(pad)],
    )
    expts = [
        dataclasses.replace(
            e,
            target=put(e.target),
            error=put(e.error, fill=1.0),
            mask=put(e.mask),
        )
        for e in es.experiments
    ]
    return dataclasses.replace(
        es,
        experiments=expts,
        cts=cts_sharded,
        # edge-replicate: padded residues need a REAL vector ensemble —
        # an all-zero row would give 0/0 ensemble means (NaN values) and
        # a zero ensemble variance whose d(sqrt)/dp is NaN in forward
        # mode, poisoning the LM jacobian through masked entries.
        vecs=put(es.vecs, fill="edge"),
        weights=put(es.weights, fill="edge"),
        # csa is residue-leading like everything above: committed to the
        # same sharding, or every jitted chisq dispatch re-ships it
        # host->device.
        csa=put(es.csa),
    )
