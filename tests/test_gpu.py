"""What only the card can show: the XLA forms of C(t) and the ladder walk
compiled by the GPU compiler, against float64 / host-CPU references.

Skipped off the card (gpu_device fixture).  On the card:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


@pytest.mark.gpu
def test_acf_forms_on_card(gpu_device):
    import jax

    with jax.default_device(gpu_device):
        rec = cs.phase_ct(shapes=((4, 1000, 256), (2, 3000, 128)),
                          n_check=64, reps=1)
    assert rec["ok"], [c for c in rec["checks"] if not c["ok"]]


@pytest.mark.gpu
def test_ladder_walk_on_card_matches_cpu(gpu_device):
    import jax

    with jax.default_device(gpu_device):
        rec = cs.phase_ladder(n_res=1024, n_lags=500, n_cmp=256, reps=1)
    assert rec["ok"], [c for c in rec["checks"] if not c["ok"]]
