"""Batched DE-BP engine (design/de_bp_tpu.py) vs the f64 host engine."""

import numpy as np
import pytest

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.design.de_bp import DEBp
from lut_ldpc_tpu.design.de_bp_tpu import DEBpTPU


@pytest.fixture(scope="module")
def ens36():
    return LDPCEnsemble(np.array([3]), np.array([1.0]),
                        np.array([6]), np.array([1.0]))


def test_batched_convergence_matches_host(ens36):
    """Converged/diverged decisions agree with the host engine away from
    the threshold (f32 cannot split hairs exactly at it)."""
    host = DEBp(ens36, Nb=9)
    host.Pe_max = 1e-6
    dea = DEBpTPU(ens36, Nb=9, Pe_max=1e-6, maxiter_de=1000)
    sigmas = np.array([0.80, 0.84, 0.86, 0.90, 0.94])
    ach, Pe = dea.evolve_batch(sigmas)
    for s, a in zip(sigmas, ach):
        code, _, _ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)


def test_batched_threshold_brackets_pinned(ens36):
    """Grid-refined f32 threshold lands within 3e-3 of the f64 bisection
    value, pinned here as a constant ((3,6) BP at Nb=9, maxiter 1000,
    Pe_max 1e-6 -> 0.88046; re-derived live by the slow-marked test
    below).  Keeping the live host bisection out of the default suite
    saves ~150 s per run."""
    dea = DEBpTPU(ens36, Nb=9, Pe_max=1e-6, maxiter_de=1000)
    thr = dea.threshold(points=9, rounds=3)
    assert abs(thr - 0.88046) < 3e-3, thr


@pytest.mark.slow
def test_batched_threshold_brackets_host(ens36):
    """Live f64 host bisection vs the batched f32 threshold (also guards
    the 0.88046 constant pinned above)."""
    host = DEBp(ens36, Nb=9)
    host.Pe_max = 1e-6
    host.set_exit_conditions(maxiter_de=1000)
    _, thr_host = host.bisec_search()
    assert abs(thr_host - 0.88046) < 5e-4, thr_host
    dea = DEBpTPU(ens36, Nb=9, Pe_max=1e-6, maxiter_de=1000)
    thr = dea.threshold(points=9, rounds=3)
    assert abs(thr - thr_host) < 3e-3, (thr, thr_host)


def test_irregular_batch(ens36):
    """Irregular ensembles run through the incremental-degree path."""
    ens = LDPCEnsemble(np.array([2, 3, 8]),
                       np.array([0.2857, 0.2571, 0.4572]),
                       np.array([7]), np.array([1.0]))
    dea = DEBpTPU(ens, Nb=9, Pe_max=1e-6, maxiter_de=500)
    ach, Pe = dea.evolve_batch(np.array([0.7, 1.1]))
    assert bool(ach[0]) and not bool(ach[1])
