"""Batched DE-LUT explorer (design/de_lut_tpu.py) vs the f64 host engine."""

import numpy as np
import pytest

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.design.de import DELut
from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU
from lut_ldpc_tpu.design.templates import get_lut_tree_templates

# host-measured (3,6) q4 min-LUT threshold at 200 DE iterations (cli/de_sim,
# recorded in BASELINE.md round 1)
THR_36_Q4_200 = 0.864391


@pytest.fixture(scope="module")
def ens36():
    return LDPCEnsemble(np.array([3]), np.array([1.0]),
                        np.array([6]), np.array([1.0]))


def make_host(ens, maxiter=200, Nq=16, min_lut=True):
    nq_vec = np.full(maxiter, Nq, dtype=np.int64)
    var_luts, chk_luts = get_lut_tree_templates(
        "auto_bin_balanced", ens, nq_vec, Nq, min_lut)
    de = DELut(ens, Nq, nq_vec, maxiter, var_luts,
               None if min_lut else chk_luts)
    de.set_exit_conditions(max_ni_de_iters=30, Pe_max=1e-6, thr_prec=1e-4)
    return de


def test_batched_convergence_matches_host(ens36):
    """Converged/diverged decisions agree with the host engine away from
    the threshold (f32 cannot split hairs exactly at it)."""
    host = make_host(ens36)
    dea = DELutTPU(ens36, maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30)
    sigmas = np.array([0.82, 0.85, 0.88, 0.92])
    ach, _ = dea.evolve_batch(sigmas)
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code >= 0) == bool(a), (s, code, a)


def test_batched_threshold_near_host(ens36):
    """Grid-refined f32 threshold lands within 3e-3 of the host bisection
    value pinned from round 1."""
    dea = DELutTPU(ens36, maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30)
    thr = dea.threshold(points=9, rounds=3)
    assert abs(thr - THR_36_Q4_200) < 3e-3, thr


def test_refine_host_handoff(ens36):
    """threshold(refine_host=True) finishes with the f64 engine inside the
    explorer's bracket and matches the full host search."""
    host = make_host(ens36)
    dea = DELutTPU(ens36, maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30,
                   host=host)
    thr = dea.threshold(points=9, rounds=2, refine_host=True)
    # widen the explorer bracket downward like cli/de_sim before refining
    host.set_bisec_window(max(host.thr_min, thr - 0.02), thr + 0.005)
    _, thr_full = host.bisec_search()
    assert thr_full > 0
    assert abs(thr - thr_full) < 2e-3, (thr, thr_full)


def test_irregular_joint_root_decisions():
    """The published irregular ensemble through the joint_root path:
    converges well below the 0.9292 threshold, diverges well above."""
    ens = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    dea = DELutTPU(ens, maxiter_de=400, Pe_max=1e-6, max_ni_de_iters=30)
    ach, _ = dea.evolve_batch(np.array([0.89, 0.96]))
    assert bool(ach[0]) and not bool(ach[1])


def test_full_lut_mode_matches_host(ens36):
    """min_lut=False: CN updates through parity/magnitude-fold tree joins.
    Decisions agree with the host full-LUT engine; the full-LUT threshold
    beats min-LUT (tree CN is MI-optimal, min-sum is an approximation)."""
    host = make_host(ens36, min_lut=False)
    dea = DELutTPU(ens36, maxiter_de=200, Pe_max=1e-6, max_ni_de_iters=30,
                   min_lut=False)
    sigmas = np.array([0.84, 0.87, 0.90])
    ach, _ = dea.evolve_batch(sigmas)
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code >= 0) == bool(a), (s, code, a)
    thr = dea.threshold(points=9, rounds=3)
    assert thr > THR_36_Q4_200  # full-LUT CN beats the min approximation
    assert abs(thr - 0.8692) < 3e-3, thr


def test_reuse_zeros_matches_plain(ens36):
    """All-zeros reuse matrix reproduces the plain evolve (same program
    math through the reuse-select path)."""
    dea = DELutTPU(ens36, maxiter_de=30, Pe_max=1e-6, max_ni_de_iters=30)
    Pe0, it0 = dea.prerank_reuse(0.80, np.zeros((1, 30), bool), pmax=1e-6)
    _, Pe_plain = dea.evolve_batch(np.array([0.80]))
    assert np.allclose(Pe0, Pe_plain, rtol=1e-4), (Pe0, Pe_plain)
    assert it0[0] < 30


def test_reuse_ranking_matches_host(ens36):
    """The f32 candidate ranking (what reuse_vec_opt --accel trims with)
    agrees with f64 host evolves over single-reuse candidates."""
    M = 30
    dea = DELutTPU(ens36, maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30)
    cands = []
    for ii in (1, 3, 7, 15):
        rv = np.zeros(M, bool)
        rv[ii] = True
        cands.append(rv)
    Pe, it_hit = dea.prerank_reuse(0.80, np.stack(cands), pmax=1e-17)
    host = make_host(ens36, maxiter=M)
    host.Pe_max = 1e-17
    host.max_ni_de_iters = 30
    host_Pe = []
    for rv in cands:
        host.reuse_vec = rv.copy()
        _, _, tr, _, _ = host.evolve(0.80, var_trace=True)
        host_Pe.append(tr[-1])
    assert list(np.argsort(Pe)) == list(np.argsort(host_Pe))
    # reuse always hurts vs fresh design; later reuse hurts less
    assert Pe[0] > Pe[-1]


def test_reuse_mixed_resolutions(ens36):
    """Nq_Cha != Nq_Msg: the channel-leaf join's product alphabet is
    K*Nq_Cha, not K*K — the Q-map slots must size accordingly (regression:
    this used to crash at trace time)."""
    M = 12
    dea = DELutTPU(ens36, Nq_Cha=32, Nq_Msg=16, maxiter_de=M,
                   Pe_max=1e-6, max_ni_de_iters=30)
    rm = np.zeros((2, M), bool)
    rm[1, 2] = True
    Pe, it_hit = dea.prerank_reuse(0.80, rm, pmax=1e-6)
    assert Pe[1] >= Pe[0]  # reuse never helps
    # and the zeros row still matches the plain evolve (different fusion
    # choices across the two programs wiggle the f32 tail a little)
    _, Pe_plain = dea.evolve_batch(np.array([0.80]))
    assert np.allclose(Pe[0], Pe_plain, rtol=3e-3)


def test_reuse_rejects_initial_iteration(ens36):
    dea = DELutTPU(ens36, maxiter_de=10)
    rm = np.zeros((1, 10), bool)
    rm[0, 0] = True
    with pytest.raises(ValueError):
        dea.prerank_reuse(0.8, rm)


def test_batched_dp_matches_host_quantizer():
    """Property: the batched f32 DP reproduces host quant_mi_sym's output
    pmf on random symmetric inputs (generic position — no exact LLR ties,
    where the skipped duplicate-merge could differ)."""
    import jax.numpy as jnp

    from lut_ldpc_tpu.ops.quant import quant_mi_sym as host_quant

    rng = np.random.default_rng(7)
    ens = LDPCEnsemble(np.array([3]), np.array([1.0]),
                       np.array([6]), np.array([1.0]))
    dea = DELutTPU(ens, maxiter_de=4)
    M, K, S = 64, 8, 12
    pmfs = []
    for _ in range(S):
        half = rng.uniform(0.05, 1.0, M // 2)
        p = np.concatenate([half[::-1] * rng.uniform(0.1, 0.9, M // 2)[::-1],
                            half])
        pmfs.append(p / p.sum())
    batch = jnp.asarray(np.stack(pmfs), jnp.float32)
    import jax

    p_out_f32 = np.asarray(jax.jit(lambda p: dea._quantize(p, K))(batch))
    for i, p in enumerate(pmfs):
        _, p_host, _ = host_quant(p, K)
        assert np.allclose(p_out_f32[i], p_host, atol=2e-6), i


def test_de_sim_accel_respects_nq_msg_vec(tmp_path):
    """Regression: with a uniform [LUT] Nq_msg_vec override, the
    accelerator bracket must explore the overridden resolution (q3 here),
    not the qbits row (q4) — otherwise the host bisection window excludes
    the true threshold and the search fails to 0."""
    import configparser

    from lut_ldpc_tpu.cli.de_sim import de_sim_lut

    ini = tmp_path / "de.ini"
    ini.write_text(
        "[Sim]\n"
        "ensemble_filename = ensembles/rate0.50_dv03_dc06.ens\n"
        "thr_prec = 1e-3\nPe_max = 1e-6\nmaxiter_de = 60\n"
        "max_ni_de_iters = 30\naccelerator_sweep = 1\n"
        f"results_name = {tmp_path}/report.txt\n"
        "[LUT]\nqbits = 4 4\nNq_msg_vec = " + " ".join(["3"] * 60)
        + "\nmin_lut = true\n"
    )
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.read(str(ini))
    de_sim_lut(cp, None)
    txt = (tmp_path / "report.txt").read_text()
    thr = float(txt.split("Threshold(s) found = [")[1].split("]")[0])
    # q4-channel/q3-message threshold at 60 iters is 0.8452; a search that
    # failed (0.0) or bisected a wrongly-placed bracket would miss it
    assert 0.83 < thr < 0.855, thr


@pytest.mark.slow
def test_irregular_threshold_published():
    """Full-depth irregular joint_root threshold within 2e-3 of the
    reference's published f64 value 0.929193 (README.md:175)."""
    ens = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    dea = DELutTPU(ens, maxiter_de=2000, Pe_max=1e-6, max_ni_de_iters=30)
    thr = dea.threshold(points=9, rounds=3)
    assert abs(thr - 0.929193) < 2e-3, thr


def test_joint_level_matches_host():
    """joint_level strategy: converged/diverged decisions bracket the
    host f64 engine away from the threshold (same contract as the
    existing joint_root tests)."""
    import numpy as np

    from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
    from lut_ldpc_tpu.design.de import DELut, JOINT_LEVEL
    from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU
    from lut_ldpc_tpu.design.templates import get_lut_tree_templates

    ens = LDPCEnsemble(np.array([2, 3, 4]),
                       np.array([0.38354, 0.04237, 0.57409]),
                       np.array([5, 6]), np.array([0.24123, 0.75877]))
    M = 60
    tv, tc = get_lut_tree_templates(
        "auto_bin_balanced", ens, np.full(M, 16), 16, min_lut=True)
    host = DELut(ens, 16, np.full(M, 16), M, tv, tc,
                 irregular_design_strategy=JOINT_LEVEL)
    host.Pe_max = 1e-6
    host.max_ni_de_iters = 30
    dea = DELutTPU(ens, 16, 16, maxiter_de=M, Pe_max=1e-6,
                   max_ni_de_iters=30, strategy=JOINT_LEVEL)
    # far from the threshold (~0.777 host / ~0.80 f32 explorer: the f32
    # explorer sits a little above the f64 host on this ensemble for
    # BOTH joint strategies) the decisions must agree
    sigmas = np.array([0.70, 0.95, 1.10])
    ach, Pe = dea.evolve_batch(sigmas)
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)
    # and the explorer's bracket must cover the host threshold within
    # the de_sim margin (host 0.77727 at thr_prec 1e-4, pinned)
    thr = dea.threshold(points=17, rounds=2)
    assert 0.77727 - 1e-3 < thr < 0.77727 + 0.05, thr


def test_nonuniform_nq_vec_matches_host():
    """Vector per-iteration resolutions (segmented evolve): decisions
    match the host with the same Nq_Msg_vec away from its threshold."""
    import numpy as np

    from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
    from lut_ldpc_tpu.design.de import DELut
    from lut_ldpc_tpu.design.de_lut_tpu import DELutTPU
    from lut_ldpc_tpu.design.templates import get_lut_tree_templates

    ens = LDPCEnsemble(np.array([3]), np.array([1.0]),
                       np.array([6]), np.array([1.0]))
    M = 40
    nqv = np.array([16] * 20 + [8] * 20)
    tv, tc = get_lut_tree_templates(
        "auto_bin_balanced", ens, nqv, 16, min_lut=True)
    host = DELut(ens, 16, nqv, M, tv, tc)
    host.Pe_max = 1e-6
    host.max_ni_de_iters = 30
    dea = DELutTPU(ens, 16, nqv, maxiter_de=M, Pe_max=1e-6,
                   max_ni_de_iters=30)
    assert not dea.uniform_nq
    sigmas = np.array([0.70, 0.78, 0.90, 0.95])
    ach, Pe = dea.evolve_batch(sigmas)
    for s, a in zip(sigmas, ach):
        code, *_ = host.evolve(float(s))
        assert (code > 0) == bool(a), (s, code, a)


def test_mesh_sharded_grid_matches_single_device(ens36):
    """Sigma-grid evaluation sharded over the 8-device mesh equals the
    single-device batch exactly (points are independent; per-point
    results latch at their own exit) — the device mapping of de_sim's
    thread-per-sweep-point fan-out, now scaled across the mesh."""
    import jax

    from lut_ldpc_tpu.parallel import dp_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    sigmas = np.linspace(0.80, 0.92, 11)  # 11 points: exercises wrap-pad
    single = DELutTPU(ens36, maxiter_de=60, Pe_max=1e-6, max_ni_de_iters=30)
    sharded = DELutTPU(ens36, maxiter_de=60, Pe_max=1e-6, max_ni_de_iters=30,
                       mesh=dp_mesh(8))
    a1, p1 = single.evolve_batch(sigmas)
    a8, p8 = sharded.evolve_batch(sigmas)
    assert np.array_equal(a1, a8)
    assert np.array_equal(p1, p8)


def test_mesh_sharded_reuse_matches_single_device(ens36):
    import jax

    from lut_ldpc_tpu.parallel import dp_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    M = 12
    reuse = np.zeros((5, M), dtype=bool)  # 5 rows: exercises wrap-pad
    for i in range(1, 5):
        reuse[i, 2 * i] = True
    single = DELutTPU(ens36, maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30)
    sharded = DELutTPU(ens36, maxiter_de=M, Pe_max=1e-6, max_ni_de_iters=30,
                       mesh=dp_mesh(8))
    p1, i1 = single.prerank_reuse(0.85, reuse)
    p8, i8 = sharded.prerank_reuse(0.85, reuse)
    assert np.array_equal(p1, p8)
    assert np.array_equal(i1, i8)
