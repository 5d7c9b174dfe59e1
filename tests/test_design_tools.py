"""BP density evolution, de_sim / reuse_vec_opt CLI tools."""

import os

import numpy as np
import pytest

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.design.de_bp import DEBp

ENS36 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "ensembles", "rate0.50_dv03_dc06.ens")


@pytest.fixture(scope="module")
def ens36():
    return LDPCEnsemble(np.array([3]), np.array([1.0]), np.array([6]), np.array([1.0]))


def test_de_bp_converges_below_threshold(ens36):
    de = DEBp(ens36, Nb=8)
    de.set_exit_conditions(maxiter_de=300)
    a, _, _ = de.evolve(0.84)
    assert a > 0
    a2, _, _ = de.evolve(0.95)
    assert a2 < 0


def test_de_bp_pmf_transforms(ens36):
    de = DEBp(ens36, Nb=6)
    rng = np.random.default_rng(0)
    pmf = rng.random(2 * de.N + 2)
    pmf /= pmf.sum()
    p, m = de._pmf_plus(pmf), de._pmf_minus(pmf)
    back = de._pmf_orig(p, m)
    np.testing.assert_allclose(back, pmf, atol=1e-15)


@pytest.mark.slow
def test_de_bp_threshold_36(ens36):
    """(3,6) continuous-BP threshold ~0.881 (textbook Richardson/Urbanke)."""
    de = DEBp(ens36, Nb=9)
    de.set_exit_conditions(maxiter_de=500, thr_prec=1e-3)
    _, thr = de.bisec_search()
    assert thr == pytest.approx(0.881, abs=5e-3)


def test_de_bp_trace(ens36):
    de = DEBp(ens36, Nb=7)
    de.set_exit_conditions(maxiter_de=50)
    a, P, p = de.evolve(0.8, var_trace=True)
    assert a > 0
    assert P.shape[1] == 1 and len(p) == P.shape[0]
    assert (np.diff(p) <= 0).mean() > 0.8  # mostly decreasing


def test_de_sim_cli_lut(tmp_path):
    ini = tmp_path / "de.ini"
    out = tmp_path / "thr.txt"
    ini.write_text(f"""
[Sim]
thr_prec = 1e-3
maxiter_de = 30
results_name = {out}
ensemble_filename = {ENS36}

[LUT]
min_lut = true
qbits = 4 4
tree_mode = auto_bin_balanced
""")
    from lut_ldpc_tpu.cli.de_sim import main

    assert main(["-p", str(ini)]) == 0
    text = out.read_text()
    assert "Threshold(s) found" in text and "Pe_trace" in text
    thr = float(text.split("Threshold(s) found = [")[1].split("]")[0])
    assert 0.80 < thr < 0.88  # 30-iteration q4 threshold


def test_de_sim_cli_bp(tmp_path):
    ini = tmp_path / "de_bp.ini"
    out = tmp_path / "thr_bp.txt"
    ini.write_text(f"""
[Sim]
thr_prec = 5e-3
maxiter_de = 100
results_name = {out}
ensemble_filename = {ENS36}

[BP]
qbits = 8
""")
    from lut_ldpc_tpu.cli.de_sim import main

    assert main(["-p", str(ini)]) == 0
    thr = float(out.read_text().split("Threshold(s) found = [")[1].split("]")[0])
    assert 0.84 < thr < 0.90


def test_reuse_vec_opt_cli(capsys):
    from lut_ldpc_tpu.cli.reuse_vec_opt import main

    rc = main([
        "-m", "-t", "0.82", "-i", "6", "-r", "4", "-p", "1e-6",
        "-d", "3 / 1.0 / 6 / 1.0",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Finished." in out
    last = out.strip().splitlines()[-1]
    reuse = eval(last.split("= ")[1])
    assert sum(reuse) == 2  # 6 iters - 4 stages
    assert reuse[0] == 0  # first iteration never reused


def test_tree_file_mode(tmp_path):
    """Tree templates from the INI dialect drive a full design + decode."""
    import numpy as np
    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder import LUTCodec, make_decoder
    from lut_ldpc_tpu.ops.pmf import snr2sig
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from util_codes import random_regular_H

    graph = TannerGraph.from_dense(random_regular_H(96, 3, 6, seed=2))
    sig = float(snr2sig(0.5, 2.0))
    codec = LUTCodec.design(
        graph, sig**2, max_iters=4,
        tree_method="filename=trees/tree_file_example.ini",
    )
    dec = make_decoder(codec)
    rng = np.random.default_rng(0)
    s2 = float(snr2sig(0.5, 5.0))
    y = 1.0 + s2 * rng.standard_normal((16, graph.nvar))
    bits, ok, _ = dec(*codec.quantize_channel(2.0 * y / s2**2))
    assert np.asarray(ok).mean() > 0.8
    # golden scalar agreement on one frame
    lc, lm = codec.quantize_channel(2.0 * y / s2**2)
    want, _ = codec.decode_ref(lc[0], lm[0])
    assert np.array_equal(np.asarray(bits)[0], want)


def test_repo_assets_load():
    """The generated repo assets parse and are consistent."""
    from lut_ldpc_tpu.core.alist import read_alist
    from lut_ldpc_tpu.core.ensemble import LDPCEnsemble

    ens = LDPCEnsemble.read("ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens")
    assert ens.rate() == pytest.approx(0.5, abs=1e-2)
    H = read_alist("codes/rate0.50_dv03_dc06_N1000.alist")
    assert H.shape == (500, 1000)
    assert (H.sum(axis=0) == 3).all()


def test_de_sim_sweep_qbits(tmp_path):
    """Sweep over qbits rows (one thread per resolution pair)."""
    out = tmp_path / "thr_sweep.txt"
    ini = tmp_path / "de_sweep.ini"
    ini.write_text(f"""
[Sim]
thr_prec = 5e-3
maxiter_de = 20
results_name = {out}
ensemble_filename = /root/repo/ensembles/rate0.50_dv03_dc06.ens

[LUT]
min_lut = true
qbits = 3 3; 4 4
tree_mode = auto_bin_balanced
""")
    from lut_ldpc_tpu.cli.de_sim import main

    assert main(["-p", str(ini)]) == 0
    text = out.read_text()
    thrs = [float(x) for x in
            text.split("Threshold(s) found = [")[1].split("]")[0].split()]
    assert len(thrs) == 2
    assert thrs[1] > thrs[0]  # 4-bit beats 3-bit


def test_de_sim_sweep_reuse(tmp_path):
    """Sweep over reuse_iter_vec values."""
    out = tmp_path / "thr_reuse.txt"
    ini = tmp_path / "de_reuse.ini"
    ini.write_text(f"""
[Sim]
thr_prec = 5e-3
maxiter_de = 20
results_name = {out}
ensemble_filename = /root/repo/ensembles/rate0.50_dv03_dc06.ens

[LUT]
min_lut = true
qbits = 4 4
reuse_iter_vec = 0 3
tree_mode = auto_bin_balanced
""")
    from lut_ldpc_tpu.cli.de_sim import main

    assert main(["-p", str(ini)]) == 0
    thrs = [float(x) for x in
            out.read_text().split("Threshold(s) found = [")[1].split("]")[0].split()]
    assert len(thrs) == 2
    assert thrs[0] >= thrs[1] - 5e-3  # reuse can only cost threshold
