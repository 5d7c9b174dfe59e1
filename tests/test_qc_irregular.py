"""Irregular quasi-cyclic construction and its decode.

The QC family (core/qc.py) extends to arbitrary ensembles: node-perspective
degree distributions quantized to Z-column blocks, circulants in distinct
check blocks per variable block, girth-conditioned shifts.  The decode of
the multi-degree-block code must stay bit-identical to the scalar golden
model (decode_ref, after the reference's LDPC_Code_LUT.cpp:259).
"""

import numpy as np
import pytest

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_irregular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder
from lut_ldpc_tpu.ops.pmf import snr2sig

ENS = "ensembles/rate0.50_dv02-17_dc08-09_lut_q4.ens"


@pytest.fixture(scope="module")
def qc_irr():
    e = LDPCEnsemble.read(ENS)
    return qc_generate_irregular(e, Z=24, nb=60, seed=1)


@pytest.fixture(scope="module")
def codec_irr(qc_irr):
    return LUTCodec.design(qc_expand(qc_irr), 0.90**2, max_iters=10,
                           Nq_Cha=16, Nq_Msg=16)


def test_construction_matches_ensemble(qc_irr):
    e = LDPCEnsemble.read(ENS)
    g = qc_expand(qc_irr)
    # block-quantized node fractions: within 1/nb of the ensemble's
    nb, Z = qc_irr.nb, qc_irr.Z
    lam_node = dict(zip(e.degree_lam.tolist(), e.Lam_node()))
    for d in g.vn_degrees:
        frac = len(g.vn_node_idx[int(d)]) / (nb * Z)
        assert abs(frac - lam_node[int(d)]) <= 1.0 / nb
    # column blocks are degree-uniform and circulants hit distinct rows
    col_deg = (qc_irr.base >= 0).sum(axis=0)
    for j in range(nb):
        dv = g.dv_vec[j * Z : (j + 1) * Z]
        assert np.all(dv == dv[0]) and dv[0] == col_deg[j]
    # row degrees exactly match the assigned check-block degrees
    row_deg = (qc_irr.base >= 0).sum(axis=1)
    for i in range(qc_irr.mb):
        dc = g.dc_vec[i * Z : (i + 1) * Z]
        assert np.all(dc == row_deg[i])
    # edge balance
    assert int(col_deg.sum()) == int(row_deg.sum())


def test_no_four_cycles(qc_irr):
    g = qc_expand(qc_irr)
    H = np.zeros((g.nchk, g.nvar), np.int32)
    for d in g.cn_degrees:
        for c, vars_ in zip(g.cn_node_idx[int(d)], g.cn_var_idx[int(d)]):
            H[c, vars_] = 1
    M = H @ H.T
    np.fill_diagonal(M, 0)
    assert M.max() <= 1  # two checks share at most one variable


@pytest.fixture(scope="module")
def codec_irr_std(codec_irr):
    """The same matrix without its QC structure (plain alist form)."""
    from lut_ldpc_tpu.core.tanner import TannerGraph

    g = TannerGraph.from_dense(codec_irr.graph.to_dense())
    assert getattr(g, "qc", None) is None
    return LUTCodec.design(g, 0.90**2, max_iters=10, Nq_Cha=16, Nq_Msg=16)


@pytest.mark.parametrize("graph,snr,frames,seed", [
    ("qc", 2.0, 48, 5),
    ("qc", 1.8, 16, 9),
    ("unstructured", 1.8, 16, 9),
])
def test_arith_decode_bit_identical(codec_irr, codec_irr_std, graph, snr,
                                    frames, seed):
    """The value-domain decoder on the multi-class irregular code, in its
    QC and its unstructured realization, decodes bit-identically to the
    table decoder and the scalar golden model."""
    codec = codec_irr if graph == "qc" else codec_irr_std
    dec = ArithLUTDecoder(codec, early_exit=True)
    fast = FastLUTDecoder(codec, early_exit=True)
    rng = np.random.default_rng(seed)
    sig = float(snr2sig(0.5, snr))
    y = 1.0 + sig * rng.standard_normal((frames, codec.nvar))
    llr = 2.0 * y / sig**2
    lc, lm = codec.quantize_channel(llr)
    b1, ok1, it1 = [np.asarray(a) for a in dec(lc, lm)]
    b2, ok2, it2 = [np.asarray(a) for a in fast(lc, lm)]
    assert np.array_equal(b1, b2)
    assert np.array_equal(ok1, ok2)
    assert np.array_equal(it1, it2)
    for f in range(6):
        b_ref, it_ref = codec.decode_ref(np.asarray(lc)[f], np.asarray(lm)[f])
        itr = it_ref if it_ref > 0 else codec.max_iters
        assert np.array_equal(np.asarray(b_ref), b1[f])
        assert itr == it1[f]


def test_mb_override_sets_rate():
    e = LDPCEnsemble.read(ENS)
    qc = qc_generate_irregular(e, Z=24, nb=60, seed=2, mb=30)
    assert qc.mb == 30  # rate-1/2 block grid, edge sum repaired in-degree
    g = qc_expand(qc)
    assert g.nchk * 2 == g.nvar
