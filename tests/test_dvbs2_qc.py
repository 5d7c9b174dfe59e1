"""DVB-S2-family periodic QC structure: detection, phantom semantics,
and decoder equivalence on a small synthetic analog.

The analog reproduces the standard DVB-S2 construction at toy scale
(core/dvbs2.py docstring): info column groups with per-column shift q,
a weight-2 circulant (two base addresses in one residue class), and the
accumulator staircase whose wrap misses one edge — so the permuted form
has base2 cells and exactly one phantom completion, like the real
N=64800 matrix (codes/rate0.50_irreg_dvbs2_N64800.alist).

Golden check: decode_ref on the COMPLETED graph (phantom pinned-edge
semantics) must equal decode_ref on the TRUE graph built with identical
slot order, frame for frame, including iteration counts.
"""

import numpy as np
import pytest

from lut_ldpc_tpu.core.dvbs2 import periodic_qc_structure
from lut_ldpc_tpu.core.qc import qc_expand
from lut_ldpc_tpu.core.tanner import TannerGraph
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.ops.pmf import snr2sig

import os as _os
HERE_TESTS = _os.path.dirname(_os.path.abspath(__file__))

Z = 16
Q = 4          # rows per block-diagonal residue; M = Z * Q
M = Z * Q      # 64 checks
GROUPS = [     # info column groups: base check addresses (DVB-S2 style)
    [0, 9, 34],          # dv=3, residues {0, 1, 2}: weight-1 cells
    [3, 21, 46],         # dv=3, residues {3, 1, 2}: weight-1 cells
    [1, 6, 11, 36],      # dv=4, residues {1, 2, 3, 0}: weight-1 cells
    [2, 7, 23, 16],      # dv=4, residues {2, 3, 3, 0}: one WEIGHT-2 cell
]
K = len(GROUPS) * Z
N = K + M


def _true_cols():
    """Column lists of the TRUE toy matrix in original coordinates."""
    cols = []
    for g in GROUPS:
        for t in range(Z):
            cols.append(np.array(sorted((x + t * Q) % M for x in g)))
    for j in range(M):  # staircase: col K+j -> rows {j, j+1}; wrap missing
        rows = [j] if j == M - 1 else [j, j + 1]
        cols.append(np.array(rows))
    return cols


@pytest.fixture(scope="module")
def analog():
    cols = _true_cols()
    out = periodic_qc_structure(cols, N, M, Z)
    assert out is not None
    qc, col_perm, row_perm = out
    g = qc_expand(qc)
    return qc, g, col_perm, row_perm, cols


def test_structure(analog):
    qc, g, col_perm, row_perm, cols = analog
    assert qc.base2 is not None and (qc.base2 >= 0).sum() == 1
    assert len(qc.phantoms) == 1
    assert len(g.qc_phantoms) == 1
    assert g.num_edges == sum(len(c) for c in cols) + 1
    # to_dense / ensemble describe the TRUE matrix
    H = g.to_dense()
    assert int(H.sum()) == sum(len(c) for c in cols)
    Ht = np.zeros((M, N), np.uint8)
    for c, rows in enumerate(cols):
        Ht[rows, c] = 1
    # permuted true matrix == to_dense of the completed graph
    Hp = np.zeros_like(Ht)
    Hp[row_perm[:, None], col_perm[None, :]] = Ht
    assert np.array_equal(H, Hp)
    ens = g.empirical_ensemble()
    lam = ens.var_degree_dist_dense()
    assert lam[1] > 0  # the dv=1 staircase-wrap column is accounted


def _true_slot_graph(g):
    """TRUE graph with the completed graph's slot order minus phantoms."""
    starts = np.concatenate([[0], np.cumsum(g.dv_vec)])
    ph_by_var = {}
    for p in g.qc_phantoms:
        ph_by_var.setdefault(p["var"], set()).add(p["edge"])
    # reconstruct per-var check lists in edge order from the index arrays
    chk_of_edge = np.empty(g.num_edges, np.int64)
    for d in g.cn_degrees:
        d = int(d)
        for r, c in enumerate(g.cn_node_idx[d]):
            chk_of_edge[g.cn_edge_idx[d][r]] = c
    cols = []
    for v in range(g.nvar):
        es = [e for e in range(starts[v], starts[v + 1])
              if e not in ph_by_var.get(v, ())]
        cols.append(np.array([chk_of_edge[e] for e in es], np.int64))
    return TannerGraph.from_cols(cols, g.nvar, g.nchk)


def test_decode_ref_phantom_equivalence(analog):
    """Completed-graph decode (phantom semantics) == true-graph decode."""
    qc, g, col_perm, row_perm, cols = analog
    gt = _true_slot_graph(g)
    sig = float(snr2sig(g.rate() and (1 - g.nchk / g.nvar), 2.0))
    sigma2 = 0.9 ** 2
    codec = LUTCodec.design(g, sigma2, max_iters=6, Nq_Cha=16, Nq_Msg=16)
    codec_t = LUTCodec.design(gt, sigma2, max_iters=6, Nq_Cha=16, Nq_Msg=16)
    # identical designs (same true ensemble)
    assert np.array_equal(codec.qb_Cha, codec_t.qb_Cha)
    rng = np.random.default_rng(7)
    snr_sig = 0.8
    n_mismatch = 0
    for fr in range(12):
        y = 1.0 + snr_sig * rng.standard_normal(g.nvar)
        llr = 2.0 * y / snr_sig ** 2
        lc, lm = codec.quantize_channel(llr[None])
        b1, i1 = codec.decode_ref(lc[0], lm[0])
        b2, i2 = codec_t.decode_ref(lc[0], lm[0])
        assert np.array_equal(b1, b2), f"frame {fr}: bits differ"
        assert i1 == i2, f"frame {fr}: iters differ ({i1} vs {i2})"


@pytest.fixture(scope="module")
def analog_codec(analog):
    qc, g, col_perm, row_perm, cols = analog
    return LUTCodec.design(g, 0.9 ** 2, max_iters=6, Nq_Cha=16, Nq_Msg=16)


def _frames(codec, B, seed, snr_sig=0.8):
    rng = np.random.default_rng(seed)
    y = 1.0 + snr_sig * rng.standard_normal((B, codec.nvar))
    return codec.quantize_channel(2.0 * y / snr_sig ** 2)


@pytest.mark.parametrize("frames,seed", [(24, 3), (16, 5)])
def test_arith_xla_matches_decode_ref(analog_codec, frames, seed):
    """Batched arith decoder == scalar golden model on the
    phantom-completed analog."""
    import numpy as np

    from lut_ldpc_tpu.decoder import make_decoder
    from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder

    codec = analog_codec
    dec = make_decoder(codec, early_exit=True)
    assert isinstance(dec, ArithLUTDecoder)
    llr_cha, llr_msg = _frames(codec, frames, seed)
    bits, ok, iters = (np.asarray(x) for x in dec(llr_cha, llr_msg))
    for b in range(frames):
        want, want_it = codec.decode_ref(llr_cha[b], llr_msg[b])
        assert np.array_equal(bits[b], want), f"frame {b}"
        assert iters[b] == abs(want_it), f"frame {b}: {iters[b]} vs {want_it}"
        assert ok[b] == (want_it > 0), f"frame {b}"


def test_table_decoder_matches_decode_ref(analog_codec):
    """The general unrolled table decoder (the universal fallback for
    codecs with no arithmetic representation) implements the same
    pinned-edge semantics."""
    import numpy as np

    from lut_ldpc_tpu.decoder.lut_decoder import LUTDecoder

    codec = analog_codec
    dec = LUTDecoder(codec, early_exit=True)
    llr_cha, llr_msg = _frames(codec, 16, 9)
    bits, ok, iters = (np.asarray(x) for x in dec(llr_cha, llr_msg))
    for b in range(16):
        want, want_it = codec.decode_ref(llr_cha[b], llr_msg[b])
        assert np.array_equal(bits[b], want), f"frame {b}"
        assert iters[b] == abs(want_it), f"frame {b}"
        assert ok[b] == (want_it > 0), f"frame {b}"


def test_fast_decoder_rejects_phantoms(analog_codec):
    from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder

    with pytest.raises(ValueError):
        FastLUTDecoder(analog_codec)


def test_real_dvbs2_structure():
    """The reference's flagship DVB-S2 alist factorizes: Z=360, uniform
    dc=7, 8 weight-2 cells, exactly one phantom (the staircase wrap)."""
    from lut_ldpc_tpu.core.alist import read_alist_cols

    path = _os.path.join(_os.path.dirname(HERE_TESTS), "codes",
                         "rate0.50_irreg_dvbs2_N64800.alist")
    cols, nvar, nchk = read_alist_cols(path)
    out = periodic_qc_structure(cols, nvar, nchk, 360)
    assert out is not None
    qc, col_perm, row_perm = out
    assert qc.Z == 360 and qc.mb == 90 and qc.nb == 180
    assert (qc.base2 >= 0).sum() == 8
    assert qc.phantoms == ((179, 359, 0, 0),)


def test_detection_rejects_unstructured():
    """Matrices without the 360-periodic structure return None (the sim
    CLI then falls back to the gather path)."""
    rng = np.random.default_rng(0)
    N, M, Zt = 32, 16, 8
    cols = [np.sort(rng.choice(M, size=3, replace=False)) for _ in range(N)]
    assert periodic_qc_structure(cols, N, M, Zt) is None


def test_detection_weight3_rejected():
    """Three shifts landing in one cell exceed the base/base2 capacity."""
    Zt, q = 8, 2
    M, K = Zt * q, Zt * 2
    cols = []
    for g in ([0, 2, 4],):  # residues 0,0,0 mod q=2 -> weight-3 cell
        for t in range(Zt):
            cols.append(np.array(sorted((x + t * q) % M for x in g)))
    cols += [np.array(sorted({j, j + 1} & set(range(M))))
             for j in range(M)]
    N = len(cols)
    assert periodic_qc_structure(cols, N, M, Zt) is None


def test_qc_structure_roundtrip(analog, tmp_path):
    """save_qc/load_qc preserve base2 and phantoms."""
    from lut_ldpc_tpu.core.qc import load_qc, save_qc

    qc = analog[0]
    p = tmp_path / "toy.qc.json"
    save_qc(str(p), qc)
    qc2 = load_qc(str(p))
    assert np.array_equal(qc.base, qc2.base)
    assert np.array_equal(qc.base2, qc2.base2)
    assert qc.phantoms == qc2.phantoms


def test_sim_qc_detect_ini(analog, tmp_path):
    """LDPC.qc_detect=1 factorizes the alist inside run_from_config and
    the sim runs on the phantom-completed graph end to end."""
    from lut_ldpc_tpu.core.alist import write_alist
    from lut_ldpc_tpu.sim.ber_sim import run_from_config
    from lut_ldpc_tpu.sim.config import parse_ini

    qc, g, col_perm, row_perm, cols = analog
    H = np.zeros((M, N), np.uint8)
    for c, rows in enumerate(cols):
        H[rows, c] = 1
    alist = tmp_path / "toy_dvbs2.alist"
    write_alist(str(alist), H)
    ini = tmp_path / "sim.ini"
    ini.write_text(f"""[Sim]
SNRdB = 3.0
Nframes = 32
Nfers = 1000000
batch_size = 32
results_dir = {tmp_path}/results
[LDPC]
parity_filename = {alist}
zero_codeword = 1
qc_detect = 1
qc_detect_Z = 16
[LUT]
max_iter = 6
design_thr = 0.9
qbits_channel = 4
qbits_message_uniform = 4
min_lut = 1
""")
    cfg = parse_ini(str(ini))
    assert cfg.ldpc.qc_detect
    res, sim = run_from_config(cfg, codes_root=str(tmp_path), seed=0,
                               verbose=False)
    assert sim.graph.phantoms  # the factorized graph was used
    assert int(res.frames[0]) == 32


def test_codec_roundtrip_preserves_qc(analog_codec, tmp_path):
    """save/load keeps the QC structure, phantoms, and decode results
    (same realization, same decode path)."""
    codec = analog_codec
    p = str(tmp_path / "qc_codec")
    codec.save(p)
    codec2 = LUTCodec.load(p + ".npz")
    assert getattr(codec2.graph, "qc", None) is not None
    assert codec2.graph.phantoms and (
        codec2.graph.phantoms[0]["edge"] == codec.graph.phantoms[0]["edge"])
    lc, lm = _frames(codec, 6, 21)
    for b in range(6):
        b1, i1 = codec.decode_ref(lc[b], lm[b])
        b2, i2 = codec2.decode_ref(lc[b], lm[b])
        assert np.array_equal(b1, b2) and i1 == i2


def test_arith_matches_golden_unstructured():
    """Arith decoder == scalar golden model on an unstructured graph with
    MIXED degree-class sizes including a degree-1 node."""
    import sys as _sys

    _sys.path.insert(0, HERE_TESTS)
    from util_codes import random_regular_H

    from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder

    H = random_regular_H(96, 3, 6, seed=3).copy()
    # carve a degree-1 variable and an irregular column out of the
    # regular base so the layout has small and large degree classes
    H[:, 0] = 0
    H[0, 0] = 1
    g = TannerGraph.from_dense(H)
    codec = LUTCodec.design(g, 0.81, max_iters=6, Nq_Cha=16, Nq_Msg=16)
    dec = ArithLUTDecoder(codec, early_exit=True)
    lc, lm = _frames(codec, 16, 2)
    bits, ok, iters = (np.asarray(x) for x in dec(lc, lm))
    for b in range(16):
        want, want_it = codec.decode_ref(lc[b], lm[b])
        assert np.array_equal(bits[b], want), f"frame {b}"
        assert iters[b] == abs(want_it), f"frame {b}"
        assert ok[b] == (want_it > 0), f"frame {b}"
