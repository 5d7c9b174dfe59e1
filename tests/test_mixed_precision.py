"""Mixed-precision decoders: int16 prefix -> f32 arith segment (-> table tail).

The N=64800 DVB-S2-scale codec validates 43/50 iterations in int16 (the
scaled-integer tables' sums exceed the int16 range beyond that,
arith.py "int16 sum range exceeded") but 49/50 in float32.  The
mixed-precision compositions must stay bit-identical to the full table
decoder.  This miniature reproduces the exact 43/49 split: same
empirical ensemble as the N=64800 QC code (node fractions quantized to
[27,52,1,10]/90 and [16,29]/45 — LUT design depends only on the
ensemble and design sigma, after the reference's LDPC_Code_LUT.cpp:699),
at Z=16 so the decodes stay fast on the CPU.
"""

import os

import numpy as np
import pytest

from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_irregular
from lut_ldpc_tpu.decoder import LUTCodec
from lut_ldpc_tpu.decoder.fast_decoder import FastLUTDecoder
from lut_ldpc_tpu.decoder.hybrid import HybridLUTDecoder
from lut_ldpc_tpu.ops.pmf import snr2sig

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def codec_mixed():
    e = LDPCEnsemble.read(os.path.join(
        HERE, "ensembles", "rate0.50_dv02-17_dc08-09_lut_q4.ens"))
    qc = qc_generate_irregular(e, Z=16, nb=90, seed=2, mb=45)
    return LUTCodec.design(qc_expand(qc), 0.90**2, max_iters=50,
                           Nq_Cha=16, Nq_Msg=16)


@pytest.fixture(scope="module")
def codec_mixed_std(codec_mixed):
    from lut_ldpc_tpu.core.tanner import TannerGraph

    g = TannerGraph.from_dense(codec_mixed.graph.to_dense())
    assert getattr(g, "qc", None) is None
    return LUTCodec.design(g, 0.90**2, max_iters=50, Nq_Cha=16, Nq_Msg=16)


def _identical(dec, ref, codec, snr, seed):
    rng = np.random.default_rng(seed)
    sig = float(snr2sig(0.5, snr))
    y = 1.0 + sig * rng.standard_normal((8, codec.nvar))
    lc, lm = codec.quantize_channel(2.0 * y / sig**2)
    b1, ok1, it1 = [np.asarray(a) for a in dec(lc, lm)]
    b2, ok2, it2 = [np.asarray(a) for a in ref(lc, lm)]
    assert np.array_equal(ok1, ok2)
    assert np.array_equal(it1, it2)
    assert np.array_equal(b1, b2)


def test_mixed_engages(codec_mixed):
    dec = HybridLUTDecoder(codec_mixed)
    assert dec.mid is not None, "mixed precision should engage (43/49)"
    assert dec.pre.S == 43 and dec.S == 49


@pytest.mark.parametrize("graph", ["qc", "unstructured"])
def test_mixed_arith_selected_and_identical(codec_mixed, codec_mixed_std,
                                            graph):
    """make_decoder picks MixedArithDecoder (int16 front + full-f32
    arithmetic finish) on QC and unstructured graphs alike, and it is
    bit-identical to the table decoder at an SNR where frames converge
    in both segments."""
    from lut_ldpc_tpu.decoder.fast_decoder import make_decoder
    from lut_ldpc_tpu.decoder.hybrid import MixedArithDecoder

    codec = codec_mixed if graph == "qc" else codec_mixed_std
    dec = make_decoder(codec, early_exit=True)
    assert isinstance(dec, MixedArithDecoder)
    assert dec.S16 == 43 and dec.S == 49
    _identical(dec, FastLUTDecoder(codec, early_exit=True), codec, 1.8, 11)


@pytest.mark.parametrize("snr", [
    # slow lane: the int16->f32->table HybridLUTDecoder composition is a
    # fallback configuration (make_decoder prefers MixedArithDecoder,
    # whose decode identity runs in the default lane above)
    pytest.param(1.0, marks=pytest.mark.slow),
    pytest.param(2.5, marks=pytest.mark.slow),
])
def test_mixed_bit_identical_to_table_decoder(codec_mixed, snr):
    codec = codec_mixed
    hyb = HybridLUTDecoder(codec)
    assert hyb.mid is not None
    _identical(hyb, FastLUTDecoder(codec, early_exit=True), codec, snr,
               int(snr * 10) + 3)
