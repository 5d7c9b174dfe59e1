"""shard_map x value-domain decoder composition on the virtual mesh.

The combination a multi-device run uses: the ArithLUTDecoder traced
INSIDE shard_map over the 8-device mesh, frames sharded, per-batch
counters gathered.  Must equal the single-device run bit-for-bit
(conftest.py forces the 8-device CPU platform)."""

import numpy as np
import pytest

import jax


@pytest.fixture(scope="module")
def qc_codec():
    from lut_ldpc_tpu.core.qc import qc_expand, qc_generate_regular
    from lut_ldpc_tpu.decoder import LUTCodec
    from lut_ldpc_tpu.ops.pmf import snr2sig

    graph = qc_expand(qc_generate_regular(3, 6, Z=16, nb=6, seed=2))
    sig = float(snr2sig(0.5, 2.0))
    return LUTCodec.design(graph, sig * sig, max_iters=6, Nq_Cha=16,
                           Nq_Msg=16)


@pytest.fixture(scope="module")
def std_codec(qc_codec):
    """The same matrix without its QC structure."""
    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder import LUTCodec
    from lut_ldpc_tpu.ops.pmf import snr2sig

    g = TannerGraph.from_dense(qc_codec.graph.to_dense())
    sig = float(snr2sig(0.5, 2.0))
    return LUTCodec.design(g, sig * sig, max_iters=6, Nq_Cha=16, Nq_Msg=16)


def _run(codec, mesh):
    from lut_ldpc_tpu.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.array([2.0]), Nframes=32, Nfers=10**9,
                      batch_size=4),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    sim = BERSim(cfg, codec.graph, codec=codec, mesh=mesh)
    if mesh is not None:
        from lut_ldpc_tpu.decoder.arith_decoder import ArithLUTDecoder

        assert isinstance(sim.decoder, ArithLUTDecoder)
    return sim.run(seed=0, verbose=False)


@pytest.mark.parametrize("graph", ["qc", "unstructured"])
def test_shardmap_decode_matches_single_device(qc_codec, std_codec, graph):
    """Counters are EXACTLY invariant to mesh size: global-batch-index
    RNG keying (parallel/mesh.py make_dp_step) makes the 8-device run,
    the 1-device mesh run, and the unmeshed run produce identical
    results — the reference's same-seed-same-results contract
    (LDPC_BER_Sim.cpp:129) extended across device counts."""
    from lut_ldpc_tpu.parallel import dp_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    codec = qc_codec if graph == "qc" else std_codec
    res8 = _run(codec, dp_mesh(8))
    res1 = _run(codec, dp_mesh(1))
    res0 = _run(codec, None)
    assert int(res8.frames[0]) == 32
    for other in (res1, res0):
        for field in ("frames", "frame_errors", "data_bit_errors",
                      "uncoded_bit_errors", "decode_iters"):
            assert np.array_equal(
                np.asarray(getattr(res8, field)),
                np.asarray(getattr(other, field))), field
