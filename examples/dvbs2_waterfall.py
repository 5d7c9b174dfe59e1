"""DVB-S2-scale (N=64800) BER waterfalls — BASELINE.json config 4.

Two codes, three runs:

1. `lut64800`: full q4 min-LUT waterfall on the LUT-optimized irregular
   dv{2,3,9,17}/dc{8,9} PEG code at N=64800 (the ensemble whose published
   threshold sigma* = 0.929193 the design reproduces exactly).  This is
   the "full BER waterfall at DVB-S2 scale" acceptance config.
2. `dvbs2_spa`: float sum-product on the *standard DVB-S2 matrix*
   (codes/rate0.50_irreg_dvbs2_N64800.alist) near 1 dB — the profile's
   natural operating point under BP.
1b. `lut64800_qc`: the same q4 min-LUT waterfall on the girth-8 irregular
   QUASI-CYCLIC N=64800 code built for the same ensemble
   (core/qc.py qc_generate_irregular; codes/rate0.50_dv02-17_dc08-09_
   N64800_qc.qc.json).  Identical ensemble => identical designed LUTs;
   this run is the BER-parity evidence that the QC construction matches
   the reference-style PEG construction.

3. `dvbs2_lut`: q4 min-LUT designed on the standard matrix itself (the
   reference cannot do this at all — its tree generators assert
   num_leaves >= 2 while this matrix has a degree-1 accumulator tail).
   Density evolution puts the profile's lambda_2 = 0.2857 far above the
   min-LUT stability limit lambda_2* ~ 0.167 (get_lam2stable_lut), so
   the strict-Pe_max DE threshold is pessimistic (sigma* = 0.684,
   3.3 dB: DE retains a tiny nonzero Pe fixed point at every sigma).
   The MEASURED finite-length behavior is far better: the 0.8-3.0 dB
   sweep (>=10k real frames per point, skipping disabled) shows a sharp
   cliff at 1.6-1.8 dB — ~0.8 dB from the float-SPA baseline's cliff on
   the same matrix — and bounds the stability floor below FER 4.9e-5 /
   BER 1.5e-9 at 1.8-3.0 dB (zero errors in 20480 frames per point).
   The stored artifact carries the lambda_2 numbers alongside the
   curve.

  python examples/dvbs2_waterfall.py [--run lut64800|dvbs2_spa|dvbs2_lut]
         [--frames 100000] [--out docs/waterfall]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(tag, graph, snr, frames, batch, out_dir, codec=None, bp=None,
            nfers=200, ber_min=1e-8, fer_min=1e-10):
    from lut_ldpc_tpu.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.asarray(snr, dtype=np.float64), Nframes=frames,
                      Nfers=nfers, batch_size=batch, ber_min=ber_min,
                      fer_min=fer_min, results_dir=out_dir),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    sim = BERSim(cfg, graph, codec=codec, bp_decoder=bp)
    t0 = time.time()
    res = sim.run(seed=0)
    dt = time.time() - t0
    res.save(os.path.join(out_dir, tag))
    res.save_itfile(os.path.join(out_dir, f"{tag}.it"))
    payload = {
        "snr_db": [float(x) for x in snr],
        "frames": [int(x) for x in res.frames],
        "frame_errors": [int(x) for x in res.frame_errors],
        "ber": [float(x) for x in res.ber()],
        "fer": [float(x) for x in res.fer()],
        "runtime_s": round(dt, 1),
    }
    print(tag, json.dumps(payload, indent=1))
    return payload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="lut64800",
                    choices=["lut64800", "lut64800_qc", "dvbs2_spa",
                             "dvbs2_lut", "dvbs2_lut_qc"])
    ap.add_argument("--frames", type=int, default=100000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "waterfall"))
    ap.add_argument("--snr", default="")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder import LUTCodec
    from lut_ldpc_tpu.decoder.bp import BPDecoder
    from lut_ldpc_tpu.sim.config import _parse_range

    os.makedirs(args.out, exist_ok=True)

    if args.run in ("lut64800", "lut64800_qc"):
        if args.run == "lut64800_qc":
            from lut_ldpc_tpu.core.qc import load_qc, qc_expand

            graph = qc_expand(load_qc(os.path.join(
                ROOT, "codes", "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")))
            tag = "lut_dv02-17_N64800_qc_q4"
        else:
            graph = TannerGraph.from_alist(os.path.join(
                ROOT, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist"))
            tag = "lut_dv02-17_N64800_q4"
        snr = _parse_range(args.snr or "0.8:0.2:1.6")
        print("designing q4 min-LUT codec at thr 0.90 (50 iters)...")
        codec = LUTCodec.design(graph, 0.90**2, max_iters=50, Nq_Cha=16,
                                Nq_Msg=16)
        run_one(tag, graph, snr, args.frames, args.batch,
                args.out, codec=codec)
    elif args.run == "dvbs2_spa":
        graph = TannerGraph.from_alist(os.path.join(
            ROOT, "codes", "rate0.50_irreg_dvbs2_N64800.alist"))
        snr = _parse_range(args.snr or "0.6:0.2:1.4")
        run_one("dvbs2_N64800_spa", graph, snr, args.frames, args.batch,
                args.out, bp=BPDecoder(graph, 50, algorithm="spa"))
    else:
        if args.run == "dvbs2_lut_qc":
            # the SAME standard matrix in its Z=360 QC factorization
            # (core/dvbs2.py): statistically identical code, fused-kernel
            # decode path; design parameters identical to dvbs2_lut
            from lut_ldpc_tpu.core.dvbs2 import load_periodic_alist

            graph, _, _ = load_periodic_alist(os.path.join(
                ROOT, "codes", "rate0.50_irreg_dvbs2_N64800.alist"))
        else:
            graph = TannerGraph.from_alist(os.path.join(
                ROOT, "codes", "rate0.50_irreg_dvbs2_N64800.alist"))
        # the honest evaluation region: from the SPA baseline's operating
        # zone (~1 dB cliff) through the measured min-LUT cliff
        # (1.4-1.8 dB) into the floor region (2.0-3.0 dB probed with full
        # frame budgets; ber_min/fer_min skipping disabled so every point
        # holds real frames).  The DE threshold with a strict Pe_max is
        # sigma* = 0.684 (3.3 dB) because the stability-violating
        # lambda_2 leaves a tiny nonzero Pe fixed point — the measured
        # curve shows that fixed point is below finite-length resolution.
        snr = _parse_range(
            args.snr or "0.8 1.0 1.2 1.4 1.5 1.6 1.7 1.8 2.0 2.5 3.0")
        qc_tag = "_qc" if args.run == "dvbs2_lut_qc" else ""
        cache = os.path.join(args.out,
                             f"dvbs2_N64800_lut_q4{qc_tag}_codec.npz")
        if os.path.exists(cache):
            print("loading cached codec ...")
            codec = LUTCodec.load(cache)
        else:
            print("designing q4 min-LUT codec on the standard matrix "
                  "(thr 0.67, stability-limited profile)...")
            codec = LUTCodec.design(graph, 0.67**2, max_iters=50, Nq_Cha=16,
                                    Nq_Msg=16)
            codec.save(cache)
        payload = run_one(f"dvbs2_N64800_lut_q4{qc_tag}", graph, snr,
                          args.frames,
                          args.batch, args.out, codec=codec,
                          nfers=max(10000, args.frames // 2),
                          ber_min=0.0, fer_min=0.0)
        # append the stability analysis that explains the curve: the
        # profile's degree-2 edge mass vs the q4 min-LUT stable limit
        # (design/de.py get_lam2stable_lut; reference LDPC_DE.cpp:1575)
        from lut_ldpc_tpu.design.de import get_lam2stable_lut
        from lut_ldpc_tpu.ops.pmf import sig2snr, snr2sig

        ens = graph.empirical_ensemble()
        lam2 = float(dict(zip(ens.degree_lam.tolist(),
                              ens.lam.tolist())).get(2, 0.0))
        sig_op = float(snr2sig(0.5, 1.0))
        lam2_star = float(get_lam2stable_lut(
            sig_op, ens.chk_degree_dist_dense(), 16, 16))
        payload.update(lam2=lam2, lam2_stable_at_1dB=lam2_star,
                       design_thr=0.67, thr_sigma=0.684,
                       thr_snr_db=round(float(sig2snr(0.5, 0.684)), 2))
        out_json = os.path.join(args.out,
                                f"dvbs2_N64800_lut_q4{qc_tag}.json")
        with open(out_json, "w") as f:
            json.dump(payload, f, indent=1)
        print("stability:", {"lam2": lam2, "lam2*": lam2_star})


if __name__ == "__main__":
    main()
