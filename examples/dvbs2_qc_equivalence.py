"""Statistical BER/FER equivalence of the two DVB-S2 realizations.

The ETSI standard matrix decodes either unpermuted (row-gather path) or
in its Z=360 QC factorization (core/dvbs2.py).  The QC
realization is the same code up to bit relabeling, with LUT-tree leaf
order following circulant slot order — frame-level outcomes differ, the
waterfall must not.  This runs both realizations with the IDENTICAL
design (the ensemble-determined LUTs are the same; only the graph
realization differs) over the cliff region and reports counters plus a
two-sided binomial z-score per point.

  python examples/dvbs2_qc_equivalence.py [--frames 10240] [--batch 1024]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIST = os.path.join(ROOT, "codes", "rate0.50_irreg_dvbs2_N64800.alist")


def run(graph, snrs, frames, batch, thr):
    from lut_ldpc_tpu.decoder import LUTCodec
    from lut_ldpc_tpu.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    codec = LUTCodec.design(graph, thr ** 2, max_iters=50, Nq_Cha=16,
                            Nq_Msg=16)
    cfg = BERSimConfig(
        sim=SimConfig(SNRdB=np.asarray(snrs), Nframes=frames, Nfers=10 ** 9,
                      batch_size=batch, ber_min=0.0, fer_min=0.0),
        ldpc=LDPCConfig(zero_codeword=True),
    )
    t0 = time.perf_counter()
    res = BERSim(cfg, graph, codec=codec).run(seed=0)
    dt = time.perf_counter() - t0
    return res, dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10240)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--thr", type=float, default=0.90)
    ap.add_argument("--snr", default="1.6,1.8,2.0")
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "waterfall"))
    args = ap.parse_args()
    snrs = [float(s) for s in args.snr.split(",")]

    from lut_ldpc_tpu.core.dvbs2 import load_periodic_alist
    from lut_ldpc_tpu.core.tanner import TannerGraph

    gq, _, _ = load_periodic_alist(ALIST)
    print("# QC realization (fused kernels)...", file=sys.stderr)
    rq, tq = run(gq, snrs, args.frames, args.batch, args.thr)
    gg = TannerGraph.from_alist(ALIST)
    print("# gather realization...", file=sys.stderr)
    rg, tg = run(gg, snrs, args.frames, args.batch, args.thr)

    payload = {"snr_db": snrs, "frames": int(args.frames),
               "design_thr": args.thr,
               "qc": {"fer": [float(x) for x in rq.fer()],
                      "ber": [float(x) for x in rq.ber()],
                      "frame_errors": [int(x) for x in rq.frame_errors],
                      "runtime_s": round(tq, 1)},
               "gather": {"fer": [float(x) for x in rg.fer()],
                          "ber": [float(x) for x in rg.ber()],
                          "frame_errors": [int(x) for x in rg.frame_errors],
                          "runtime_s": round(tg, 1)}}
    # two-proportion z-score on FER per point
    zs = []
    for i in range(len(snrs)):
        n = args.frames
        k1, k2 = payload["qc"]["frame_errors"][i], \
            payload["gather"]["frame_errors"][i]
        p = (k1 + k2) / (2 * n)
        se = np.sqrt(max(p * (1 - p) * 2 / n, 1e-30))
        zs.append(float((k1 / n - k2 / n) / se) if p > 0 else 0.0)
    payload["fer_z_scores"] = [round(z, 2) for z in zs]
    out = os.path.join(args.out, "dvbs2_qc_equivalence.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload, indent=1))
    print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
