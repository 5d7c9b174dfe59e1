"""DVB-S2-scale (N=64800) irregular decode throughput.

Compares the two constructions of the same rate-0.5 dv{2,3,9,17}/dc{8,9}
ensemble (the reference's flagship irregular profile, README.md:89-119):

- ``--code peg``: the unstructured PEG code (the reference's construction,
  peg/BigGirth.C).
- ``--code qc`` (default): the girth-8 irregular quasi-cyclic code
  (core/qc.py qc_generate_irregular).
- ``--code dvbs2`` / ``dvbs2-gather``: the ETSI standard matrix in its
  Z=360 QC factorization / unpermuted.

Identical ensemble => identical designed LUTs and matched BER physics
(examples/dvbs2_waterfall.py holds the waterfall evidence); the only
difference is the graph's permutation structure.

  python examples/bench_n64800.py [--code qc|peg] [--batch 1024]
      [--snr 1.6] [--reps 3] [--thr 0.90]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DVBS2_ALIST = os.path.join(ROOT, "codes", "rate0.50_irreg_dvbs2_N64800.alist")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="qc",
                    choices=["qc", "peg", "dvbs2", "dvbs2-gather"])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--snr", type=float, default=1.6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--thr", type=float, default=0.90)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lut_ldpc_tpu.core.qc import load_qc, qc_expand
    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder import LUTCodec, make_staged_decoder
    from lut_ldpc_tpu.ops.pmf import snr2sig

    t0 = time.perf_counter()
    if args.code == "qc":
        graph = qc_expand(load_qc(os.path.join(
            ROOT, "codes", "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")))
    elif args.code == "dvbs2":
        # the ETSI standard matrix, permuted to its Z=360 QC form with
        # one phantom completion (core/dvbs2.py)
        from lut_ldpc_tpu.core.dvbs2 import load_periodic_alist

        graph, _, _ = load_periodic_alist(DVBS2_ALIST)
    elif args.code == "dvbs2-gather":
        # the same standard matrix decoded unpermuted
        graph = TannerGraph.from_alist(DVBS2_ALIST)
    else:
        graph = TannerGraph.from_alist(os.path.join(
            ROOT, "codes", "rate0.50_dv02-17_dc08-09_lut_q4_N64800.alist"))
    print(f"# graph loaded in {time.perf_counter()-t0:.1f}s "
          f"(nvar={graph.nvar}, nchk={graph.nchk})", file=sys.stderr)

    t0 = time.perf_counter()
    codec = LUTCodec.design(graph, args.thr**2, max_iters=args.iters,
                            Nq_Cha=16, Nq_Msg=16)
    print(f"# codec designed in {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    dec = make_staged_decoder(codec, early_exit=True, max_batch=args.batch)
    inner = getattr(dec, "inner", dec)
    print(f"# decoder: {type(dec).__name__} (inner {type(inner).__name__}, "
          f"dtype {getattr(inner, '_dtype_np', '?')}) "
          f"built in {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    B = args.batch
    sig = float(snr2sig(0.5, args.snr))
    rng = np.random.default_rng(0)
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    llr = 2.0 * y / sig**2
    llr_cha, llr_msg = codec.quantize_channel(llr)
    llr_cha = jnp.asarray(llr_cha, jnp.int8)
    llr_msg = jnp.asarray(llr_msg, jnp.int8)

    t0 = time.perf_counter()
    out = jax.block_until_ready(dec(llr_cha, llr_msg))
    print(f"# compile+first run {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = jax.block_until_ready(dec(llr_cha, llr_msg))
    dt = (time.perf_counter() - t0) / args.reps
    iters_mean = float(np.asarray(out[2]).mean())
    ok = float(np.asarray(out[1]).mean())
    mbits = B * codec.k / dt / 1e6
    print(f"# mean iters {iters_mean:.1f}, ok {ok:.4f}", file=sys.stderr)
    print(f"# {B} frames/{dt*1e3:.1f} ms -> {mbits:.1f} Mbit/s info",
          file=sys.stderr)
    print(json.dumps({
        "metric": f"n64800_{args.code}_decode_info_throughput",
        "value": round(mbits, 2), "unit": "Mbit/s",
        "snr_db": args.snr, "batch": B, "mean_iters": round(iters_mean, 1),
        "ok": ok,
    }))


if __name__ == "__main__":
    main()
