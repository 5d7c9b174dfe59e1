"""Headline benchmark: LUT decoder throughput on the north-star config.

Config per BASELINE.json: N=10000 rate-0.5 (3,6) code, 4-bit min-LUT decoder,
50 iterations, batched Monte-Carlo decode on one GPU.  Metric: decoded
information throughput (Mbit/s of systematic bits through the full decode).

Fails unless JAX's default device is a GPU.  Prints the device and the
card's name and power limit, then one JSON line:
{"metric", "value", "unit", "device"}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def card_lines() -> list[str]:
    """`nvidia-smi` name and power limit, one line per card (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def build_codec(nvar=10000, max_iters=50):
    """(3,6) N=10000 4-bit min-LUT codec designed at sigma=0.85, just below
    the 50-iteration q4 min-LUT DE threshold 0.8595 (measured with our
    de_sim; the reference designs at/near threshold, cf.
    params/ber.ini.irregular.example design_thr)."""
    from lut_ldpc_tpu.core.alist import read_alist
    from lut_ldpc_tpu.core.qc import load_qc, qc_expand
    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder import LUTCodec
    from lut_ldpc_tpu.ops.pmf import snr2sig

    here = os.path.dirname(os.path.abspath(__file__))
    qc_json = os.path.join(here, "codes", "rate0.50_dv03_dc06_N10000_qc.qc.json")
    own_alist = os.path.join(here, "codes", "rate0.50_dv03_dc06_N10000.alist")
    if os.path.exists(qc_json) and nvar == 10000 and not os.environ.get(
            "BENCH_NO_QC"):
        # girth-8 quasi-cyclic (3,6) code (core/qc.py): same N/rate/ensemble
        # => identical designed LUTs
        graph = qc_expand(load_qc(qc_json))
    elif os.path.exists(own_alist) and nvar == 10000:
        graph = TannerGraph.from_dense(read_alist(own_alist))
    else:
        rng = np.random.default_rng(1)
        dv, dc = 3, 6
        nchk = nvar * dv // dc
        var_sockets = np.repeat(np.arange(nvar), dv)
        chk_sockets = np.repeat(np.arange(nchk), dc)
        for _ in range(50):
            perm = rng.permutation(len(var_sockets))
            pairs = set(zip(var_sockets.tolist(), chk_sockets[perm].tolist()))
            if len(pairs) == len(var_sockets):
                break
        H = np.zeros((nchk, nvar), dtype=np.uint8)
        for v, c in pairs:
            H[c, v] = 1
        graph = TannerGraph.from_dense(H)
    design_thr = 0.85
    return LUTCodec.design(
        graph, design_thr**2, max_iters=max_iters, Nq_Cha=16, Nq_Msg=16
    )


def main():
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {devs[0].platform!r}")
    for ln in card_lines():
        print(ln)
    device = dict(platform=devs[0].platform, kind=devs[0].device_kind,
                  count=len(devs))
    print(f"# device: {device}")

    from lut_ldpc_tpu.decoder import make_staged_decoder
    from lut_ldpc_tpu.ops.pmf import snr2sig

    B = int(os.environ.get("BENCH_BATCH", "8192"))
    iters_timed = int(os.environ.get("BENCH_REPS", "5"))

    t0 = time.perf_counter()
    codec = build_codec()
    t_design = time.perf_counter() - t0
    print(f"# codec designed in {t_design:.1f}s "
          f"(N={codec.nvar}, {codec.max_iters} iters)", file=sys.stderr)

    # per-frame early-exit semantics (identical outputs to the
    # reference's psc early exit), so throughput tracks mean iterations
    dec = make_staged_decoder(codec, early_exit=True, max_batch=B)
    print(f"# decoder: {type(dec).__name__}", file=sys.stderr)
    sig = float(snr2sig(0.5, 2.0))
    rng = np.random.default_rng(0)
    y = 1.0 + sig * rng.standard_normal((B, codec.nvar))
    llr = 2.0 * y / sig**2
    llr_cha, llr_msg = codec.quantize_channel(llr)
    llr_cha = jnp.asarray(llr_cha, jnp.int32)
    llr_msg = jnp.asarray(llr_msg, jnp.int32)

    # warmup / compile (twice: a host-staged decoder adapts its stage
    # plan to the observed iteration distribution after the first call)
    t0 = time.perf_counter()
    out = jax.block_until_ready(dec(llr_cha, llr_msg))
    out = jax.block_until_ready(dec(llr_cha, llr_msg))
    print(f"# compile+first runs {time.perf_counter() - t0:.1f}s "
          f"(stages: {getattr(dec, 'stage_iters', None)})", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(iters_timed):
        out = jax.block_until_ready(dec(llr_cha, llr_msg))
    dt = (time.perf_counter() - t0) / iters_timed
    iters_mean = float(np.asarray(out[2]).mean())
    print(f"# mean decode iterations {iters_mean:.1f}, ok {np.asarray(out[1]).mean():.4f}",
          file=sys.stderr)

    info_bits = B * codec.k
    mbits = info_bits / dt / 1e6
    print(f"# {B} frames/{dt * 1e3:.1f} ms -> {mbits:.1f} Mbit/s info", file=sys.stderr)
    print(json.dumps({
        "metric": "lut_decode_info_throughput",
        "value": mbits,
        "unit": "Mbit/s",
        "device": device,
    }))


if __name__ == "__main__":
    main()
