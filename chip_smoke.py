"""Smoke run of the decoder's main paths on an NVIDIA GPU.

    python chip_smoke.py          five phases on one card
    python chip_smoke.py --four   the data-parallel Monte-Carlo path on
                                  four cards, against one card and no mesh

Phases (one process, full code sizes; only frame and SNR-point counts
are cut):

1. make_staged_decoder on the N=10000 (3,6) QC code (Z=1000), q4
   min-LUT, 50 iterations, designed at sigma=0.85: 8192 frames at 2 dB.
2. The ber_sim CLI on params/ber.ini.dvbs2.example (PEG N=64800), one
   SNR point, Nframes cut to 4096.
3. The ETSI DVB-S2 rate-1/2 matrix, QC-factored with its pinned phantom
   edge (core/dvbs2.py), 1024 frames.
4. Float BP (sum-product and min-sum) at N=64800 on the same matrix:
   the card against the CPU on the same frames.
5. de_sim with accelerator_sweep on params/de.ini.example, maxiter_de
   cut to 100: the card's f32 bracket must hold the host f64 threshold.

Phases 1-3 compare bits, ok and iters with LUTCodec.decode_ref exactly on
a subset of frames; the scalar golden model runs in CPU worker processes
that never import a GPU backend, while the card works on later phases.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
REF_FRAMES = 16  # frames per phase compared with decode_ref
# frames per call: phase 1, phase 2 (Monte-Carlo total and batch),
# phase 3, phase 4 (card; the CPU decodes the first bp_cpu of them), and
# per device and global batch on the four-card path
SIZES = dict(p1=8192, p2_frames=4096, p2_batch=512, p3=1024, p4=1024,
             bp_cpu=128, four_per_dev=2048)


# ---------------------------------------------------------------- golden
def _ref_init():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["OMP_NUM_THREADS"] = "1"


@functools.lru_cache(maxsize=4)
def _load_codec(path):
    from lut_ldpc_tpu.decoder import LUTCodec

    return LUTCodec.load(path)


def _ref_decode(path, llr_cha, llr_msg):
    """decode_ref of one frame in a CPU worker: (bits, signed iters)."""
    return _load_codec(path).decode_ref(llr_cha, llr_msg)


def ref_pool():
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = min(2 * REF_FRAMES, max(2, (os.cpu_count() or 4) - 2))
    return ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"),
        initializer=_ref_init)


def submit_refs(pool, codec, name, llr_cha, llr_msg):
    """Queue decode_ref of the first REF_FRAMES frames; returns a check
    function that compares them with the card's outputs."""
    import numpy as np

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, name)
    codec.save(path)
    lc = np.asarray(llr_cha)[:REF_FRAMES]
    lm = np.asarray(llr_msg)[:REF_FRAMES]
    futs = [pool.submit(_ref_decode, path + ".npz", lc[f], lm[f])
            for f in range(len(lc))]

    def check(bits, ok, iters):
        bits, ok, iters = (np.asarray(x) for x in (bits, ok, iters))
        for f, fut in enumerate(futs):
            want, want_it = fut.result()
            if not np.array_equal(bits[f], np.asarray(want)):
                raise AssertionError(f"{name}: frame {f} bits differ "
                                     "from decode_ref")
            if int(iters[f]) != abs(int(want_it)):
                raise AssertionError(f"{name}: frame {f} iters {iters[f]} "
                                     f"vs decode_ref {want_it}")
            if bool(ok[f]) != (want_it > 0):
                raise AssertionError(f"{name}: frame {f} ok {ok[f]} vs "
                                     f"decode_ref {want_it}")
        print(f"# {name}: {len(futs)} frames bit-identical to decode_ref "
              "(bits, ok, iters)", flush=True)

    return check


# ---------------------------------------------------------------- helpers
def frames_at(codec_or_graph, snr_db, B, seed, quantize=True):
    """(B, N) channel LLRs of the all-zero codeword over BPSK/AWGN."""
    import numpy as np

    from lut_ldpc_tpu.ops.pmf import snr2sig

    sig = float(snr2sig(0.5, snr_db))
    rng = np.random.default_rng(seed)
    y = 1.0 + sig * rng.standard_normal((B, codec_or_graph.nvar))
    llr = (2.0 * y / sig**2).astype(np.float32)
    return codec_or_graph.quantize_channel(llr) if quantize else llr


def compile_report(name, jitted, *args):
    """AOT-compile one decode step: prints compile seconds and the
    memory analysis, and checks the optimized HLO has no matrix product
    (so no TF32 rounding can enter the bit-exact comparison)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    print(f"# {name}: step compile {dt:.2f} s (persistent cache may be "
          f"warm); memory_analysis: {mem}", flush=True)
    hlo = compiled.as_text()
    bad = re.findall(r"= [^=\n]*\b(dot|convolution)\(|__cublas|gemm", hlo)
    if bad:
        raise AssertionError(f"{name}: decode HLO holds {sorted(set(bad))}")
    return compiled


def timed(fn, reps=3):
    import jax

    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn())
    return out, (time.perf_counter() - t0) / reps


def lut_phase(name, codec, B, snr_db, pool, card, seed):
    """Decode B frames with make_staged_decoder; queue the golden check."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lut_ldpc_tpu.decoder import make_staged_decoder

    t0 = time.perf_counter()
    dec = make_staged_decoder(codec, early_exit=True, max_batch=B)
    inner = getattr(dec, "inner", dec)
    chunk = getattr(dec, "chunk", B)
    print(f"# {name}: N={codec.nvar} E={codec.graph.num_edges} "
          f"{codec.max_iters} iters, decoder {type(dec).__name__}"
          f"({type(inner).__name__}, chunk {chunk}) built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lc_np, lm_np = frames_at(codec, snr_db, B, seed)
    check = submit_refs(pool, codec, name, lc_np, lm_np)
    lc = jnp.asarray(lc_np, jnp.int32)
    lm = jnp.asarray(lm_np, jnp.int32)
    t0 = time.perf_counter()
    out = jax.block_until_ready(dec(lc, lm))
    print(f"# {name}: compile + first call {time.perf_counter() - t0:.2f} s",
          flush=True)
    compile_report(name, inner._decode, lc[:chunk], lm[:chunk])
    out2, dt = timed(lambda: dec(lc, lm))
    for a, b in zip(out, out2):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{name}: repeated decode differs")
    bits, ok, iters = (np.asarray(x) for x in out)
    if bits.shape != (B, codec.nvar) or ok.shape != (B,) \
            or iters.shape != (B,):
        raise AssertionError(f"{name}: output shapes {bits.shape} "
                             f"{ok.shape} {iters.shape}")
    print(f"# {name}: {B} frames at {snr_db} dB in {dt * 1e3:.1f} ms "
          f"({B * codec.k / dt / 1e6:.1f} Mbit/s info), mean iters "
          f"{iters.mean():.2f}, ok {ok.mean():.4f} [{card}]", flush=True)
    return lambda: check(bits, ok, iters)


# ---------------------------------------------------------------- phases
def phase1(pool, card):
    from bench import build_codec

    return lut_phase("phase1_qc_n10000", build_codec(), SIZES["p1"], 2.0,
                     pool, card, seed=1)


def phase2(pool, card):
    import numpy as np

    from lut_ldpc_tpu.cli import ber_sim
    from lut_ldpc_tpu.decoder import LUTCodec

    os.makedirs(WORK, exist_ok=True)
    import configparser

    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.optionxform = str
    cp.read(os.path.join(HERE, "params", "ber.ini.dvbs2.example"))
    snr = 1.2
    codec_path = os.path.join(WORK, "phase2_peg_codec")
    cp["Sim"]["SNRdB"] = str(snr)
    cp["Sim"]["Nframes"] = str(SIZES["p2_frames"])
    cp["Sim"]["batch_size"] = str(SIZES["p2_batch"])
    cp["Sim"]["results_dir"] = os.path.join(WORK, "results")
    cp["Sim"]["codec_filename"] = codec_path + ".npz"
    cp["Sim"]["save_codec"] = "0"
    ini = os.path.join(WORK, "ber.ini.dvbs2.smoke")
    with open(ini, "w") as f:
        cp.write(f)
    res_dir = os.path.join(WORK, "results")
    shutil.rmtree(res_dir, ignore_errors=True)
    t0 = time.perf_counter()
    rc = ber_sim.main(["-p", ini, "-s", "0", "-b", HERE])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"ber_sim returned {rc}")
    files = [os.path.join(dp, fn) for dp, _, fns in os.walk(res_dir)
             for fn in fns if fn.endswith("_rseed0000.npz")]
    if len(files) != 1:
        raise AssertionError(f"ber_sim results: {files}")
    from lut_ldpc_tpu.sim.results import BERSimResults

    res = BERSimResults.load(files[0])
    frames = int(res.frames[0])
    ber = float(res.ber()[0])
    if frames != SIZES["p2_frames"] or not np.isfinite(ber) \
            or int(res.decode_iters[0]) <= 0:
        raise AssertionError(f"ber_sim: frames {frames}, BER {ber}, "
                             f"iters {res.decode_iters}")
    print(f"# phase2_ber_sim: CLI {dt:.2f} s wall (design, compile, "
          f"{frames} frames at {snr} dB): FER {float(res.fer()[0]):.3e} "
          f"BER {ber:.3e} mean iters "
          f"{int(res.decode_iters[0]) / frames:.2f} [{card}]", flush=True)
    codec = LUTCodec.load(codec_path + ".npz")
    return lut_phase("phase2_peg_n64800", codec, SIZES["p2_batch"], snr,
                     pool, card, seed=2)


def phase3(pool, card):
    from lut_ldpc_tpu.core.dvbs2 import load_periodic_alist
    from lut_ldpc_tpu.decoder import LUTCodec

    graph, _, _ = load_periodic_alist(
        os.path.join(HERE, "codes", "rate0.50_irreg_dvbs2_N64800.alist"))
    if graph.qc.Z != 360 or len(graph.phantoms) != 1:
        raise AssertionError("DVB-S2 QC factorization changed")
    codec = LUTCodec.design(graph, 0.90**2, max_iters=50, Nq_Cha=16,
                            Nq_Msg=16)
    return lut_phase("phase3_dvbs2_qc", codec, SIZES["p3"], 1.2, pool, card,
                     seed=3)


def phase4(card):
    """Float BP at N=64800, card against CPU on the same frames."""
    import math

    import jax
    import numpy as np

    from lut_ldpc_tpu.core.tanner import TannerGraph
    from lut_ldpc_tpu.decoder.bp import BPDecoder

    graph = TannerGraph.from_alist(
        os.path.join(HERE, "codes", "rate0.50_irreg_dvbs2_N64800.alist"))
    B, Bc, snr = SIZES["p4"], SIZES["bp_cpu"], 0.8
    llr = frames_at(graph, snr, B, seed=4, quantize=False)
    cpu = jax.devices("cpu")[0]
    for alg in ("spa", "minsum"):
        bp = BPDecoder(graph, max_iters=50, algorithm=alg)
        t0 = time.perf_counter()
        g = jax.block_until_ready(bp(llr))
        t_first = time.perf_counter() - t0
        compile_report(f"phase4_bp_{alg}", bp._decode, llr)
        g, dt = timed(lambda: bp(llr))
        t0 = time.perf_counter()
        with jax.default_device(cpu):
            bp_cpu = BPDecoder(graph, max_iters=50, algorithm=alg)
            c = jax.block_until_ready(bp_cpu(llr[:Bc]))
        t_cpu = time.perf_counter() - t0
        gb, gok, git = (np.asarray(x)[:Bc] for x in g)
        cb, cok, cit = (np.asarray(x) for x in c)
        fe_g, fe_c = int((~gok).sum()), int((~cok).sum())
        agree = float((gok == cok).mean())
        print(f"# phase4_bp_{alg}: N={graph.nvar} {B} frames at {snr} dB: "
              f"compile + first call {t_first:.2f} s, decode "
              f"{dt * 1e3:.1f} ms, mean iters {git.mean():.2f} [{card}]; "
              f"first {Bc} frames: errors card {fe_g} / CPU {fe_c} "
              f"(CPU {t_cpu:.1f} s), ok agreement {agree:.4f}", flush=True)
        if alg == "minsum":
            # no transcendental: the card must match the CPU exactly
            for a, b, what in ((gb, cb, "bits"), (gok, cok, "ok"),
                               (git, cit, "iters")):
                if not np.array_equal(a, b):
                    raise AssertionError(f"phase4 minsum: {what} differ")
        else:
            # f32 -log tanh rounds differently per backend: >= 99 % of
            # frames agree on ok, and the frame-error count lies in the
            # CPU count's binomial 95 % interval
            p = fe_c / Bc
            half = 1.96 * math.sqrt(Bc * p * (1 - p))
            if agree < 0.99 or abs(fe_g - fe_c) > half:
                raise AssertionError(
                    f"phase4 spa: agreement {agree}, FE {fe_g} vs {fe_c} "
                    f"(+- {half:.2f})")


def phase5(card):
    """de_sim with the accelerator sweep; the bracket holds the host
    threshold."""
    import configparser
    import contextlib
    import io

    from lut_ldpc_tpu.cli import de_sim

    os.makedirs(WORK, exist_ok=True)
    cp = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    cp.optionxform = str
    cp.read(os.path.join(HERE, "params", "de.ini.example"))
    results = os.path.join(WORK, "de_thresholds.txt")
    cp["Sim"]["maxiter_de"] = "100"
    cp["Sim"]["accelerator_sweep"] = "1"
    cp["Sim"]["results_name"] = results
    cp["Sim"]["ensemble_filename"] = os.path.join(
        HERE, cp["Sim"]["ensemble_filename"])
    ini = os.path.join(WORK, "de.ini.smoke")
    with open(ini, "w") as f:
        cp.write(f)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = de_sim.main(["-p", ini])
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"de_sim returned {rc}:\n{text}")
    m = re.search(r"accelerator bracket \[([^,]+), ([^\]]+)\]", text)
    with open(results) as f:
        t = re.search(r"Threshold\(s\) found = \[([^\]]+)\]", f.read())
    if m is None or t is None:
        raise AssertionError(f"de_sim output lacks bracket or threshold:\n"
                             f"{text}")
    lo, hi, thr = float(m.group(1)), float(m.group(2)), float(t.group(1))
    prec = float(cp["Sim"]["thr_prec"])
    print(f"# phase5_de_sim: maxiter_de 100, {dt:.2f} s wall: card bracket "
          f"[{lo:.6f}, {hi:.6f}], host f64 threshold {thr:.6f} [{card}]",
          flush=True)
    # a bisection confined to a window that misses the threshold ends on
    # the window's edge
    if not lo + prec < thr < hi - prec:
        raise AssertionError(f"phase5: threshold {thr} not inside "
                             f"[{lo}, {hi}]")


def run_one_card(card):
    with ref_pool() as pool:
        checks = [phase1(pool, card), phase2(pool, card), phase3(pool, card)]
        phase4(card)
        phase5(card)
        for check in checks:
            check()


def run_four(card):
    """BERSim over dp_mesh(4) against dp_mesh(1) and no mesh, same
    process: the Monte-Carlo counters must be identical."""
    import numpy as np

    from bench import build_codec
    from lut_ldpc_tpu.parallel import dp_mesh
    from lut_ldpc_tpu.sim import BERSim, BERSimConfig, LDPCConfig, SimConfig

    codec = build_codec()
    per_dev = SIZES["four_per_dev"]
    nframes = 4 * per_dev * 3
    fields = ("frames", "frame_errors", "data_bit_errors",
              "uncoded_bit_errors", "decode_iters")
    runs = {}
    for label, mesh in (("mesh4", dp_mesh(4)), ("mesh1", dp_mesh(1)),
                        ("nomesh", None)):
        cfg = BERSimConfig(
            sim=SimConfig(SNRdB=np.array([1.2]), Nframes=nframes,
                          Nfers=10**9, batch_size=per_dev),
            ldpc=LDPCConfig(zero_codeword=True))
        sim = BERSim(cfg, codec.graph, codec=codec, mesh=mesh)
        t0 = time.perf_counter()
        res = sim.run(seed=0, verbose=False)
        dt = time.perf_counter() - t0
        runs[label] = {f: np.asarray(getattr(res, f)).tolist() for f in fields}
        print(f"# four_{label}: {type(sim.decoder).__name__}, {nframes} "
              f"frames at 1.2 dB in {dt:.2f} s (compile included): "
              f"{runs[label]} [{card}]", flush=True)
    for other in ("mesh1", "nomesh"):
        if runs[other] != runs["mesh4"]:
            raise AssertionError(f"mesh4 counters {runs['mesh4']} != "
                                 f"{other} {runs[other]}")
    print("# four: mesh4 == mesh1 == nomesh counters, exactly", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    if args.four and len(devs) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 GPUs, found {len(devs)}")
    from bench import card_lines

    lines = card_lines()
    for ln in lines:
        print(ln)
    card = lines[0]
    print(f"# jax {jax.__version__}: platform {devs[0].platform}, "
          f"{devs[0].device_kind} x {len(devs)}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        run_four(card)
    else:
        run_one_card(card)
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
