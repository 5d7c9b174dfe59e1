"""Monte-Carlo BER/FER simulation harness (the equivalent of LDPC_BER_Sim).

Where the reference decodes one frame at a time and scales out by launching
one process per seed (its src/LDPC_BER_Sim.cpp:246-311, README.md:54),
this harness decodes a *batch* of frames per device step and scales out
data-parallel over a jax device mesh (frames sharded, counters gathered
in-program) — the replacement for the offline per-seed result merging of
scripts/aggregate_results.m.

Semantics preserved from the reference:
- per-SNR frame budget Nframes, early stop at Nfers frame errors (at batch
  granularity), skip-remaining-SNRs below ber_min/fer_min with explicit
  zero-padded points (cpp:289, 307-310, 142-149);
- counters: data-bit errors over the K systematic bits, frame errors per
  K-block, uncoded slicer errors over all N coded bits (cpp:280-291);
- deterministic seeding: counter-based keys fold_in(seed, snr index, batch
  index, device index) replace the RNG_reset(seed+offset) convention.
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

from ..core.alist import read_alist
from ..core.tanner import TannerGraph
from ..decoder.bp import BPDecoder
from ..decoder.codec import LUTCodec
from ..decoder.fast_decoder import make_decoder
from ..ops.pmf import snr2sig
from .channel import bpsk_awgn_llr
from .config import BERSimConfig
from .results import BERSimResults, git_version

__all__ = ["BERSim", "run_from_config"]


class BERSim:
    """Monte-Carlo simulator for one decoder over an SNR grid.

    decoder_kind: 'lut' (needs codec) or 'bp' (needs bp_decoder).
    """

    def __init__(
        self,
        config: BERSimConfig,
        graph: TannerGraph,
        codec: LUTCodec | None = None,
        bp_decoder: BPDecoder | None = None,
        mesh: jax.sharding.Mesh | None = None,
        gen_T: np.ndarray | None = None,
    ):
        self.config = config
        self.graph = graph
        self.codec = codec
        self.bp = bp_decoder
        self.mesh = mesh
        if (codec is None) == (bp_decoder is None):
            raise ValueError("provide exactly one of codec / bp_decoder")
        self.zero_codeword = config.ldpc.zero_codeword
        # systematic generator: explicit (BP sims) or the codec's
        self.gen_T = gen_T if gen_T is not None else (
            None if codec is None else codec.gen_T)
        if not self.zero_codeword:
            if self.gen_T is None:
                raise ValueError("non-zero codewords require a generator")
            self.k = graph.nvar - int(np.asarray(self.gen_T).shape[1])
        else:
            # rank assumed full for zero-codeword runs (no generator needed)
            self.k = codec.k if codec is not None else graph.nvar - graph.nchk
        self.rate = self.k / graph.nvar
        if codec is not None:
            if mesh is None and config.ldpc.parity_check_iter:
                # staged decoding (host-side stage orchestration) — exact,
                # and cost tracks mean iterations like the reference's
                # per-frame early exit
                from ..decoder.staged import make_staged_decoder

                self.decoder = make_staged_decoder(
                    codec, early_exit=True,
                    max_batch=config.sim.batch_size,
                )
            else:
                self.decoder = make_decoder(
                    codec, early_exit=config.ldpc.parity_check_iter
                )
        else:
            self.decoder = bp_decoder
        if mesh is None:
            self._step = self._build_split_step()
        else:
            self._step = self._build_step()

    # ------------------------------------------------------------------
    def _build_step(self):
        B = self.config.sim.batch_size
        nvar = self.graph.nvar
        k = self.k
        codec = self.codec
        zero_cw = self.zero_codeword

        if codec is not None:
            qb_cha = jnp.asarray(codec.qb_Cha)
            qb_msg = jnp.asarray(codec.qb_Msg)
            cha2msg = jnp.asarray(codec.cha2msg_map, dtype=jnp.int32)
            use_qcha = codec.initial_message_mode == "qcha"
        gen_T = None if self.gen_T is None else jnp.asarray(self.gen_T, jnp.int32)

        def step(key, sigma):
            """One batch: returns int32 counter dict."""
            kbits, knoise = jax.random.split(key)
            if zero_cw:
                u = jnp.zeros((B, k), dtype=jnp.uint8)
                x = jnp.zeros((B, nvar), dtype=jnp.uint8)
            else:
                u = jax.random.bernoulli(kbits, 0.5, (B, k)).astype(jnp.uint8)
                parity = (
                    jax.lax.dot_general(
                        u.astype(jnp.int32), gen_T,
                        (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32,
                    )
                    & 1
                ).astype(jnp.uint8)
                x = jnp.concatenate([u, parity], axis=-1)
            llr, y = bpsk_awgn_llr(knoise, x, sigma)
            slicer = (y < 0).astype(jnp.uint8)

            if codec is not None:
                llr_cha = jnp.searchsorted(qb_cha, llr, side="left").astype(jnp.int32)
                if use_qcha:
                    llr_msg = cha2msg[llr_cha]
                else:
                    llr_msg = jnp.searchsorted(qb_msg, llr, side="left").astype(jnp.int32)
                bits, ok, iters = self.decoder._decode(llr_cha, llr_msg)
            else:
                bits, ok, iters = self.decoder._decode(llr)

            data_err = jnp.sum(bits[:, :k] != u, axis=-1)  # (B,)
            return dict(
                frames=jnp.int32(B),
                data_bits=jnp.int32(B * k),
                uncoded_bits=jnp.int32(B * nvar),
                frame_errors=jnp.sum(data_err > 0, dtype=jnp.int32),
                data_bit_errors=jnp.sum(data_err, dtype=jnp.int32),
                uncoded_bit_errors=jnp.sum(slicer != x, dtype=jnp.int32),
                decode_iters=jnp.sum(iters, dtype=jnp.int32),
            )

        # unwrapped per-device step: callers may re-shard it, e.g. over a
        # 2-D (snr x batch) mesh via parallel.make_dp_step_2d (run() itself
        # sweeps SNR sequentially with a 1-D frame-parallel mesh)
        self._step_raw = step
        if self.mesh is not None:
            from ..parallel import make_dp_step

            return make_dp_step(step, self.mesh)
        return jax.jit(step)

    def _build_split_step(self):
        """Generate/count as jits with the decoder called in between —
        required for staged decoders (host-side stage orchestration)."""
        B = self.config.sim.batch_size
        nvar = self.graph.nvar
        k = self.k
        codec = self.codec
        zero_cw = self.zero_codeword

        if codec is not None:
            qb_cha = jnp.asarray(codec.qb_Cha)
            qb_msg = jnp.asarray(codec.qb_Msg)
            cha2msg = jnp.asarray(codec.cha2msg_map, dtype=jnp.int32)
            use_qcha = codec.initial_message_mode == "qcha"
        gen_T = None if self.gen_T is None else jnp.asarray(self.gen_T, jnp.int32)

        @jax.jit
        def gen(key, sigma):
            kbits, knoise = jax.random.split(key)
            if zero_cw:
                u = jnp.zeros((B, k), dtype=jnp.uint8)
                x = jnp.zeros((B, nvar), dtype=jnp.uint8)
            else:
                u = jax.random.bernoulli(kbits, 0.5, (B, k)).astype(jnp.uint8)
                parity = (
                    jax.lax.dot_general(
                        u.astype(jnp.int32), gen_T,
                        (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32,
                    )
                    & 1
                ).astype(jnp.uint8)
                x = jnp.concatenate([u, parity], axis=-1)
            llr, y = bpsk_awgn_llr(knoise, x, sigma)
            out = dict(u=u, x=x, slicer=(y < 0).astype(jnp.uint8))
            if codec is not None:
                llr_cha = jnp.searchsorted(qb_cha, llr, side="left").astype(jnp.int32)
                if use_qcha:
                    llr_msg = cha2msg[llr_cha]
                else:
                    llr_msg = jnp.searchsorted(qb_msg, llr, side="left").astype(
                        jnp.int32
                    )
                out["llr_cha"] = llr_cha
                out["llr_msg"] = llr_msg
            else:
                out["llr"] = llr
            return out

        @jax.jit
        def count(bits, iters, u, x, slicer):
            data_err = jnp.sum(bits[:, :k] != u, axis=-1)
            return dict(
                frames=jnp.int32(B),
                data_bits=jnp.int32(B * k),
                uncoded_bits=jnp.int32(B * nvar),
                frame_errors=jnp.sum(data_err > 0, dtype=jnp.int32),
                data_bit_errors=jnp.sum(data_err, dtype=jnp.int32),
                uncoded_bit_errors=jnp.sum(slicer != x, dtype=jnp.int32),
                decode_iters=jnp.sum(iters, dtype=jnp.int32),
            )

        def step(key, sigma):
            g = gen(key, sigma)
            if codec is not None:
                bits, ok, iters = self.decoder(g["llr_cha"], g["llr_msg"])
            else:
                bits, ok, iters = self.decoder(g["llr"])
            return count(jnp.asarray(bits), jnp.asarray(iters), g["u"], g["x"],
                         g["slicer"])

        return step

    # ------------------------------------------------------------------
    def run(self, seed: int | None = None, verbose: bool = True,
            checkpoint_path: str | None = None,
            checkpoint_every: int = 50) -> BERSimResults:
        """Monte-Carlo sweep.  With checkpoint_path, counter state is
        persisted every checkpoint_every batches and at each SNR point;
        a rerun resumes exactly (counter-based RNG keys make the
        continuation bit-identical to an uninterrupted run)."""
        import json
        import os

        cfg = self.config.sim
        if seed is None:
            seed = cfg.rand_seed
        base_key = jax.random.PRNGKey(seed + cfg.rand_seed_offset)
        snr_db = np.asarray(cfg.SNRdB, dtype=np.float64)
        results = BERSimResults(
            snr_db=snr_db,
            nvar=self.graph.nvar,
            nchk=self.graph.nchk,
            rate=self.rate,
            gitversion=git_version(),
        )
        start_ss, start_bb = 0, 0
        skip_rest = False
        if checkpoint_path and os.path.exists(checkpoint_path):
            results = BERSimResults.load(checkpoint_path)
            with open(checkpoint_path + ".state") as f:
                st = json.load(f)
            start_ss, start_bb = st["ss"], st["bb"]
            skip_rest = st.get("skip_rest", False)
            if verbose:
                print(f"resuming from SNR index {start_ss}, batch {start_bb}")

        def save_ckpt(ss, bb):
            if not checkpoint_path:
                return
            results.save(checkpoint_path.removesuffix(".npz"))
            with open(checkpoint_path + ".state", "w") as f:
                json.dump({"ss": ss, "bb": bb, "skip_rest": skip_rest}, f)

        # optional jax profiler capture (LUT_PROFILE_DIR=<dir> writes the
        # sweep's device trace for xprof/tensorboard; use a small config)
        profile_dir = os.environ.get("LUT_PROFILE_DIR")
        if profile_dir:
            jax.profiler.start_trace(profile_dir)

        t0 = time.perf_counter()
        for ss, snr in enumerate(snr_db):
            if ss < start_ss:
                continue
            if skip_rest:
                continue  # zero-padded point (LDPC_BER_Sim.cpp:142-149)
            sigma = float(snr2sig(self.rate, snr))
            key_snr = jax.random.fold_in(base_key, ss)
            frames = int(results.frames[ss])
            ferrs = int(results.frame_errors[ss])
            bb = start_bb if ss == start_ss else 0
            # bb counts GLOBAL batches: per-batch keys are
            # fold_in(key_snr, bb) on every path, and a mesh runs batches
            # [bb, bb + n_dev) concurrently returning per-device counter
            # vectors in global-batch order — the host applies the
            # sequential early-exit rules below exactly as a
            # single-device run would, so counters (and checkpoints) are
            # invariant to the mesh size (surplus in-flight batches past
            # a stop point are computed but never counted)
            n_dev = 1
            if self.mesh is not None:
                n_dev = int(np.prod(list(self.mesh.shape.values())))
            while frames < cfg.Nframes and ferrs <= cfg.Nfers:
                if self.mesh is None:
                    c = self._step(jax.random.fold_in(key_snr, bb), sigma)
                    batch_counts = [{kk: int(v) for kk, v in c.items()}]
                else:
                    cv = self._step(key_snr, sigma, jnp.int32(bb))
                    cv = {kk: np.asarray(v) for kk, v in cv.items()}
                    batch_counts = [
                        {kk: int(v[j]) for kk, v in cv.items()}
                        for j in range(n_dev)
                    ]
                for c in batch_counts:
                    if not (frames < cfg.Nframes and ferrs <= cfg.Nfers):
                        break
                    results.add_counts(
                        ss, c["frames"], c["data_bits"], c["uncoded_bits"],
                        c["frame_errors"], c["data_bit_errors"],
                        c["uncoded_bit_errors"], c.get("decode_iters", 0),
                    )
                    frames += c["frames"]
                    ferrs += c["frame_errors"]
                    bb += 1
                    if checkpoint_path and bb % checkpoint_every == 0:
                        save_ckpt(ss, bb)
            if verbose:
                print(
                    f"SNR = {snr:g}  frames {results.frames[ss]}  "
                    f"data BER {results.ber()[ss]:.3e}  "
                    f"uncoded BER {results.uncoded_ber()[ss]:.3e}  "
                    f"FER {results.fer()[ss]:.3e}",
                    flush=True,
                )
            ber = results.ber()[ss]
            fer = results.fer()[ss]
            if ber < cfg.ber_min or fer < cfg.fer_min:
                skip_rest = True
            save_ckpt(ss + 1, 0)
        results.runtime = time.perf_counter() - t0
        if profile_dir:
            jax.profiler.stop_trace()
        return results


def run_from_config(
    config: BERSimConfig,
    codes_root: str = ".",
    seed: int | None = None,
    mesh=None,
    verbose: bool = True,
):
    """Load-design-run per the INI config (the ber_sim CLI body,
    prog/ber_sim.cpp:133-154 + LDPC_BER_Sim::load cpp:157-244, 434-550).

    Returns (results, sim) — saving is the caller's business.
    """
    import os

    codec = None
    bp = None
    gen_T = None
    if config.sim.codec_filename and os.path.exists(config.sim.codec_filename):
        codec = LUTCodec.load(config.sim.codec_filename)
        graph = codec.graph
    else:
        alist = config.ldpc.parity_filename
        if not os.path.isabs(alist):
            alist = os.path.join(codes_root, config.sim.codes_dir, alist)
        if not alist.endswith(".alist"):
            alist += ".alist"
        graph = None
        if config.ldpc.qc_detect:
            from ..core.dvbs2 import load_periodic_alist

            try:
                Zd = config.ldpc.qc_detect_Z
                graph, _, _ = load_periodic_alist(alist, Zd)
                if verbose:
                    print(f"QC structure detected (Z={Zd}) in "
                          f"{os.path.basename(alist)}")
            except ValueError:
                pass
        if graph is None:
            H = read_alist(alist)
            graph = TannerGraph.from_dense(H)

    if config.codec_type == "LUT":
        lut = config.lut
        if codec is None:
            if lut.design_thr > 0:
                sig = lut.design_thr
            else:
                ens = graph.empirical_ensemble()
                sig = float(snr2sig(ens.rate(), lut.design_SNRdB))
            reuse = None
            if lut.reuse_lut:
                reuse = np.array([int(x) for x in lut.reuse_lut.split()], dtype=bool)
            # LUT.qbits_messages: per-iteration message resolutions
            # (LDPC_BER_Sim.cpp:398: Nq_Msg = 2^qbits_messages elementwise)
            if getattr(lut, "qbits_messages", ""):
                qb = np.array([int(x) for x in lut.qbits_messages.split()])
                if len(qb) != lut.max_iter:
                    raise ValueError(
                        "LUT.qbits_messages needs max_iter entries "
                        f"({len(qb)} given, max_iter={lut.max_iter})"
                    )
                Nq_Msg = (2 ** qb.astype(np.int64))
            else:
                Nq_Msg = 2**lut.qbits_message_uniform
            codec = LUTCodec.design(
                graph,
                sig * sig,
                max_iters=lut.max_iter,
                Nq_Cha=2**lut.qbits_channel,
                Nq_Msg=Nq_Msg,
                tree_method=(
                    "filename=" + (
                        lut.trees_filename
                        if os.path.isabs(lut.trees_filename)
                        else os.path.join(codes_root, lut.trees_dir,
                                          lut.trees_filename)
                    )
                    if lut.tree_mode in ("file", "filename")
                    else lut.tree_mode
                ),
                min_lut=lut.min_lut,
                reuse_vec=reuse,
                irregular_design_strategy=lut.irregular_design_strategy,
                build_generator=not config.ldpc.zero_codeword,
                # generator cached next to the alist, like the reference's
                # <code>.gen.it (LDPC_BER_Sim.cpp:168-189)
                generator_cache=(
                    alist.removesuffix(".alist") + ".gen.npz"
                    if codec is None and not config.ldpc.zero_codeword
                    else None
                ),
            )
            graph = codec.graph  # possibly column-permuted by the generator
            codec.initial_message_mode = lut.initial_message_mode
            if config.sim.codec_filename and config.sim.save_codec in (-1, seed):
                codec.save(config.sim.codec_filename)
    else:
        from ..decoder.bp import make_bp_decoder

        if not config.ldpc.zero_codeword:
            # encoded BP sims: systematic generator, cached next to the
            # alist like the reference's <code>.gen.it
            # (LDPC_BER_Sim.cpp:168-189); the BP decoder runs on the
            # column-permuted graph so systematic bits come first
            from ..core.gf2 import make_systematic_generator_cached

            H = graph.to_dense()
            perm, gen_T, _ = make_systematic_generator_cached(
                H, alist.removesuffix(".alist") + ".gen.npz")
            graph = TannerGraph.from_dense(H[:, perm])
        bp = make_bp_decoder(
            graph, config.bp, early_exit=config.ldpc.parity_check_iter
        )

    sim = BERSim(config, graph, codec=codec, bp_decoder=bp, mesh=mesh,
                 gen_T=gen_T)
    results = sim.run(seed=seed, verbose=verbose)
    return results, sim
