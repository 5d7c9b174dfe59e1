"""Staged decoding: run cheap short-iteration passes first, re-decode only
the frames that did not converge.

The reference decoder early-exits per frame at the unanimity syndrome check
(LDPC_Code_LUT.cpp:327), so its cost tracks the *mean* iteration count.  A
batched decoder pays the worst case for the whole batch — unless the
batch is compacted: decode everyone for a few iterations, keep the latched
outputs of converged frames, and re-decode the survivors from scratch with
a longer budget.  Because decoding is deterministic in its inputs and the
early-exit latch freezes a frame's output at first convergence, staging is
*bit-identical* to the full decoder — not an approximation.

Stages: arithmetic prefix decoders (decoder/arith.py) at geometrically
increasing iteration budgets, then the full decoder (arith if the whole
codec validates, else the table-based scan decoder) for the stragglers.
"""

from __future__ import annotations

import numpy as np

from .arith import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from .arith_decoder import ArithLUTDecoder
from .codec import LUTCodec

__all__ = ["StagedLUTDecoder", "ChunkedDecoder", "make_staged_decoder",
           "decode_mem_budget"]


def decode_mem_budget() -> int:
    """Bytes of message arrays one decode call may hold.

    LUT_DECODE_MEM_BUDGET overrides.  Otherwise a quarter of the default
    device's memory limit, which leaves room for XLA's temporaries and
    the caller's (B, N) label and bit arrays beside the per-frame
    estimate the callers divide by.  Devices that report no limit (the
    CPU) get a fixed 1 GiB."""
    import os

    env = os.environ.get("LUT_DECODE_MEM_BUDGET")
    if env:
        return int(env)
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 4 if limit else 1 << 30


def _pad_size(n: int, minimum: int = 32) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


class StagedLUTDecoder:
    """Drop-in decoder with host-side stage orchestration.

    Not usable inside jit/shard_map (stages synchronize with the host);
    BERSim uses it on the single-device path.
    """

    def __init__(self, codec: LUTCodec, early_exit: bool = True,
                 first_stage_iters: int = 8, adapt: bool = True):
        if not early_exit:
            raise ValueError("staged decoding requires early exit")
        self.codec = codec
        self.adapt = adapt
        # prefer int16 values (half the gather traffic); fall back to
        # float32 when the integer representation does not validate or
        # covers a much shorter prefix
        prefix_spec = None
        try:
            prefix_spec = build_arith_prefix_spec(codec, dtype=np.int16)
            self._dtype = np.int16
        except ArithBuildError:
            pass
        if prefix_spec is None or prefix_spec.num_iters < min(8, codec.max_iters - 1):
            spec32 = build_arith_prefix_spec(codec, dtype=np.float32)
            if prefix_spec is None or spec32.num_iters > prefix_spec.num_iters:
                prefix_spec = spec32
                self._dtype = np.float32
        self._max_prefix = prefix_spec.num_iters
        s = self._max_prefix
        stage_lengths = []
        n = min(first_stage_iters, s)
        while n < s:
            stage_lengths.append(n)
            n *= 4
        stage_lengths.append(s)
        self._stage_cache: dict[int, ArithLUTDecoder] = {
            self._max_prefix: ArithLUTDecoder(codec, early_exit=True,
                                              spec=prefix_spec)
        }
        self.stage_iters = stage_lengths
        # final full decoder for frames not converged within the prefix
        self.full = None
        for dt in (self._dtype, np.float32):
            try:
                full_spec = build_arith_spec(codec, dtype=dt)
                self.full = ArithLUTDecoder(codec, early_exit=True, spec=full_spec)
                break
            except ArithBuildError:
                pass
        if self.full is None:
            from .fast_decoder import FastLUTDecoder

            try:
                self.full = FastLUTDecoder(codec, early_exit=True)
            except ValueError:
                # phantom-completed graphs / non-uniform resolutions:
                # the general unrolled decoder is the universal fallback
                from .lut_decoder import LUTDecoder

                self.full = LUTDecoder(codec, early_exit=True)
        # adaptation state: per-frame iteration counts observed so far
        self._iters_seen: list[np.ndarray] = []
        # cap per-call batch on big graphs: arith stages materialize
        # ~E*max_deg int16 leave-one-out values per frame; the
        # table-decoder fallback materializes (d, n_d, d, B) leave-one-out
        # intermediates, whose footprint scales with sum(n_d * d^2)
        g = codec.graph
        max_deg = int(g.dv_vec.max())
        budget = decode_mem_budget()
        self._max_pad = max(32, budget // (g.num_edges * max_deg * 2))
        loo_cost = sum(
            int((g.dv_vec == d).sum()) * int(d) * int(d) * 8
            for d in g.vn_degrees
        )
        self._max_pad_full = max(16, min(self._max_pad,
                                         budget // 2 // loo_cost))

    def _stage(self, n: int) -> ArithLUTDecoder:
        if n not in self._stage_cache:
            spec = build_arith_prefix_spec(
                self.codec, max_prefix=n, dtype=self._dtype
            )
            self._stage_cache[n] = ArithLUTDecoder(
                self.codec, early_exit=True, spec=spec
            )
        return self._stage_cache[n]

    @property
    def stages(self):
        return [self._stage(n) for n in self.stage_iters]

    def _adapt_plan(self, iters: np.ndarray, done: np.ndarray):
        """Re-plan stage lengths from the observed iteration distribution.

        The convergence distribution is often narrow (e.g. no frame finishes
        before iteration 13 at a typical operating point), so a fixed short
        first stage can be pure overhead.  Choose the smallest prefix
        covering ~99.5% of observed frames, rounded up to a multiple of 4
        (bounded compile-cache churn)."""
        if not self.adapt:
            return
        self._iters_seen.append(iters[done])
        seen = np.concatenate(self._iters_seen)
        if len(seen) < 64:
            return
        if len(self._iters_seen) > 64:  # bound memory, keep recent history
            self._iters_seen = [seen[-65536:]]
        p = float(np.percentile(seen, 99.5)) + 1
        t1 = min(self._max_prefix, int(4 * np.ceil(p / 4)))
        plan = [t1]
        if t1 < self._max_prefix:
            plan.append(self._max_prefix)
        if plan != self.stage_iters:
            self.stage_iters = plan

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        """Device-resident orchestration: only the per-stage done masks are
        synced to the host (survivor compaction indices are tiny); the LLR
        arrays, outputs, and gathers/scatters stay on device."""
        import jax.numpy as jnp

        cur_cha = jnp.asarray(llr_cha, dtype=jnp.int32)
        cur_msg = jnp.asarray(llr_msg, dtype=jnp.int32)
        B, nvar = cur_cha.shape
        if B > self._max_pad:
            # big graphs: bound per-call device memory by chunking frames
            outs = [self(cur_cha[lo : lo + self._max_pad],
                         cur_msg[lo : lo + self._max_pad])
                    for lo in range(0, B, self._max_pad)]
            return tuple(jnp.concatenate(parts, axis=0) for parts in zip(*outs))
        bits = jnp.zeros((B, nvar), dtype=jnp.uint8)
        ok = jnp.zeros((B,), dtype=bool)
        iters = jnp.full((B,), self.codec.max_iters, dtype=jnp.int32)
        remaining = np.arange(B)  # absolute frame ids of cur_* rows [:len]

        def scatter(bits, ok, iters, b, okv, it, rel_sel, abs_idx):
            sel = jnp.asarray(rel_sel)
            tgt = jnp.asarray(abs_idx)
            bits = bits.at[tgt].set(jnp.take(b, sel, axis=0))
            ok = ok.at[tgt].set(jnp.take(okv, sel))
            iters = iters.at[tgt].set(jnp.take(it, sel))
            return bits, ok, iters

        for stage in self.stages:
            b, done, it = stage._decode(cur_cha, cur_msg)
            done_np = np.asarray(done)[: len(remaining)]
            rel_conv = np.nonzero(done_np)[0]
            if rel_conv.size:
                bits, ok, iters = scatter(
                    bits, ok, iters, b, done, it, rel_conv, remaining[rel_conv]
                )
            rel_left = np.nonzero(~done_np)[0]
            remaining = remaining[~done_np]
            if len(remaining) == 0:
                self._adapt_plan(np.asarray(iters), np.asarray(ok))
                return bits, ok, iters
            P = _pad_size(len(remaining))
            idxp = jnp.asarray(np.resize(rel_left, P))  # wrap-pad survivors
            cur_cha = jnp.take(cur_cha, idxp, axis=0)
            cur_msg = jnp.take(cur_msg, idxp, axis=0)

        # final full decode, chunked to the big-graph batch cap
        n = len(remaining)
        for lo in range(0, n, self._max_pad_full):
            hi = min(lo + self._max_pad_full, n)
            P = _pad_size(hi - lo)
            idxp = jnp.asarray(np.resize(np.arange(lo, hi), P))
            b, okf, it = self.full._decode(
                jnp.take(cur_cha, idxp, axis=0), jnp.take(cur_msg, idxp, axis=0)
            )
            bits, ok, iters = scatter(
                bits, ok, iters, b, okf, it, np.arange(hi - lo), remaining[lo:hi]
            )
        self._adapt_plan(np.asarray(iters), np.asarray(ok))
        return bits, ok, iters


class ChunkedDecoder:
    """Split oversized batches into budget-sized chunks and run the
    single-jit inner decoder per chunk.  Frames are independent and the
    inner decoder is deterministic, so outputs are bit-identical to one
    full-batch call; the short final chunk is padded by repeating frames
    (sliced away) so every call hits the same compiled program."""

    def __init__(self, inner, chunk: int):
        self.inner = inner
        self.chunk = int(chunk)

    def __call__(self, llr_cha, llr_msg):
        import jax.numpy as jnp

        B = llr_cha.shape[0]
        if B <= self.chunk:
            return self.inner(llr_cha, llr_msg)
        outs = []
        for lo in range(0, B, self.chunk):
            hi = min(lo + self.chunk, B)
            if hi - lo < self.chunk:
                idx = jnp.asarray(np.resize(np.arange(lo, hi), self.chunk))
                b, ok, it = self.inner(jnp.take(llr_cha, idx, axis=0),
                                       jnp.take(llr_msg, idx, axis=0))
                outs.append((b[: hi - lo], ok[: hi - lo], it[: hi - lo]))
            else:
                outs.append(self.inner(llr_cha[lo:hi], llr_msg[lo:hi]))
        return tuple(jnp.concatenate([o[i] for o in outs]) for i in range(3))


def make_staged_decoder(codec: LUTCodec, early_exit: bool = True,
                        max_batch: int = 4096):
    """Best early-exit decoder for the codec.

    Since the arithmetic decoder gained a true in-loop early exit
    (lax.while_loop stops at the batch max iteration), host-side staging
    only pays off when the full-budget arithmetic spec does NOT validate
    (prefix-only codecs, where stragglers need the slow table decoder).
    When it does validate but the graph is too big for max_batch frames in
    one program (DVB-S2 scale), the batch is CHUNKED across bit-identical
    single-jit calls instead of StagedLUTDecoder's per-stage host round
    trips and its wasted short-prefix stage.  The budget is
    decode_mem_budget().

    max_batch: largest per-call batch the caller will use.
    """
    if early_exit:
        from .fast_decoder import make_decoder
        from .hybrid import HybridLUTDecoder, MixedArithDecoder

        dec = make_decoder(codec, early_exit=True)
        g = codec.graph
        # chunking threshold mirrors StagedLUTDecoder._max_pad
        fit = decode_mem_budget() // (g.num_edges * int(g.dv_vec.max()) * 2)
        full_arith = isinstance(dec, ArithLUTDecoder) and not dec.is_prefix
        if (full_arith or isinstance(dec, (HybridLUTDecoder,
                                           MixedArithDecoder))):
            if fit >= max_batch:
                return dec
            if fit >= 32:
                chunk = 32
                while chunk * 2 <= fit:
                    chunk *= 2
                return ChunkedDecoder(dec, chunk)
        try:
            return StagedLUTDecoder(codec, early_exit=True)
        except ArithBuildError:
            return dec
    from .fast_decoder import make_decoder

    return make_decoder(codec, early_exit=early_exit)
