"""Hybrid decoder: arithmetic value-domain prefix + label-domain tail,
with an optional MIXED-PRECISION middle segment.

Late DE iterations of a near-converged design can be degenerate — the LUTs
stop being representable as threshold functions of value sums (arith.py),
so the arithmetic decoder only validates a PREFIX of the iteration budget
(e.g. 32 of 50 on the N=10000 benchmark codec).  StagedLUTDecoder works
around this with host-side survivor re-decoding, which costs device-host
round trips per stage and cannot run under jit/shard_map.

This decoder composes the exact representations inside ONE jit:

1. the arithmetic prefix runs as a lax.while_loop that stops as soon as
   every frame in the batch has latched (true early exit — cost tracks the
   batch max iteration count);
2. a lax.cond then either returns the latched outputs directly (the common
   case at operating SNR: all frames converge within the prefix, the tail
   costs nothing) or bridges the message state into the label domain and
   CONTINUES with FastLUTDecoder's table scan for the remaining
   iterations + decision pass — not a re-decode.

MIXED PRECISION (DVB-S2 scale): when the int16 spec validates a long
prefix (e.g. 43/50 at N=64800 — beyond that the scaled-integer tables'
sums exceed the int16 range, arith.py "int16 sum range exceeded") and the
float32 spec validates further (49/50), the decode runs THREE exact
segments: int16 values for iterations [0, S16) — half the HBM message
traffic, and the integer grid makes any-order sums exact so the
total-minus-self leave-one-out trick applies to the high-degree VN
classes — then a value re-embedding (int16 grid -> the f32 spec's
iteration-S16 value table, a pure label-preserving monotone map), then
f32 values for [S16, S32), then the label-domain table tail for the
rest.  Each value domain is validated exhaustively at build time, so the
composition stays bit-identical to the scalar golden model.

The bridges are exact: message values are entries of the respective
iteration's leaf value table (strictly monotone, antisymmetric — enforced
at build time), so label = #(table thresholds crossed); the edge/node
index maps between the padded slot-major arithmetic layout and the
unpadded node-major table layout are static permutations.
Bit-identicality to the scalar golden model (decode_ref, after the
reference's LDPC_Code_LUT.cpp:259-353) is enforced by the
decoder-equivalence suites.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .arith import ArithBuildError, build_arith_prefix_spec, build_arith_spec
from .arith_decoder import ArithLUTDecoder
from .codec import LUTCodec
from .fast_decoder import FastLUTDecoder

__all__ = ["HybridLUTDecoder", "MixedArithDecoder"]


def _seam_labels(m_vals, table):
    """Values (entries of `table`, strictly monotone) -> labels."""
    lab = jnp.zeros(m_vals.shape, jnp.int32)
    for k in range(1, len(table)):
        lab = lab + (m_vals >= table[k]).astype(jnp.int32)
    return lab


def _root_levels(spec, it):
    """Value table entering iteration `it` of `spec` (= output levels of
    any iteration-(it-1) root op; shared across degrees by construction).
    Returns None unless strictly monotone (invertible values -> labels)."""
    table = np.asarray(spec.var_trees[it - 1][0].ops[-1].levels)
    if not np.all(np.diff(table.astype(np.float64)) > 0):
        return None
    return table


class HybridLUTDecoder:
    """Full-budget early-exit decoder for codecs whose arithmetic form
    only covers a prefix of the iterations.  Raises ArithBuildError when
    no arithmetic prefix exists, ValueError when the table tail cannot be
    built (callers fall back)."""

    def __init__(self, codec: LUTCodec, early_exit: bool = True):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ValueError(
                "phantom-completed graphs: hybrid tail lacks pinned-edge semantics")
        if not early_exit:
            raise ValueError("hybrid decoding requires early exit")
        self.codec = codec
        self.early_exit = True
        spec16 = spec32 = None
        try:
            spec16 = build_arith_prefix_spec(codec, dtype=np.int16)
        except ArithBuildError:
            pass
        try:
            spec32 = build_arith_prefix_spec(codec, dtype=np.float32)
        except ArithBuildError:
            pass
        if spec16 is None and spec32 is None:
            raise ArithBuildError("no valid arithmetic prefix")

        # mixed-precision middle segment: int16 prefix + f32 continuation
        # (only when f32 genuinely extends the int16 coverage)
        self.mid = None
        if (spec16 is not None and spec32 is not None
                and spec32.num_iters > spec16.num_iters):
            t16 = _root_levels(spec16, spec16.num_iters)
            t32 = _root_levels(spec32, spec16.num_iters)
            if t16 is not None and t32 is not None and len(t16) == len(t32):
                self.pre = ArithLUTDecoder(codec, early_exit=True, spec=spec16)
                self.mid = ArithLUTDecoder(codec, early_exit=True, spec=spec32)
                self._seam16 = t16
                self._seam32 = t32
                spec = spec32  # tail tables come from the f32 spec

        if self.mid is None:
            # single-spec policy: prefer int16 (half the traffic), fall
            # back to float32 when it validates a longer prefix
            spec = spec16
            if spec is None or (spec32 is not None
                                and spec32.num_iters > spec.num_iters):
                spec = spec32
            self.pre = ArithLUTDecoder(codec, early_exit=True, spec=spec)

        self.fast = FastLUTDecoder(codec, early_exit=True)
        self.S = spec.num_iters  # iterations covered before the table tail
        self.T = codec.max_iters

        # ---- table-tail bridge constants ---------------------------------
        table = _root_levels(spec, self.S)
        if table is None:
            raise ArithBuildError(
                "iteration-S value table not strictly monotone; cannot "
                "invert values to labels"
            )
        self._msg_table_S = table
        lay_a = (self.mid or self.pre).layout
        lay_f = self.fast.layout
        inv_a = np.zeros(codec.graph.num_edges, dtype=np.int64)
        real = lay_a.vn_edge_orig >= 0
        inv_a[lay_a.vn_edge_orig[real]] = np.nonzero(real)[0]
        self._f2a_edge = inv_a[lay_f.vn_edge_orig].astype(np.int32)
        self._f2a_node = lay_a.vn_node_pos[lay_f.vn_nodes].astype(np.int32)

        self._decode = jax.jit(self._build())

    # ------------------------------------------------------------------
    def _build(self):
        pre_raw = self.pre._raw_carry_fn()
        tail = self.fast._make_tail(self.S)
        K = len(self._msg_table_S)
        levels = jnp.asarray(self._msg_table_S)
        f2a_e = jnp.asarray(self._f2a_edge)
        f2a_n = jnp.asarray(self._f2a_node)
        node_pos_a = jnp.asarray(self.pre.layout.vn_node_pos)
        msg_dtype = self.fast.msg_dtype

        def tail_or_done(llr_cha, m_vals, done, latched, iters):
            """Label-domain table tail for iterations [self.S, T), or the
            latched outputs when every frame already converged."""
            bits_pre = jnp.take(latched, node_pos_a, axis=0).T

            def no_tail(_):
                return bits_pre, done, iters

            def run_tail(_):
                lab = _seam_labels(m_vals, levels)
                m_f = jnp.take(lab, f2a_e, axis=0).T.astype(msg_dtype)
                latched_f = jnp.take(latched, f2a_n, axis=0).T
                cha_blocks = self.fast._cha_blocks(llr_cha)
                return tail(m_f, cha_blocks, done, latched_f, iters)

            # scalar predicate: the tail branch executes ONLY when some
            # frame is still undecided
            return jax.lax.cond(jnp.all(done), no_tail, run_tail, None)

        if self.mid is None:
            def decode(llr_cha, llr_msg):
                m_vals, done, latched_a, iters = pre_raw(llr_cha, llr_msg)
                return tail_or_done(llr_cha, m_vals, done, latched_a, iters)

            return decode

        # ---- mixed precision: int16 prefix -> f32 segment -> tail --------
        t16 = jnp.asarray(self._seam16)
        t32 = jnp.asarray(self._seam32)
        mid_cont = self.mid._build(raw=True, cont_from=self.pre.S)

        def decode(llr_cha, llr_msg):
            m16, done, latched, iters = pre_raw(llr_cha, llr_msg)
            bits_pre = jnp.take(latched, node_pos_a, axis=0).T

            def all_done(_):
                return bits_pre, done, iters

            def run_mid(_):
                # exact value re-embedding: int16 grid -> f32 spec's
                # iteration-S16 table (label-preserving monotone map)
                lab = _seam_labels(m16, t16)
                v32 = jnp.zeros(lab.shape, jnp.float32)
                for k in range(K):
                    v32 = jnp.where(lab == k, t32[k], v32)
                m32, done2, latched2, iters2 = mid_cont(
                    llr_cha, v32, done, latched, iters)
                return tail_or_done(llr_cha, m32, done2, latched2, iters2)

            return jax.lax.cond(jnp.all(done), all_done, run_mid, None)

        return decode

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        return self._decode(
            jnp.asarray(llr_cha, dtype=jnp.int32),
            jnp.asarray(llr_msg, dtype=jnp.int32),
        )


class MixedArithDecoder:
    """Full-budget arithmetic decoder with an int16 front segment.

    For codecs whose FULL float32 arithmetic spec validates (decision
    trees included) but whose int16 spec only covers a prefix (the
    DVB-S2-scale N=64800 codec: 43/50 — beyond that the scaled-integer
    tables need more dynamic range than int16 holds), run iterations
    [0, S16) on int16 values — half the HBM message traffic, and the
    integer grid makes any-order float sums exact so the total-minus-self
    leave-one-out trick applies to the high-degree VN classes — then
    re-embed values into the f32 spec's iteration-S16 table and continue
    with the FULL f32 arithmetic decoder (its own DECTREE finish, no
    label-domain table tail).  Exact end to end: every segment's value
    domain is validated exhaustively at build time, and the seam map is
    label-preserving monotone.  Raises ArithBuildError/ValueError when
    the composition is unavailable (callers fall back)."""

    def __init__(self, codec: LUTCodec, early_exit: bool = True,
                 min_prefix: int = 8):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ArithBuildError(
                "phantom-completed graphs: mixed-precision seam not yet "
                "phantom-aware (single-dtype arith decoder handles them)")
        if not early_exit:
            raise ValueError("mixed arith decoding requires early exit")
        self.codec = codec
        self.early_exit = True
        spec16 = build_arith_prefix_spec(codec, dtype=np.int16)
        spec32 = build_arith_spec(codec, dtype=np.float32)  # FULL spec
        if spec16.num_iters >= spec32.num_iters:
            raise ArithBuildError(
                "int16 covers the full budget; use the plain decoder")
        if spec16.num_iters < min_prefix:
            raise ArithBuildError("int16 prefix too short to pay for the "
                                  "precision seam")
        S16 = spec16.num_iters
        t16 = _root_levels(spec16, S16)
        t32 = _root_levels(spec32, S16)
        if t16 is None or t32 is None or len(t16) != len(t32):
            raise ArithBuildError("seam value tables not invertible")
        self.pre = ArithLUTDecoder(codec, early_exit=True, spec=spec16)
        self.fin = ArithLUTDecoder(codec, early_exit=True, spec=spec32)
        self.S16 = S16
        self.S = spec32.num_iters
        self.T = codec.max_iters
        self._seam16, self._seam32 = t16, t32
        self._decode = jax.jit(self._build())

    def _build(self):
        pre_raw = self.pre._raw_carry_fn()
        fin_cont = self.fin._build(cont_from=self.S16)
        t16 = jnp.asarray(self._seam16)
        t32 = jnp.asarray(self._seam32)
        K = len(self._seam16)
        node_pos = jnp.asarray(self.pre.layout.vn_node_pos)

        def decode(llr_cha, llr_msg):
            m16, done, latched, iters = pre_raw(llr_cha, llr_msg)

            def all_done(_):
                bits = jnp.take(latched, node_pos, axis=0).T
                return bits.astype(jnp.uint8), done, iters

            def run_fin(_):
                lab = _seam_labels(m16, t16)
                v32 = jnp.zeros(lab.shape, jnp.float32)
                for k in range(K):
                    v32 = jnp.where(lab == k, t32[k], v32)
                return fin_cont(llr_cha, v32, done, latched, iters)

            return jax.lax.cond(jnp.all(done), all_done, run_fin, None)

        return decode

    def __call__(self, llr_cha, llr_msg):
        return self._decode(
            jnp.asarray(llr_cha, dtype=jnp.int32),
            jnp.asarray(llr_msg, dtype=jnp.int32),
        )
