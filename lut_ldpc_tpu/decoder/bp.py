"""Batched float belief-propagation baselines on the LUT decoder's layout.

The reference's BP baseline is IT++'s QLLR sum-product / min-sum decoder
(used via LDPC_BER_Sim, /root/reference/src/LDPC_BER_Sim.cpp:157-244); its
role here is the statistical cross-check for the LUT decoder's BER curves
(SURVEY.md §4.4).  Same degree-grouped gather/scatter layout as
lut_decoder.py, float32 messages:

- VN update: leave-one-out via one total sum per node minus own message;
- CN update: sum-product via the phi-function boxplus (phi(x) =
  -log tanh(x/2), self-inverse) or (normalized/offset) min-sum via the
  two-min trick;
- per-iteration hard-decision syndrome check with masked early-exit latch,
  matching IT++ LDPC_Code::bp_decode semantics.

LLR convention follows the reference/IT++: positive LLR = bit 0.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.tanner import TannerGraph

__all__ = ["BPDecoder", "boxplus_phi"]

_PHI_CLIP_LO = 1e-7
_PHI_CLIP_HI = 30.0


def _seq_sum(x: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    """Sum over the last axis, left to right.  A reduction's order is the
    backend's choice, so f32 results would differ in the last bits between
    CPU and GPU; a fixed chain of adds does not."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out[..., None] if keepdims else out


def boxplus_phi(x: jnp.ndarray) -> jnp.ndarray:
    """phi(x) = -log(tanh(x/2)) on clipped positive input (self-inverse)."""
    x = jnp.clip(x, _PHI_CLIP_LO, _PHI_CLIP_HI)
    return -jnp.log(jnp.tanh(0.5 * x))


class BPDecoder:
    """Batched flooding BP decoder.

    algorithm: 'spa' (sum-product), 'minsum', 'nms' (normalized min-sum,
    scale), 'oms' (offset min-sum, offset), or 'qllr' (fixed-point
    sum-product with a quantized Jacobian-logexp correction table — the
    finite-precision BP of IT++'s LLR_calc_unit, whose four resolution
    knobs the reference BER sim exposes, LDPC_BER_Sim.cpp:74-78, 201).
    decode(llr) with (B, nvar) float input returns (bits (B, nvar) uint8,
    ok (B,) bool, iters (B,) int32).
    """

    def __init__(
        self,
        graph: TannerGraph,
        max_iters: int = 50,
        algorithm: str = "spa",
        scale: float = 0.75,
        offset: float = 0.15,
        early_exit: bool = True,
        llr_clip: float = 100.0,
        qllr_scale_res: int = 12,
        qllr_table_size: int = 300,
        qllr_spacing_res: int = 7,
        qllr_total_res: int = 28,
    ):
        if getattr(graph, "qc_phantoms", ()):
            raise ValueError("phantom-completed graphs are LUT-decoder "
                             "artifacts; BP decodes the true matrix")
        if algorithm not in ("spa", "minsum", "nms", "oms", "qllr"):
            raise ValueError(f"unknown BP algorithm {algorithm!r}")
        if algorithm == "qllr":
            self.q_scale = 1 << qllr_scale_res
            self.q_shift = qllr_scale_res - qllr_spacing_res
            self.q_max = (1 << (qllr_total_res - 1)) - 1
            if qllr_table_size > 0:
                i = np.arange(qllr_table_size)
                delta = float(2**self.q_shift) / self.q_scale
                self._q_table = jnp.asarray(
                    np.floor(0.5 + self.q_scale * np.log1p(np.exp(-i * delta)))
                    .astype(np.int32)
                )
            else:
                self._q_table = None  # pure min-sum on quantized values
        self.graph = graph
        self.max_iters = int(max_iters)
        self.algorithm = algorithm
        self.scale = float(scale)
        self.offset = float(offset)
        self.early_exit = early_exit
        self.llr_clip = float(llr_clip)

        g = graph
        self.nvar = g.nvar
        self._edge_var = jnp.asarray(g.var_llr_edge_expand())
        self._vn_degrees = [int(d) for d in g.vn_degrees]
        self._cn_degrees = [int(d) for d in g.cn_degrees]
        self._vn_edge_idx = {d: jnp.asarray(g.vn_edge_idx[d]) for d in self._vn_degrees}
        self._vn_node_idx = {d: jnp.asarray(g.vn_node_idx[d]) for d in self._vn_degrees}
        self._cn_edge_idx = {d: jnp.asarray(g.cn_edge_idx[d]) for d in self._cn_degrees}
        self._cn_var_idx = {d: jnp.asarray(g.cn_var_idx[d]) for d in self._cn_degrees}
        self._decode = jax.jit(self._build())

    # ------------------------------------------------------------------
    def _q_logexp(self, x):
        """Quantized log(1 + exp(-x/scale)) table term (x >= 0 QLLR)."""
        if self._q_table is None:
            return jnp.zeros_like(x)
        idx = x >> self.q_shift
        n = self._q_table.shape[0]
        return jnp.where(idx < n, jnp.take(self._q_table, jnp.minimum(idx, n - 1)), 0)

    def _q_boxplus(self, a, b):
        """Fixed-point Jacobian boxplus (IT++ LLR_calc_unit semantics)."""
        mag = jnp.minimum(jnp.abs(a), jnp.abs(b))
        sgn = jnp.sign(a) * jnp.sign(b)
        core = sgn * mag + self._q_logexp(jnp.abs(a + b)) - self._q_logexp(
            jnp.abs(a - b)
        )
        return jnp.clip(core, -self.q_max, self.q_max)

    def _cn_update_qllr(self, m: jnp.ndarray) -> jnp.ndarray:
        """Leave-one-out boxplus via prefix/suffix chains; m (..., d) int32."""
        d = m.shape[-1]
        big = self.q_max  # boxplus identity is +inf; q_max is close enough
        prefix = [jnp.full(m.shape[:-1], big, dtype=m.dtype)]
        for i in range(d - 1):
            prefix.append(self._q_boxplus(prefix[-1], m[..., i]))
        suffix = [jnp.full(m.shape[:-1], big, dtype=m.dtype)]
        for i in range(d - 1, 0, -1):
            suffix.append(self._q_boxplus(suffix[-1], m[..., i]))
        suffix = suffix[::-1]
        outs = [self._q_boxplus(prefix[i], suffix[i]) for i in range(d)]
        return jnp.stack(outs, axis=-1)

    def _cn_update(self, m: jnp.ndarray) -> jnp.ndarray:
        """Leave-one-out boxplus over the last axis; m (..., d)."""
        if self.algorithm == "qllr":
            return self._cn_update_qllr(m)
        sgn = jnp.where(m < 0, -1.0, 1.0)
        sign_prod = jnp.prod(sgn, axis=-1, keepdims=True)
        sign_out = sign_prod * sgn  # product of the *other* signs
        mag = jnp.abs(m)
        if self.algorithm == "spa":
            p = boxplus_phi(mag)
            s = _seq_sum(p, keepdims=True)
            mag_out = boxplus_phi(s - p)
        else:
            d = m.shape[-1]
            min1 = jnp.min(mag, axis=-1, keepdims=True)
            idx = jnp.argmin(mag, axis=-1)
            is_min = jnp.arange(d, dtype=jnp.int32) == idx[..., None]
            min2 = jnp.min(jnp.where(is_min, jnp.inf, mag), axis=-1, keepdims=True)
            mag_out = jnp.where(is_min, min2, min1)
            if self.algorithm == "nms":
                mag_out = self.scale * mag_out
            elif self.algorithm == "oms":
                mag_out = jnp.maximum(mag_out - self.offset, 0.0)
        return sign_out * mag_out

    def _build(self):
        clip = self.q_max if self.algorithm == "qllr" else self.llr_clip

        def cn_pass(msgs):
            for d in self._cn_degrees:
                idx = self._cn_edge_idx[d]
                msgs = msgs.at[:, idx].set(self._cn_update(msgs[:, idx]))
            return msgs

        def vn_pass(msgs, llr):
            """Returns (new var->chk msgs, posterior (B, nvar))."""
            B = msgs.shape[0]
            post = jnp.zeros((B, self.nvar), dtype=msgs.dtype)
            out = msgs
            for d in self._vn_degrees:
                idx = self._vn_edge_idx[d]
                m = msgs[:, idx]  # (B, n_d, d)
                node_llr = llr[:, self._vn_node_idx[d]]
                total = node_llr + _seq_sum(m)
                post = post.at[:, self._vn_node_idx[d]].set(total)
                out = out.at[:, idx].set(jnp.clip(total[..., None] - m, -clip, clip))
            return out, post

        def syndrome_ok(bits):
            ok = jnp.ones((bits.shape[0],), dtype=bool)
            for d in self._cn_degrees:
                s = jnp.sum(bits[:, self._cn_var_idx[d]].astype(jnp.int32), axis=-1) & 1
                ok = ok & jnp.all(s == 0, axis=-1)
            return ok

        def decode(llr):
            B = llr.shape[0]
            if self.algorithm == "qllr":
                llr = jnp.clip(
                    jnp.round(llr * self.q_scale), -self.q_max, self.q_max
                ).astype(jnp.int32)
            msgs = llr[:, self._edge_var]
            done = jnp.zeros((B,), dtype=bool)
            latched = jnp.zeros((B, self.nvar), dtype=jnp.uint8)
            iters = jnp.full((B,), self.max_iters, dtype=jnp.int32)
            post = llr

            def body(ii, carry):
                msgs, post, done, latched, iters = carry
                msgs_new = cn_pass(msgs)
                msgs_new, post_new = vn_pass(msgs_new, llr)
                msgs = jnp.where(done[:, None], msgs, msgs_new)
                post = jnp.where(done[:, None], post, post_new)
                if self.early_exit:
                    bits = (post < 0).astype(jnp.uint8)
                    conv = syndrome_ok(bits) & ~done
                    latched = jnp.where(conv[:, None], bits, latched)
                    iters = jnp.where(conv, ii + 1, iters)
                    done = done | conv
                return msgs, post, done, latched, iters

            # one compiled iteration, not max_iters unrolled copies: the
            # unrolled program grows with the budget and compiles for
            # minutes at N=64800
            msgs, post, done, latched, iters = jax.lax.fori_loop(
                0, self.max_iters, body, (msgs, post, done, latched, iters))

            bits = (post < 0).astype(jnp.uint8)
            ok_final = syndrome_ok(bits)
            bits = jnp.where(done[:, None], latched, bits)
            return bits, done | ok_final, iters

        return decode

    def __call__(self, llr):
        return self._decode(jnp.asarray(llr, dtype=jnp.float32))


def make_bp_decoder(graph, bp_config, early_exit: bool = True) -> BPDecoder:
    """BPDecoder from a BPConfig (maps the reference's INI keys; a
    qllr_total_bits > 0 selects the fixed-point QLLR decoder)."""
    alg = bp_config.algorithm
    kw = {}
    if getattr(bp_config, "qllr_total_bits", 0):
        alg = "qllr"
        kw = dict(
            qllr_scale_res=bp_config.qllr_frac_bits or 12,
            qllr_table_size=bp_config.qllr_table_size,
            qllr_spacing_res=bp_config.qllr_table_frac_bits or 7,
            qllr_total_res=bp_config.qllr_total_bits,
        )
    return BPDecoder(
        graph, max_iters=bp_config.max_iter, algorithm=alg,
        scale=bp_config.scale, offset=bp_config.offset,
        early_exit=early_exit, **kw,
    )
