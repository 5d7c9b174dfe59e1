"""Scan-based LUT table decoder.

Semantics identical to lut_decoder.LUTDecoder (validated against the scalar
golden model), re-expressed for speed:

- one `lax.scan` over iterations (per-iteration LUT tables are the scan's
  xs, so the compiled graph is one iteration long, not max_iters long);
- messages flow through the GroupedLayout permutation form: two (B, E)
  gathers per iteration, zero scatters;
- degree-d VN updates use composed packed leave-one-out tables (one gather
  per node) where they fit, per-op TreeProgram evaluation otherwise;
- the per-iteration unanimity/syndrome check (LDPC_Code_LUT.cpp:327,
  437-452) is fused into the tensors the iteration already produces: sign
  unanimity from the VN-grouped messages, check parity from the CN-grouped
  gather that the next CN pass needs anyway — early exit costs no extra
  memory passes;
- messages are stored int8 (HBM traffic is the bound; labels are < 128).

Requirements for this path: uniform per-iteration message resolution and
(for program-path degrees) identical tree structure across iterations.
make_decoder() falls back to the general unrolled decoder otherwise.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .codec import LUTCodec
from .fast_layout import (
    MAX_COMPOSED_ENTRIES,
    GroupedLayout,
    compose_dec_table,
    composed_entries,
    var_tree_tables,
)
from .layout import leave_one_out_idx, tree_program

__all__ = ["FastLUTDecoder", "make_decoder"]


def _supports_fast(codec: LUTCodec) -> bool:
    if len(set(int(x) for x in codec.Nq_Msg)) != 1:
        return False
    return True


def make_decoder(codec: LUTCodec, early_exit: bool = True):
    """Fastest provably-equivalent decoder for this codec.

    Tries, in order: the arithmetic value-domain decoder (exactness proven
    at build time), the hybrid prefix+tail decoder, the table-based scan
    decoder, the general unrolled decoder.  All are bit-identical where
    they apply."""
    import numpy as np

    from .arith import ArithBuildError, build_arith_spec
    from .arith_decoder import ArithLUTDecoder

    try:  # int16 halves traffic when exact over the whole budget
        spec = build_arith_spec(codec, dtype=np.int16)
        return ArithLUTDecoder(codec, early_exit=early_exit, spec=spec)
    except ArithBuildError:
        # could not *prove* exactness for this codec/dtype -> fall back;
        # any other error is a genuine bug and propagates
        pass
    if early_exit:
        from .hybrid import MixedArithDecoder

        try:  # int16 front segment + full-f32 arithmetic finish
            return MixedArithDecoder(codec, early_exit=True)
        except (ArithBuildError, ValueError):
            pass
    try:
        spec = build_arith_spec(codec, dtype=np.float32)
        return ArithLUTDecoder(codec, early_exit=early_exit, spec=spec)
    except ArithBuildError:
        pass
    if early_exit:
        from .hybrid import HybridLUTDecoder

        try:
            return HybridLUTDecoder(codec, early_exit=True)
        except (ArithBuildError, ValueError):
            pass
    if _supports_fast(codec):
        try:
            return FastLUTDecoder(codec, early_exit=early_exit)
        except ValueError:
            pass
    from .lut_decoder import LUTDecoder

    if getattr(codec.graph, "qc_phantoms", ()) and codec.max_iters > 20 \
            and codec.nvar > 10000:
        import warnings

        warnings.warn(
            f"no arithmetic spec validates for this phantom-completed "
            f"codec; falling back to the unrolled table decoder "
            f"({codec.max_iters} iterations at N={codec.nvar} compiles "
            f"slowly) — consider the unpermuted realization "
            f"(LDPC.qc_detect=0) or a design sigma whose f32 spec "
            f"validates", stacklevel=2)
    return LUTDecoder(codec, early_exit=early_exit)


class FastLUTDecoder:
    def __init__(self, codec: LUTCodec, early_exit: bool = True,
                 msg_dtype=None):
        if getattr(codec.graph, "qc_phantoms", ()):
            raise ValueError("phantom-completed graphs: only the "
                             "arithmetic decoders implement pinned-edge "
                             "semantics")
        if len(set(int(x) for x in codec.Nq_Msg)) != 1:
            raise ValueError("fast decoder needs uniform Nq_Msg")
        self.codec = codec
        self.early_exit = early_exit
        if msg_dtype is None:
            # labels must fit the storage dtype (8-bit quantizers need int16)
            maxres = max(int(codec.Nq_Msg.max()), int(codec.Nq_Cha))
            msg_dtype = jnp.int8 if maxres <= 127 else jnp.int16
        self.msg_dtype = msg_dtype
        self.Nq = int(codec.Nq_Msg[0])
        self.nz = self.Nq // 2
        self.T = codec.max_iters
        g = codec.graph
        self.nvar = g.nvar
        self.layout = GroupedLayout(g)
        self._build_tables()
        self._decode = jax.jit(self._build())

    # ------------------------------------------------------------------
    def _build_tables(self):
        codec = self.codec
        lay = self.layout
        Nqc = codec.Nq_Cha
        Nq = self.Nq
        T = self.T
        self.out_bits = max(1, int(np.ceil(np.log2(Nq))))

        # -- VN tables per block, stacked over iterations 0..T-2 ----------
        self._var_kind = []  # per block: 'composed' | 'program'
        self._var_progs = []  # per block: TreeProgram (program path) or None
        var_xs = []  # per block: (T-1, n) array or list of (T-1, len) arrays
        for bi, blk in enumerate(lay.vn_blocks):
            d = blk.degree
            kinds, payloads = [], []
            for ii in range(T - 1):
                kind, payload = var_tree_tables(
                    codec.var_tree(ii, d), d, Nq, Nqc, Nq
                )
                kinds.append(kind)
                payloads.append(payload)
            if T == 1:
                # decision-only decoder: scan runs zero steps
                self._var_kind.append("composed")
                self._var_progs.append(None)
                var_xs.append(jnp.zeros((0, 1), dtype=jnp.int32))
            elif all(k == "composed" for k in kinds):
                self._var_kind.append("composed")
                self._var_progs.append(None)
                var_xs.append(jnp.asarray(np.stack(payloads)))
            else:
                # per-op stacked tables; tree structure must be static
                progs = [
                    p if k == "program" else tree_program(codec.var_tree(ii, d))
                    for ii, (k, p) in enumerate(zip(kinds, payloads))
                ]
                key0 = progs[0].structure_key()
                if any(p.structure_key() != key0 for p in progs[1:]):
                    raise ValueError("fast decoder: var tree structure varies over iterations")
                self._var_kind.append("program")
                self._var_progs.append(progs[0])
                var_xs.append([
                    jnp.asarray(np.stack([p.ops[oi].table for p in progs]))
                    for oi in range(len(progs[0].ops))
                ])
        self._var_xs = var_xs

        # -- CN: min-LUT needs no tables; LUT trees need per-op stacks ----
        self._chk_progs = None
        self._chk_xs = None
        if not codec.min_lut:
            chk_progs, chk_xs = [], []
            for blk in lay.cn_blocks:
                d = blk.degree
                progs = [tree_program(codec.chk_tree(ii, d)) for ii in range(T)]
                key0 = progs[0].structure_key()
                if any(p.structure_key() != key0 for p in progs[1:]):
                    raise ValueError("fast decoder: chk tree structure varies over iterations")
                chk_progs.append(progs[0])
                chk_xs.append([
                    jnp.asarray(np.stack([p.ops[oi].table for p in progs[: T - 1]]))
                    for oi in range(len(progs[0].ops))
                ])
            self._chk_progs = chk_progs
            self._chk_xs = chk_xs
            # final-iteration chk tables (used after the scan)
            self._chk_final = [
                [jnp.asarray(op.table) for op in tree_program(
                    codec.chk_tree(T - 1, blk.degree)).ops]
                for blk in lay.cn_blocks
            ]

        # -- decision tables (iteration T-1) ------------------------------
        self._dec_kind, self._dec_tab, self._dec_progs = [], [], []
        for blk in lay.vn_blocks:
            d = blk.degree
            tree = codec.var_tree(T - 1, d)  # DECTREE, d+1 leaves
            prog = tree_program(tree)
            if composed_entries(d, Nq, Nqc) <= MAX_COMPOSED_ENTRIES:
                self._dec_kind.append("composed")
                self._dec_tab.append(jnp.asarray(compose_dec_table(prog, d, Nq, Nqc)))
                self._dec_progs.append(None)
            else:
                self._dec_kind.append("program")
                self._dec_tab.append(None)
                self._dec_progs.append(
                    (prog, [jnp.asarray(op.table) for op in prog.ops])
                )

        # index constants
        self._perm_v2c = jnp.asarray(self.layout.perm_v2c)
        self._perm_c2v = jnp.asarray(self.layout.perm_c2v)
        self._vn_nodes = jnp.asarray(self.layout.vn_nodes)
        self._vn_node_pos = jnp.asarray(self.layout.vn_node_pos)
        self._cn_var_pos = jnp.asarray(self.layout.cn_var_pos)
        self._vn_loo = {
            blk.degree: jnp.asarray(leave_one_out_idx(blk.degree + 1, blk.degree))
            for blk in self.layout.vn_blocks
        }
        self._cn_loo = {
            blk.degree: jnp.asarray(leave_one_out_idx(blk.degree, blk.degree))
            for blk in self.layout.cn_blocks
        }
        self._bases = {
            blk.degree: jnp.asarray(
                (self.Nq ** np.arange(blk.degree)).astype(np.int32)
            )
            for blk in self.layout.vn_blocks
        }

    # ------------------------------------------------------------------
    def _vn_blocks_of(self, m_vn):
        """Split (B, E) into per-block (B, n, d) views."""
        out = []
        for blk in self.layout.vn_blocks:
            d, n, e0 = blk.degree, blk.num_nodes, blk.edge_start
            out.append(m_vn[:, e0 : e0 + n * d].reshape(m_vn.shape[0], n, d))
        return out

    def _cn_blocks_of(self, m_cn):
        out = []
        for blk in self.layout.cn_blocks:
            d, n, e0 = blk.degree, blk.num_nodes, blk.edge_start
            out.append(m_cn[:, e0 : e0 + n * d].reshape(m_cn.shape[0], n, d))
        return out

    def _cn_minsum(self, m, nz):
        from .lut_decoder import cn_minsum

        return cn_minsum(m, nz).astype(self.msg_dtype)

    def _run_program(self, prog, tables, x):
        vals = [x[..., i].astype(jnp.int32) for i in range(prog.num_inputs)]
        for op, table in zip(prog.ops, tables):
            label = vals[op.operands[0]] * op.bases[0]
            for b, s in zip(op.bases[1:], op.operands[1:]):
                label = label + b * vals[s]
            vals.append(jnp.take(table, label))
        return vals[-1]

    def _vn_update_block(self, bi, m, cha, xs_entry):
        """m (B,n,d) msgs, cha (B,n) channel labels -> (B,n,d) outputs."""
        blk = self.layout.vn_blocks[bi]
        d = blk.degree
        if self._var_kind[bi] == "composed":
            idx = jnp.sum(
                m.astype(jnp.int32) * self._bases[d][None, None, :], axis=-1
            ) + cha.astype(jnp.int32) * (self.Nq**d)
            packed = jnp.take(xs_entry, idx)  # (B, n)
            shifts = jnp.arange(d, dtype=jnp.int32) * self.out_bits
            outs = (packed[..., None] >> shifts) & ((1 << self.out_bits) - 1)
            return outs.astype(self.msg_dtype)
        prog = self._var_progs[bi]
        inp = jnp.concatenate([m, cha[..., None].astype(self.msg_dtype)], axis=-1)
        x = inp[:, :, self._vn_loo[d]]  # (B, n, d, d)
        return self._run_program(prog, xs_entry, x).astype(self.msg_dtype)

    def _cn_update(self, m_cn, chk_tables):
        """Full CN pass on the cn-grouped flat tensor."""
        outs = []
        for ci, m in enumerate(self._cn_blocks_of(m_cn)):
            if self.codec.min_lut:
                out = self._cn_minsum(m, self.nz)
            else:
                d = self.layout.cn_blocks[ci].degree
                x = m[:, :, self._cn_loo[d]]
                out = self._run_program(
                    self._chk_progs[ci], chk_tables[ci], x
                ).astype(self.msg_dtype)
            outs.append(out.reshape(m.shape[0], -1))
        return jnp.concatenate(outs, axis=1)

    def _convergence(self, m_vn, m_cn):
        """(bits_grouped (B, nvar) uint8, conv (B,) bool) from unanimity of
        VN-grouped signs + parity of CN-grouped signs."""
        B = m_vn.shape[0]
        bits, unan = [], jnp.ones((B,), dtype=bool)
        for m in self._vn_blocks_of(m_vn):
            neg = m < self.nz
            unan = unan & jnp.all(neg == neg[..., :1], axis=(-1, -2))
            bits.append(neg[..., 0].astype(jnp.uint8))
        bits = jnp.concatenate(bits, axis=1)
        synd = jnp.ones((B,), dtype=bool)
        for m in self._cn_blocks_of(m_cn):
            s = jnp.sum((m < self.nz).astype(jnp.int32), axis=-1) & 1
            synd = synd & jnp.all(s == 0, axis=-1)
        return bits, unan & synd

    def _cha_blocks(self, llr_cha):
        llr_cha_grp = llr_cha[:, self._vn_nodes].astype(self.msg_dtype)
        return [
            llr_cha_grp[:, blk.node_start : blk.node_start + blk.num_nodes]
            for blk in self.layout.vn_blocks
        ]

    # ------------------------------------------------------------------
    def _build(self):
        lay = self.layout
        T = self.T
        tail = self._make_tail(0)

        def decode(llr_cha, llr_msg):
            B = llr_cha.shape[0]
            llr_msg_grp = llr_msg[:, self._vn_nodes].astype(self.msg_dtype)
            cha_blocks = self._cha_blocks(llr_cha)

            # initial messages: every edge carries its variable's label
            parts = []
            for blk in lay.vn_blocks:
                seg = llr_msg_grp[:, blk.node_start : blk.node_start + blk.num_nodes]
                parts.append(
                    jnp.broadcast_to(
                        seg[..., None], (B, blk.num_nodes, blk.degree)
                    ).reshape(B, -1)
                )
            m_vn = jnp.concatenate(parts, axis=1)

            done = jnp.zeros((B,), dtype=bool)
            latched = jnp.zeros((B, self.nvar), dtype=jnp.uint8)
            iters = jnp.full((B,), T, dtype=jnp.int32)
            return tail(m_vn, cha_blocks, done, latched, iters)

        return decode

    def _make_tail(self, start: int):
        """Label-domain decode continuation from iteration `start`: scan
        over iterations start..T-2, then the final CN pass, decision trees
        and output syndrome.  `start`=0 is the full decode; `start`>0
        resumes from a carried message state (HybridLUTDecoder hands over
        the arithmetic prefix state here — bit-identical because decoding
        is deterministic in (messages, channel) and the per-iteration
        tables do not depend on history)."""
        lay = self.layout
        T = self.T
        early_exit = self.early_exit
        min_lut = self.codec.min_lut

        def slice_xs(entry):
            if isinstance(entry, list):
                return [a[start:] for a in entry]
            return entry[start:]

        var_xs = [slice_xs(e) for e in self._var_xs]
        chk_xs = None if min_lut else [slice_xs(e) for e in self._chk_xs]

        def tail(m_vn, cha_blocks, done, latched, iters):
            B = m_vn.shape[0]
            xs = {"var": var_xs}
            if not min_lut:
                xs["chk"] = chk_xs
            xs["it"] = jnp.arange(start, T - 1, dtype=jnp.int32)

            def body(carry, x):
                m_vn, done, latched, iters = carry
                it = x["it"]
                m_cn = jnp.take(m_vn, self._perm_v2c, axis=1)
                if early_exit:
                    bits, conv = self._convergence(m_vn, m_cn)
                    conv = conv & (it >= 1) & ~done
                    latched = jnp.where(conv[:, None], bits, latched)
                    iters = jnp.where(conv, it, iters)
                    done = done | conv
                m_cn = self._cn_update(m_cn, x.get("chk"))
                m_new = jnp.take(m_cn, self._perm_c2v, axis=1)
                outs = []
                for bi, blk in enumerate(lay.vn_blocks):
                    d, n, e0 = blk.degree, blk.num_nodes, blk.edge_start
                    m = m_new[:, e0 : e0 + n * d].reshape(B, n, d)
                    out = self._vn_update_block(bi, m, cha_blocks[bi], x["var"][bi])
                    outs.append(out.reshape(B, -1))
                m_next = jnp.concatenate(outs, axis=1)
                m_vn = jnp.where(done[:, None], m_vn, m_next)
                return (m_vn, done, latched, iters), None

            (m_vn, done, latched, iters), _ = jax.lax.scan(
                body, (m_vn, done, latched, iters), xs
            )

            # final iteration: check VN output of step T-2, then CN + decision
            m_cn = jnp.take(m_vn, self._perm_v2c, axis=1)
            if early_exit and T >= 2:
                bits, conv = self._convergence(m_vn, m_cn)
                conv = conv & ~done
                latched = jnp.where(conv[:, None], bits, latched)
                iters = jnp.where(conv, T - 1, iters)
                done = done | conv
            m_cn = self._cn_update(
                m_cn, self._chk_final if not min_lut else None
            )
            m_fin = jnp.take(m_cn, self._perm_c2v, axis=1)

            dec_bits = []
            for bi, blk in enumerate(lay.vn_blocks):
                d, n, e0 = blk.degree, blk.num_nodes, blk.edge_start
                m = m_fin[:, e0 : e0 + n * d].reshape(B, n, d)
                cha = cha_blocks[bi]
                if self._dec_kind[bi] == "composed":
                    idx = jnp.sum(
                        m.astype(jnp.int32) * self._bases[d][None, None, :], axis=-1
                    ) + cha.astype(jnp.int32) * (self.Nq**d)
                    out = jnp.take(self._dec_tab[bi], idx)
                else:
                    prog, tabs = self._dec_progs[bi]
                    x = jnp.concatenate([m, cha[..., None]], axis=-1)
                    out = self._run_program(prog, tabs, x)
                dec_bits.append((out < 1).astype(jnp.uint8))
            dec_bits = jnp.concatenate(dec_bits, axis=1)

            bits_grp = jnp.where(done[:, None], latched, dec_bits)
            # final syndrome on the decision output
            s_ok = jnp.ones((B,), dtype=bool)
            edge_bits = jnp.take(bits_grp, self._cn_var_pos, axis=1)
            pos = 0
            for blk in lay.cn_blocks:
                d, n = blk.degree, blk.num_nodes
                s = jnp.sum(
                    edge_bits[:, pos : pos + n * d].reshape(B, n, d).astype(jnp.int32),
                    axis=-1,
                ) & 1
                s_ok = s_ok & jnp.all(s == 0, axis=-1)
                pos += n * d
            ok = done | s_ok
            bits = jnp.take(bits_grp, self._vn_node_pos, axis=1)
            return bits, ok, iters

        return tail

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        return self._decode(
            jnp.asarray(llr_cha, dtype=jnp.int32), jnp.asarray(llr_msg, dtype=jnp.int32)
        )
