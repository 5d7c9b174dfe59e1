"""Value-domain LUT decoder: pure vector arithmetic, zero mid-loop gathers.

The third and fastest decoder implementation (after lut_decoder's unrolled
reference form and fast_decoder's table form), built on the validated
arithmetic representation of decoder/arith.py:

- messages are value arrays in an (E, B) layout: edge-major with the B
  frames of an edge row contiguous, so each of the two per-iteration
  permutation gathers moves whole rows and its index cost amortizes
  over B;
- the min-LUT CN update runs directly on values (sign parity + two-min on
  magnitudes), bit-identical to the label form by the validated
  monotone/symmetric value<->label correspondence;
- a VN tree node is add + threshold-count + piecewise-constant emission:
  elementwise work, no tables;
- one loop over iterations (`lax.while_loop` with early exit, else
  `lax.scan`) with per-iteration thresholds as loop inputs; the
  unanimity/syndrome early-exit latch reads signs of tensors the
  iteration already produces.

Choices in the elementwise passes, all exact:

- integer specs emit levels as ``lev0 + sum_k [s >= thr_k] * dlev_k``
  (exact in int16: levels are strictly monotone so the partial sums are
  bounded by the level table itself, and the count-of-thresholds form is
  literally how arith.py validates the representation) instead of a
  15-deep dependent select chain;
- VN leave-one-out uses total-minus-self for the all-messages first op
  (exact for integer values) and evaluates per output edge on (n, B)
  slices instead of materializing stacked (d, n, B) leaf arrays;
- converged frames are NOT frozen: outputs (bits/ok/iters) latch at first
  convergence and the state free-runs afterwards, which saves a full
  (E, B) select per iteration and is output-identical by construction.

Bit-exact to LUTDecoder/FastLUTDecoder (asserted in tests); built via
make_decoder, which falls back when build_arith_spec cannot prove
exactness.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .arith import ArithSpec, build_arith_spec
from .codec import LUTCodec
from .fast_layout import GroupedLayout

__all__ = ["ArithLUTDecoder"]


class ArithLUTDecoder:
    """Full decoder when built from a complete spec; with a prefix spec
    (dec_trees None) it decodes only the first spec.num_iters iterations
    and reports per-frame convergence — the fast first stage of
    StagedLUTDecoder."""

    def __init__(self, codec: LUTCodec, early_exit: bool = True,
                 spec: ArithSpec | None = None):
        self.codec = codec
        self.early_exit = early_exit
        self.spec = spec if spec is not None else build_arith_spec(codec)
        self.is_prefix = self.spec.dec_trees is None
        if self.is_prefix and not early_exit:
            raise ValueError("a prefix decoder requires early_exit")
        self.T = codec.max_iters
        self.S = self.spec.num_iters  # VN iterations covered by the scan
        self.nvar = codec.graph.nvar
        self._dtype_np = np.dtype(self.spec.dtype)
        self._dtype = jnp.dtype(self._dtype_np)
        self._is_int = np.issubdtype(self._dtype_np, np.integer)
        # align=16: every per-slot plane starts on a 16-row boundary;
        # padded rows carry garbage and all reductions in convergence()
        # mask them out
        self.layout = GroupedLayout(codec.graph, slot_major=True, align=16)
        # spec rows by degree: the spec may carry EXTRA degrees beyond the
        # graph's blocks (phantom-completed graphs: the codec designs trees
        # for the TRUE degree profile, e.g. the DVB-S2 staircase-wrap
        # dv=1 column that the completed graph holds as a dv=2 block)
        try:
            self._spec_di = [self.spec.degrees.index(blk.degree)
                             for blk in self.layout.vn_blocks]
        except ValueError:
            raise ValueError("arith spec degrees do not match graph blocks")
        self._build_phantoms()
        self._build_constants()
        self._decode = jax.jit(self._build())

    # ------------------------------------------------------------------
    def _build_phantoms(self):
        """Static bookkeeping for phantom completion edges (core/qc.py).

        Semantics (golden definition: decode_ref, decoder/codec.py): the
        phantom v2c value is pinned to the strongest positive level at
        every CN pass — min-sum is neutral to a max-magnitude positive
        input, so the completed check's outputs, sign parity, and
        syndrome equal the TRUE check's exactly — and the phantom node
        updates with its TRUE-degree trees over its real sockets, the
        phantom sockets mirroring the first real output so the unanimity
        sweep needs no masking."""
        from .arith import ArithBuildError

        lay = self.layout
        self._ph = []
        phantoms = self.codec.graph.phantoms
        if not phantoms:
            return
        by_var: dict = {}
        for p in phantoms:
            by_var.setdefault(p["var"], []).append(p)
        vn_node_pos = np.asarray(lay.vn_node_pos)
        perm_c2v = np.asarray(lay.perm_c2v)
        for v, plist in sorted(by_var.items()):
            node_row = int(vn_node_pos[v])
            bi = next(
                i for i, blk in enumerate(lay.vn_blocks)
                if blk.node_start <= node_row < blk.node_start + blk.n_pad
            )
            blk = lay.vn_blocks[bi]
            d = blk.degree
            off = node_row - blk.node_start
            rows = [blk.edge_start + k * blk.n_pad + off for k in range(d)]
            ph_slots = sorted(p["var_slot"] for p in plist)
            real_slots = [k for k in range(d) if k not in ph_slots]
            td = len(real_slots)
            if td < 1:
                raise ArithBuildError("phantom node with no real socket")
            try:
                di = self.spec.degrees.index(td)
            except ValueError:
                raise ArithBuildError(
                    f"spec lacks the true degree-{td} trees of a phantom "
                    "node (design the codec on the phantom graph)")
            self._ph.append(dict(
                v=v, bi=bi, off=off, d=d, td=td, di=di, node_row=node_row,
                rows_ph=[rows[k] for k in ph_slots],
                rows_real=[rows[k] for k in real_slots],
                cn_rows_ph=[int(perm_c2v[rows[k]]) for k in ph_slots],
                cn_rows_real=[int(perm_c2v[rows[k]]) for k in real_slots],
            ))
        self._pin = (
            np.asarray(32767, self._dtype_np) if self._is_int
            else np.asarray(np.finfo(self._dtype_np).max, self._dtype_np)
        )

    def _ph_pin_cn(self, m_cn):
        """Pin phantom v2c rows (CN-grouped layout) to the strongest
        positive value — before the syndrome read and the CN update."""
        if not self._ph:
            return m_cn
        rows = jnp.asarray([r for p in self._ph for r in p["cn_rows_ph"]])
        return m_cn.at[rows].set(jnp.asarray(self._pin, m_cn.dtype))

    def _ph_node_outputs(self, p, msgs, cha_row, var_prm):
        """TRUE-degree leave-one-out outputs of one phantom node.

        msgs: list of td real c2v value rows (slot order), cha_row the
        node's channel value row; var_prm the iteration-sliced op params
        of the true-degree spec row.  Returns td output rows (storage
        dtype)."""
        di = p["di"]
        struct = self._var_struct[di]
        fp = self._fp_block[di]
        outs = []
        for i in range(p["td"]):
            x_vals = [msgs[j] for j in range(p["td"]) if j != i] + [cha_row]
            o = self._eval_tree(struct, x_vals, var_prm, fp=fp)
            outs.append(o.astype(self._dtype) if fp else o)
        return outs

    def _ph_dec_fix(self, dec_bits, m_fin, cha_blocks):
        """True-degree decision-tree output for phantom nodes (m_fin: the
        final c2v values in the VN-grouped standard layout)."""
        for p in self._ph:
            spec = self._dec_specs[p["di"]]
            x_vals = ([m_fin[r] for r in p["rows_real"]]
                      + [cha_blocks[p["bi"]][p["off"]]])
            prm, fp = self._dec_prm(spec)
            out = self._eval_tree(spec, x_vals, prm, fp=fp)
            dec_bits = dec_bits.at[p["node_row"]].set(
                (out < 0).astype(dec_bits.dtype))
        return dec_bits

    def _ph_zero_edge_bits(self, edge_bits):
        """Phantom (var, check) pairs contribute nothing to the bit-level
        syndrome of the TRUE matrix."""
        if not self._ph:
            return edge_bits
        rows = jnp.asarray([r for p in self._ph for r in p["cn_rows_ph"]])
        return edge_bits.at[rows].set(0)

    def _build_constants(self):
        lay = self.layout
        self._perm_v2c = jnp.asarray(lay.perm_v2c)
        self._perm_c2v = jnp.asarray(lay.perm_c2v)
        self._vn_nodes = jnp.asarray(lay.vn_nodes)
        self._vn_node_pos = jnp.asarray(lay.vn_node_pos)
        self._cn_var_pos = jnp.asarray(lay.cn_var_pos)
        self._leaf_msg0 = jnp.asarray(self.spec.leaf_msg0)
        self._leaf_cha = jnp.asarray(self.spec.leaf_cha)
        # per-block pad masks: True at PADDED node rows (masked out of every
        # unanimity / syndrome reduction)
        self._vn_padmask = [
            jnp.asarray(np.arange(blk.n_pad) >= blk.num_nodes)
            for blk in lay.vn_blocks
        ]
        self._cn_padmask = [
            jnp.asarray(np.arange(blk.n_pad) >= blk.num_nodes)
            for blk in lay.cn_blocks
        ]

        # stacked per-iteration op parameters: per block, per op:
        # thr (S, K-1), levels (S, K) [+ lev0/dlev for integer specs,
        # sthr/smag for symmetric emission]; static per-op flags (sym,
        # has_tie, fp) live in _op_flags, outside the scanned pytrees.
        # Blocks with any float_params op (center-pair-repaired interior
        # tables inside an int16 spec) evaluate their whole tree in f32 —
        # exact on the int16 grid (all values/sums < 2^24) — with float
        # select-chain emission; message STORAGE stays int16.
        # indexed per SPEC ROW (== per layout block for ordinary graphs;
        # phantom-completed graphs carry extra true-degree rows, mapped
        # through self._spec_di)
        self._var_xs = []
        self._var_struct = []  # per spec row: ArithTreeSpec (structure only)
        self._op_flags = []  # per spec row: list of per-op static flag dicts
        self._fp_block = []  # per spec row: tree evaluates in f32
        S = self.S
        dt = self._dtype_np
        for bi in range(len(self.spec.degrees)):
            tree0 = self.spec.var_trees[0][bi] if S > 0 else None
            self._var_struct.append(tree0)
            ops_xs = []
            flags = []
            fp_block = False
            if S > 0:
                for oi in range(len(tree0.ops)):
                    specs_oi = [self.spec.var_trees[ii][bi].ops[oi]
                                for ii in range(S)]
                    fp = any(sp.float_params for sp in specs_oi)
                    fp_block = fp_block or fp
                    thr = np.stack(
                        [np.asarray(sp.thresholds, np.float32 if fp else None)
                         for sp in specs_oi]
                    )
                    levels = np.stack(
                        [np.asarray(sp.levels, np.float32 if fp else None)
                         for sp in specs_oi]
                    )
                    tie_lo = np.array([sp.tie_lo for sp in specs_oi],
                                      dtype=np.float32 if fp else dt)
                    tie_hi = np.array([sp.tie_hi for sp in specs_oi],
                                      dtype=np.float32 if fp else dt)
                    prm = dict(thr=jnp.asarray(thr), levels=jnp.asarray(levels),
                               tie_lo=jnp.asarray(tie_lo), tie_hi=jnp.asarray(tie_hi))
                    if self._is_int and not fp:
                        # delta-emission parameters (see module docstring)
                        prm["lev0"] = jnp.asarray(levels[:, 0].astype(dt))
                        prm["dlev"] = jnp.asarray(
                            np.diff(levels.astype(np.int64), axis=1).astype(dt)
                        )
                    if all(sp.sym_thr is not None for sp in specs_oi):
                        # symmetric sign x magnitude emission (arith.py):
                        # half the thresholds, validated per iteration
                        prm["sthr"] = jnp.asarray(
                            np.stack([np.asarray(sp.sym_thr,
                                                 np.float32 if fp else None)
                                      for sp in specs_oi]))
                        prm["smag"] = jnp.asarray(
                            np.stack([np.asarray(sp.sym_levels,
                                                 np.float32 if fp else None)
                                      for sp in specs_oi]))
                    flags.append(dict(
                        has_tie=any(sp.has_zero for sp in specs_oi),
                    ))
                    ops_xs.append(prm)
            self._var_xs.append(ops_xs)
            self._op_flags.append(flags)
            self._fp_block.append(fp_block)
        self._dec_specs = self.spec.dec_trees

    # ------------------------------------------------------------------
    def _permute_v2c(self, m):
        """VN-grouped (E, B) -> CN-grouped (E, B): one row gather.

        Pad rows of the output take row 0's values (arbitrary: they are
        masked out of every reduction)."""
        return jnp.take(m, self._perm_v2c, axis=0)

    def _permute_c2v(self, m):
        """CN-grouped (E, B) -> VN-grouped (E, B): the inverse gather."""
        return jnp.take(m, self._perm_c2v, axis=0)

    # ------------------------------------------------------------------
    def _vn_blocks_of(self, m):
        # slot-major: block range reshapes to (d, n_pad, B), contiguous slots
        out = []
        for blk in self.layout.vn_blocks:
            d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
            out.append(m[e0 : e0 + n * d].reshape(d, n, -1))
        return out

    def _cn_blocks_of(self, m):
        out = []
        for blk in self.layout.cn_blocks:
            d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
            out.append(m[e0 : e0 + n * d].reshape(d, n, -1))
        return out

    @staticmethod
    def _cn_minsum_values(m):
        """Min-LUT CN update on values; m (d, n, B), slot-major.

        out_i = (sign parity excluding i) * min_{j != i} |m_j| via
        prefix/suffix mins over contiguous slot slices — value-identical to
        the reference's min1/min2/argmin formulation (chk_update_minsum,
        LDPC_Code_LUT.cpp:355: for i = argmin the min of the others IS
        min2, elsewhere min1; duplicated minima give the same value either
        way) without the costly argmin/one-hot."""
        d = m.shape[0]
        neg = m < 0
        mag = jnp.abs(m)
        INF = jnp.asarray(
            np.iinfo(m.dtype).max if jnp.issubdtype(m.dtype, jnp.integer)
            else np.inf,
            m.dtype,
        )
        pre = [jnp.full(m.shape[1:], INF, m.dtype)]
        for j in range(d - 1):
            pre.append(jnp.minimum(pre[-1], mag[j]))
        suf = [jnp.full(m.shape[1:], INF, m.dtype)]
        for j in range(d - 1, 0, -1):
            suf.append(jnp.minimum(suf[-1], mag[j]))
        suf = suf[::-1]
        tmp = jnp.stack([jnp.minimum(pre[j], suf[j]) for j in range(d)], axis=0)
        sign_prod = (jnp.sum(neg, axis=0, keepdims=True) & 1).astype(bool)
        return jnp.where(sign_prod ^ neg, -tmp, tmp)

    # ------------------------------------------------------------------
    def _emit(self, s, prm, tie_ref, flags=None, dt=None):
        """Piecewise-constant emission for one op at one iteration.

        Symmetric specs (sthr/smag present): sign x magnitude chain over
        HALF the thresholds (validated exhaustively at build, arith.py).
        Integer specs: exact threshold-count delta form (module docstring).
        Float specs — and float_params ops inside integer specs (fp blocks
        pass dt=float32): the validated sequential select chain
        (rounding-exact by construction).  Zero sums emit the explicit tie
        outputs selected by the sign of the most-significant operand; ops
        with no reachable zero sum (has_tie False) skip the tie select
        entirely."""
        use_int = self._is_int and dt is None
        dt = self._dtype if dt is None else dt
        if "sthr" in prm:
            nthr = prm["sthr"].shape[-1]
            m = jnp.abs(s)
            out = jnp.broadcast_to(prm["smag"][..., 0], s.shape).astype(dt)
            for k in range(nthr):
                out = jnp.where(m >= prm["sthr"][..., k],
                                prm["smag"][..., k + 1], out)
            out = jnp.where(s < 0, -out, out)
        elif use_int:
            nthr = prm["thr"].shape[-1]
            acc = jnp.broadcast_to(prm["lev0"], s.shape).astype(dt)
            zero = jnp.zeros((), dt)
            for k in range(nthr):
                acc = acc + jnp.where(s >= prm["thr"][..., k],
                                      prm["dlev"][..., k], zero)
            out = acc
        else:
            nthr = prm["thr"].shape[-1]
            out = jnp.broadcast_to(prm["levels"][..., 0], s.shape).astype(dt)
            for k in range(nthr):
                out = jnp.where(s >= prm["thr"][..., k],
                                prm["levels"][..., k + 1], out)
        if flags is not None and not flags["has_tie"]:
            return out
        tie = jnp.where(tie_ref < 0, prm["tie_lo"], prm["tie_hi"])
        return jnp.where(s == 0, tie.astype(dt), out)

    def _eval_tree(self, struct, x_vals, op_params, fp=False):
        """x_vals: list of leaf value arrays (DFS order), each (..., B).
        op_params: per-op dict for ONE iteration (already sliced).  Returns
        root output values (f32 when fp: trees containing float_params ops
        evaluate wholly in f32 — exact on the int16 grid)."""
        cdt = jnp.float32 if fp else None
        vals = [v.astype(jnp.float32) for v in x_vals] if fp else list(x_vals)
        for op, prm in zip(struct.ops, op_params):
            s = vals[op.operands[0]]
            for sl in op.operands[1:]:
                s = s + vals[sl]
            vals.append(self._emit(s, prm, vals[op.operands[-1]], dt=cdt))
        return vals[-1]

    def _dec_prm(self, spec):
        """Per-op param dicts for a decision tree + the tree's fp flag."""
        fp = any(op.float_params for op in spec.ops)
        prm = []
        for op in spec.ops:
            cast = np.float32 if fp else None
            p = dict(thr=jnp.asarray(np.asarray(op.thresholds, cast)),
                     levels=jnp.asarray(np.asarray(op.levels, cast)),
                     tie_lo=jnp.asarray(np.asarray(
                         op.tie_lo, np.float32 if fp else self._dtype_np)),
                     tie_hi=jnp.asarray(np.asarray(
                         op.tie_hi, np.float32 if fp else self._dtype_np)))
            if self._is_int and not fp:
                lv = np.asarray(op.levels, np.int64)
                p["lev0"] = jnp.asarray(lv[0].astype(self._dtype_np))
                p["dlev"] = jnp.asarray(np.diff(lv).astype(self._dtype_np))
            prm.append(p)
        return prm, fp

    def _vn_block_update(self, bi, blk, m, cha_b, prm):
        """All d leave-one-out outputs of one degree block.

        m (d, n, B) message values, cha_b (n, B) channel values, prm per-op
        iteration-sliced params.  Evaluates per output edge on (n, B)
        slices (no stacked (d, n, B) leaf materialization); when the first
        op consumes all message leaves and values are integers, its sum is
        total-minus-self (exact).  Returns (d, n, B)."""
        d = blk.degree
        di = self._spec_di[bi]
        struct = self._var_struct[di]
        fp = self._fp_block[di]
        cdt = jnp.float32 if fp else None
        if fp:
            # f32 tree evaluation (exact on the int16 grid): required by
            # float_params ops, bit-identical for the integer ops too
            m = m.astype(jnp.float32)
            cha_b = cha_b.astype(jnp.float32)
        from .arith import loo_msg_spans

        spans = loo_msg_spans(struct)
        n_in = struct.num_inputs  # d: d-1 message positions + cha (last)
        nops = len(struct.ops)
        all_msgs = struct.ops[0].operands == tuple(range(d - 1)) and d >= 3
        tot = None
        if all_msgs and self._is_int:
            tot = m[0]
            for j in range(1, d):
                tot = tot + m[j]

        def emit_op(oi, s, tie_src):
            return self._emit(s, prm[oi], tie_src,
                              self._op_flags[di][oi], dt=cdt)

        def sweep(shift):
            # full bottom-up evaluation under one leaf assignment:
            # position j -> m[j + shift]; shared across the LOO outputs
            vals = [m[j + shift] for j in range(d - 1)] + [cha_b]
            for oi, op in enumerate(struct.ops):
                s = vals[op.operands[0]]
                for sl in op.operands[1:]:
                    s = s + vals[sl]
                vals.append(emit_op(oi, s, vals[op.operands[-1]]))
            return vals[n_in:]

        id_out = sweep(0)  # identity: positions 0..d-2 -> m_0..m_{d-2}
        s1_out = sweep(1) if d >= 2 else id_out  # shift1 -> m_1..m_{d-1}

        outs = []
        for i in range(d):
            if i == d - 1:
                outs.append(id_out[-1])
                continue
            if i == 0:
                outs.append(s1_out[-1])
                continue
            cache: dict = {}

            def val(x, i=i, cache=cache):
                if x < n_in - 1:  # message at position x
                    return m[x] if x < i else m[x + 1]
                if x == n_in - 1:
                    return cha_b
                k = x - n_in
                sp = spans[k]
                if sp is None or sp[1] < i:
                    return id_out[k]
                if sp[0] >= i:
                    return s1_out[k]
                if k not in cache:
                    op = struct.ops[k]
                    if k == 0 and tot is not None:
                        s = tot - m[i]
                    else:
                        s = val(op.operands[0])
                        for sl in op.operands[1:]:
                            s = s + val(sl)
                    cache[k] = emit_op(k, s, val(op.operands[-1]))
                return cache[k]

            outs.append(val(n_in + nops - 1))
        out = jnp.stack(outs, axis=0)
        return out.astype(self._dtype) if fp else out

    def _select_values(self, labels, table):
        """labels (..., ) int32 -> values via dense 16-way select."""
        v = jnp.zeros(labels.shape, self._dtype)
        for k in range(table.shape[0]):
            v = jnp.where(labels == k, table[k], v)
        return v

    # ------------------------------------------------------------------
    def _raw_carry_fn(self):
        """Unjitted (llr_cha, llr_msg) -> (m_vn values (E_pad, B)
        slot-major, done, latched, iters) at loop exit, BEFORE the
        post-loop convergence check — the hand-off point for
        HybridLUTDecoder's label-domain continuation tail."""
        if not self.early_exit:
            raise ValueError("raw carry requires early_exit")
        return self._build(raw=True)

    # ------------------------------------------------------------------
    def _build(self, raw: bool = False, cont_from: int | None = None):
        """Unjitted decode function.

        cont_from=k (requires early_exit): CONTINUATION segment for the
        mixed-precision decoders (decoder/hybrid.py).  The returned
        function has signature (llr_cha, v0_edges, done, latched, iters)
        and runs iterations [k, S) from per-edge message values v0_edges
        ((E_vn_pad, B) slot-major, this spec's value domain, i.e. this
        spec's iteration-k input table entries) plus the early-exit state
        of the previous segment.  Its first convergence check reads the
        signs of v0_edges, which the value re-embedding preserves, so the
        composition keeps single-decoder semantics exactly."""
        if cont_from is not None and not self.early_exit:
            raise ValueError("cont_from requires early-exit mode")
        lay = self.layout
        T = self.T
        early_exit = self.early_exit

        def convergence(m_vn, m_cn):
            bits, unan = [], None
            for bi, m in enumerate(self._vn_blocks_of(m_vn)):  # (d, n_pad, B)
                neg = m < 0
                agreen = jnp.all(neg == neg[:1], axis=0)  # (n_pad, B)
                agree = jnp.all(
                    agreen | self._vn_padmask[bi][:, None], axis=0
                )  # (B,)
                unan = agree if unan is None else (unan & agree)
                bits.append(neg[0].astype(jnp.uint8))  # (n_pad, B)
            bits = jnp.concatenate(bits, axis=0)  # (nvar_pad, B)
            synd = None
            for bi, m in enumerate(self._cn_blocks_of(m_cn)):
                s = jnp.sum((m < 0).astype(jnp.int32), axis=0) & 1  # (n_pad, B)
                ok = jnp.all(
                    (s == 0) | self._cn_padmask[bi][:, None], axis=0
                )
                synd = ok if synd is None else (synd & ok)
            return bits, unan & synd

        def decode(llr_cha, *state):
            # inputs (B, nvar) int32 labels -> grouped (nvar_pad, B) values
            B = llr_cha.shape[0]
            cha_lab = llr_cha[:, self._vn_nodes].T  # (nvar_pad, B) grouped
            vcha = self._select_values(cha_lab, self._leaf_cha)
            cha_blocks = [
                vcha[blk.node_start : blk.node_start + blk.n_pad]
                for blk in lay.vn_blocks
            ]
            if cont_from is None:
                llr_msg, = state
                msg_lab = llr_msg[:, self._vn_nodes].T
                v0 = self._select_values(msg_lab, self._leaf_msg0)
                parts = []
                for blk in lay.vn_blocks:
                    seg = v0[blk.node_start : blk.node_start + blk.n_pad]
                    parts.append(
                        jnp.broadcast_to(seg[None], (blk.degree, blk.n_pad, B))
                        .reshape(-1, B)
                    )
                m_vn = jnp.concatenate(parts, axis=0)  # (E_vn_pad, B)

                done = jnp.zeros((B,), dtype=bool)
                latched = jnp.zeros((lay.nvar_pad, B), dtype=jnp.uint8)
                iters = jnp.full((B,), T, dtype=jnp.int32)
            else:
                v0_edges, done, latched, iters = state
                m_vn = jnp.asarray(v0_edges, self._dtype)

            xs = dict(it=jnp.arange(self.S, dtype=jnp.int32))
            xs["var"] = self._var_xs

            def body(carry, x, cha_blocks_s):
                m_vn, done, latched, iters = carry
                W = m_vn.shape[-1]
                it = x["it"]
                m_cn = self._ph_pin_cn(self._permute_v2c(m_vn))
                if early_exit:
                    bits, conv = convergence(m_vn, m_cn)
                    conv = conv & (it >= 1) & ~done
                    latched = jnp.where(conv[None, :], bits, latched)
                    iters = jnp.where(conv, it, iters)
                    done = done | conv
                outs = []
                for m in self._cn_blocks_of(m_cn):
                    outs.append(self._cn_minsum_values(m).reshape(-1, W))
                m_cn = jnp.concatenate(outs, axis=0)
                m_new = self._permute_c2v(m_cn)
                outs = []
                for bi, blk in enumerate(lay.vn_blocks):
                    d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
                    m = m_new[e0 : e0 + n * d].reshape(d, n, W)
                    out = self._vn_block_update(bi, blk, m, cha_blocks_s[bi],
                                                x["var"][self._spec_di[bi]])
                    outs.append(out.reshape(-1, W))
                m_vn = jnp.concatenate(outs, axis=0)
                # phantom nodes: true-degree update over the real sockets,
                # phantom sockets mirror output 0 (unanimity-transparent)
                for p in self._ph:
                    msgs = [m_new[r] for r in p["rows_real"]]
                    cha_row = cha_blocks_s[p["bi"]][p["off"]]
                    po = self._ph_node_outputs(p, msgs, cha_row,
                                               x["var"][p["di"]])
                    for r, o in zip(p["rows_real"], po):
                        m_vn = m_vn.at[r].set(o)
                    for r in p["rows_ph"]:
                        m_vn = m_vn.at[r].set(po[0])
                # converged frames are not frozen; their outputs are latched
                # above and later state is never read (output-identical)
                return (m_vn, done, latched, iters), None

            if early_exit and self.S > 0:
                # true early exit with survivor compaction ("funnel"):
                # each stage is a while_loop that stops when the number of
                # undecided frames drops to the next stage's width (or the
                # budget S runs out); the survivors are then gathered into
                # a narrower batch and the loop continues there, so late
                # iterations (few live frames) stop paying full-batch
                # time.  Frames are independent and deterministic, so
                # outputs are bit-identical to the single-width loop:
                # finished frames' outputs are latched before compaction,
                # and a stage's gather provably contains every undecided
                # frame (the stage cond enforces live <= next width at
                # exit; a budget exhaustion exit makes every later stage a
                # zero-iteration no-op).
                S = self.S

                def make_loop(cha_blocks_s, stop_live):
                    def wbody(carry):
                        it, m_vn, done, latched, iters = carry
                        x = dict(
                            it=it,
                            var=jax.tree_util.tree_map(
                                lambda a: a[it], self._var_xs
                            ),
                        )
                        (m_vn, done, latched, iters), _ = body(
                            (m_vn, done, latched, iters), x, cha_blocks_s
                        )
                        return (it + 1, m_vn, done, latched, iters)

                    def wcond(carry):
                        live = jnp.sum(~carry[2])
                        return (carry[0] < S) & (live > stop_live)

                    return wcond, wbody

                widths = self._funnel_widths(B)
                it = jnp.full((), cont_from or 0, jnp.int32)
                cha_s = cha_blocks
                stack = []
                for si, Wc in enumerate(widths):
                    nxt = widths[si + 1] if si + 1 < len(widths) else 0
                    wcond, wbody = make_loop(cha_s, nxt)
                    it, m_vn, done, latched, iters = jax.lax.while_loop(
                        wcond, wbody, (it, m_vn, done, latched, iters)
                    )
                    if nxt:
                        # stable ascending sort of done: the first `nxt`
                        # columns hold every undecided frame, padded with
                        # finished ones
                        idx = jnp.argsort(done)[:nxt]
                        stack.append((idx, (m_vn, done, latched, iters)))
                        m_vn = m_vn[:, idx]
                        done = done[idx]
                        latched = latched[:, idx]
                        iters = iters[idx]
                        cha_s = [c[:, idx] for c in cha_s]
                for idx, full in reversed(stack):
                    fm, fd, fl, fi = full
                    m_vn = fm.at[:, idx].set(m_vn)
                    done = fd.at[idx].set(done)
                    latched = fl.at[:, idx].set(latched)
                    iters = fi.at[idx].set(iters)
            else:
                (m_vn, done, latched, iters), _ = jax.lax.scan(
                    functools.partial(body, cha_blocks_s=cha_blocks),
                    (m_vn, done, latched, iters), xs
                )

            if raw:
                return m_vn, done, latched, iters

            m_cn = self._ph_pin_cn(self._permute_v2c(m_vn))
            if early_exit and self.S >= 1:
                # covers the VN output of the last loop step
                bits, conv = convergence(m_vn, m_cn)
                conv = conv & ~done
                latched = jnp.where(conv[None, :], bits, latched)
                iters = jnp.where(conv, self.S, iters)
                done = done | conv

            if self.is_prefix:
                bits = jnp.take(latched, self._vn_node_pos, axis=0).T
                return bits, done, iters
            outs = []
            for m in self._cn_blocks_of(m_cn):
                outs.append(self._cn_minsum_values(m).reshape(-1, B))
            m_cn = jnp.concatenate(outs, axis=0)
            m_fin = self._permute_c2v(m_cn)

            dec_bits = []
            for bi, blk in enumerate(lay.vn_blocks):
                d, n, e0 = blk.degree, blk.n_pad, blk.edge_start
                m = m_fin[e0 : e0 + n * d].reshape(d, n, B)
                spec = self._dec_specs[self._spec_di[bi]]
                x_vals = [m[j] for j in range(d)] + [cha_blocks[bi]]
                prm, fp = self._dec_prm(spec)
                out = self._eval_tree(spec, x_vals, prm, fp=fp)  # (n_pad, B)
                dec_bits.append((out < 0).astype(jnp.uint8))
            dec_bits = jnp.concatenate(dec_bits, axis=0)  # (nvar_pad, B)
            dec_bits = self._ph_dec_fix(dec_bits, m_fin, cha_blocks)

            bits_grp = jnp.where(done[None, :], latched, dec_bits)
            edge_bits = jnp.take(bits_grp, self._cn_var_pos, axis=0)
            edge_bits = self._ph_zero_edge_bits(edge_bits)
            s_ok = None
            pos = 0
            for bi, blk in enumerate(lay.cn_blocks):
                d, n = blk.degree, blk.n_pad
                s = jnp.sum(
                    edge_bits[pos : pos + n * d].reshape(d, n, B).astype(jnp.int32),
                    axis=0,
                ) & 1
                ok = jnp.all((s == 0) | self._cn_padmask[bi][:, None], axis=0)
                s_ok = ok if s_ok is None else (s_ok & ok)
                pos += n * d
            ok = done | s_ok
            bits = jnp.take(bits_grp, self._vn_node_pos, axis=0).T  # (B, nvar)
            return bits, ok, iters

        return decode

    # ------------------------------------------------------------------
    @staticmethod
    def _funnel_widths(B: int) -> list:
        """Stage widths for survivor compaction: [B, B/4, B/16], floored
        at 512 frames (LUT_FUNNEL_MIN).  LUT_FUNNEL overrides: "0"/"off"
        disables, else comma-separated divisors (e.g. "4,16")."""
        import os

        env = os.environ.get("LUT_FUNNEL", "")
        if env.lower() in ("0", "off", "none"):
            return [B]
        divs = [4, 16]
        if env:
            divs = [int(x) for x in env.split(",") if x.strip()]
        floor = int(os.environ.get("LUT_FUNNEL_MIN", "512"))
        widths = [B]
        for d in divs:
            w = B // d
            if w >= floor and w < widths[-1]:
                widths.append(w)
        return widths

    # ------------------------------------------------------------------
    def __call__(self, llr_cha, llr_msg):
        return self._decode(
            jnp.asarray(llr_cha, dtype=jnp.int32), jnp.asarray(llr_msg, dtype=jnp.int32)
        )
