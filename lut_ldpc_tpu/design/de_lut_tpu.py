"""Batched LUT density evolution on the accelerator: the SURVEY §2
parallelism mapping for the DE-LUT design engine ("DE pmf updates are tiny
dense ops — batch them").

The host engine (de.DELut) is float64 and sequential over both DE
iterations and bisection probes — exactly what the reference does
(/root/reference/src/LDPC_DE.cpp:105-612) and what bit-identical designed
LUTs require.  Threshold *searches*, however, evaluate evolve() at many
independent noise levels; this module evaluates a whole sigma grid in ONE
jitted program:

- the MI-optimal quantizer DP (ops/quant.quant_mi_sym, the engine that
  designs every LUT) is re-expressed as dense batched tensor math: the
  partial-MI table g[ap, a] from two prefix-sum outer differences, the
  boundary recursion as Nq/2-1 unrolled masked argmax steps (first-argmax
  tie-break like the host), and the LLR sort as a batched stable argsort
  (stability keeps the permutation symmetric, like sym_llr_sort_unique),
- LUT-tree evaluation as a static schedule of pairwise pmf joins
  (Kronecker outer products) extracted from the same tree templates the
  host engine uses,
- the min-LUT CN update as suffix-sum min-combinations in the +/-
  transform domain (ops/pmf.chk_update_minsum, batched),
- the joint_root irregular strategy as one wider DP over the concatenated
  weighted root pmfs with per-origin segment sums (de.level_lut_tree_update),
- per-point exit conditions (Pe < Pe_max, non-improving budget) carried as
  masks in a lax.while_loop that stops when every sigma has decided.

Device arithmetic is float32, so a grid evaluation locates the threshold to
~1e-3 in sigma rather than the 1e-6 the f64 host bisection resolves, and
duplicate-LLR label merging is skipped (a tie-breaking refinement that
moves thresholds well below f32 resolution).  threshold() therefore runs
coarse-to-fine f32 grid rounds on the accelerator and (optionally) hands
the final bracket to the host f64 engine — sweeps get accelerator
throughput, published numbers keep host precision.  Explorer scope:
min-LUT and full-LUT (CN tree) modes, uniform OR per-iteration vector
message resolutions (the segmented evolve runs constant-resolution runs
as while_loops with latched exits), binary tree shapes
(auto_bin_balanced / auto_bin_high), individual / joint_root /
joint_level design strategies (joint_level batches one
level_lut_tree_update DP per tree level, de.py:405); reuse pre-ranking
(prerank_reuse) covers uniform-resolution min-LUT.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.trees import CHA, CHKTREE, VARTREE, LUTTree
from ..ops.pmf import get_gaussian_pmf, rate_to_shannon_thr
from ..ops.quant import quant_mi_sym
from .de import INDIVIDUAL, JOINT_LEVEL, JOINT_ROOT

__all__ = ["DELutTPU"]

_LOG_FLOOR = 1e-37  # f32 llr-sort guard: masses below this are rounding noise


def _tree_schedule(tree: LUTTree) -> tuple[list, list, list]:
    """Post-order list of pairwise joins; sources are 'msg' / 'cha' / int
    (earlier op index).  The last op is the root.  Also returns each op's
    LEVEL (distance of its node from the root, host level_nodes
    convention) and its node's leaf count — the joint_level strategy
    groups ops by level and weights them by leaves."""
    ops: list[tuple] = []
    levels: list[int] = []
    leaves: list[int] = []

    def rec(node, depth):
        if node.is_leaf():
            return ("cha" if node.type == CHA else "msg"), 1
        subs = [rec(c, depth + 1) for c in node.children]
        if len(subs) == 1:
            # degree-1 VN: root over the channel leaf alone; a 16->16
            # requantization is a relabeling, which DE is invariant to
            return subs[0]
        if len(subs) != 2:
            raise ValueError(
                "DELutTPU supports binary tree shapes only "
                "(auto_bin_balanced / auto_bin_high)"
            )
        (sa, la), (sb, lb) = subs
        ops.append((sa, sb))
        levels.append(depth)
        leaves.append(la + lb)
        return len(ops) - 1, la + lb

    root_src, _ = rec(tree.root, 0)
    if not ops:
        # single-leaf tree: pass-through marker
        ops.append((root_src, None))
        levels.append(0)
        leaves.append(1)
    return ops, levels, leaves


def _xlog2y(x, y):
    return jnp.where(x > 0, x * (jnp.log(jnp.where(y > 0, y, 1.0)) / np.log(2.0)), 0.0)


class DELutTPU:
    """Batched-evolve DE engine for min-LUT decoders.

    evolve_batch(sigmas) evaluates a whole noise grid on the default JAX
    device in one jit; threshold() runs a coarse-to-fine grid search with
    optional f64 host refinement (pass a host de.DELut via host=).
    """

    def __init__(self, ens, Nq_Cha: int = 16, Nq_Msg: int = 16,
                 maxiter_de: int = 200, Pe_max: float = 1e-6,
                 max_ni_de_iters: int = 1, LLR_max: float = 25.0,
                 Nq_fine: int = 5000, tree_mode: str = "auto_bin_balanced",
                 strategy: str = JOINT_ROOT, host=None, min_lut: bool = True,
                 mesh=None):
        if strategy not in (INDIVIDUAL, JOINT_ROOT, JOINT_LEVEL):
            raise ValueError(
                f"DELutTPU supports individual/joint_root/joint_level "
                f"strategies, not {strategy}"
            )
        self.ens = ens
        self.Nq_Cha = int(Nq_Cha)
        # scalar = uniform per-iteration resolution; a vector (length
        # maxiter_de, host Nq_Msg_vec semantics: entry ii = resolution of
        # the messages PRODUCED by VN iteration ii-1 / consumed by ii)
        # runs the segmented evolve path
        if np.isscalar(Nq_Msg):
            self.Nq_Msg_vec = np.full(int(maxiter_de), int(Nq_Msg), np.int64)
        else:
            self.Nq_Msg_vec = np.asarray(Nq_Msg, dtype=np.int64)
            if len(self.Nq_Msg_vec) != int(maxiter_de):
                raise ValueError("Nq_Msg vector must have maxiter_de entries")
        self.uniform_nq = bool(np.all(self.Nq_Msg_vec == self.Nq_Msg_vec[0]))
        self.Nq_Msg = int(self.Nq_Msg_vec[0])
        self.maxiter_de = int(maxiter_de)
        # f32 floor: pmf tails below ~1e-7 are rounding noise
        self.Pe_max = max(float(Pe_max), 1e-6)
        self.max_ni_de_iters = int(max_ni_de_iters)
        self.LLR_max = float(LLR_max)
        self.Nq_fine = int(Nq_fine)
        self.strategy = strategy
        self.min_lut = bool(min_lut)
        self.host = host
        self.thr_min = rate_to_shannon_thr(ens.rate()) * 1e-4
        self.thr_max = rate_to_shannon_thr(ens.rate())

        # one schedule per active VN degree (same shape every iteration;
        # the terminal decision tree only affects the hard output, not the
        # threshold); levels/leaves feed the joint_level strategy
        trip = [_tree_schedule(LUTTree.auto(int(d), VARTREE, tree_mode))
                for d in ens.degree_lam]
        self._schedules = [t[0] for t in trip]
        self._sched_levels = [t[1] for t in trip]
        self._sched_leaves = [t[2] for t in trip]
        # full-LUT mode: CN trees over dc-1 message leaves (LDPC_DE.cpp:
        # 414-489 non-min branch); min-LUT uses the closed-form pmf min-sum
        if self.min_lut:
            self._chk_schedules = None
            self._chk_levels = self._chk_leaves = None
        else:
            ctrip = [_tree_schedule(LUTTree.auto(int(d) - 1, CHKTREE,
                                                 tree_mode))
                     for d in ens.degree_rho]
            self._chk_schedules = [t[0] for t in ctrip]
            self._chk_levels = [t[1] for t in ctrip]
            self._chk_leaves = [t[2] for t in ctrip]
        if any(int(d) == 1 for d in ens.degree_lam) and self.Nq_Cha != self.Nq_Msg:
            raise NotImplementedError(
                "degree-1 VNs with Nq_Cha != Nq_Msg need a real root requant"
            )
        # mesh: shard the sigma-grid / candidate axis over a ('dp',)
        # device mesh — the device mapping of de_sim's thread-per-sweep-point
        # fan-out (/root/reference/prog/de_sim.cpp:275).  Points are
        # independent (no collectives); each shard's while_loop exits on
        # its own points, and per-point results latch at their own exit,
        # so sharded results equal the single-device batch exactly.
        self.mesh = mesh
        evolve = self._build_evolve()
        if mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            evolve = shard_map(
                evolve, mesh=mesh, in_specs=(P("dp"), P("dp")),
                out_specs=(P("dp"), P("dp"), P("dp")), check_vma=False)
        self._evolve = jax.jit(evolve)
        self._evolve_reuse = {}  # pmax -> jitted reuse-aware program

    def _mesh_pad(self) -> int:
        """Leading-axis padding multiple for sharded batches."""
        if self.mesh is None:
            return 1
        import numpy as _np

        return int(_np.prod(list(self.mesh.shape.values())))

    # -- batched quantizer DP -------------------------------------------
    def _design(self, p_sorted, K):
        """MI-optimal boundaries for LLR-sorted symmetric pmfs.

        p_sorted: (S, 2H) ascending-LLR.  Returns astar (S, K/2+1) int32
        interval boundaries into the upper half, astar[0]=0, astar[K/2]=H.
        Mirrors ops/quant.quant_mi_sym's DP (common.cpp:276-311) including
        the first-argmax tie-break, in f32 without duplicate-LLR merging.
        """
        Sb, M = p_sorted.shape
        H = M // 2
        Kh = K // 2
        pu = p_sorted[:, H:]
        plr = p_sorted[:, :H][:, ::-1]
        zero = jnp.zeros((Sb, 1), p_sorted.dtype)
        cu0 = jnp.concatenate([zero, jnp.cumsum(pu, axis=1)], axis=1)
        cl0 = jnp.concatenate([zero, jnp.cumsum(plr, axis=1)], axis=1)
        # g[ap, a] = partial MI of interval [ap..a] (upper triangle)
        pp = cu0[:, None, 1:] - cu0[:, :-1, None]   # (S, ap, a)
        pm = cl0[:, None, 1:] - cl0[:, :-1, None]
        tot = pp + pm
        safe = jnp.where(tot > 0, tot, 1.0)
        g = _xlog2y(pp, 2.0 * pp / safe) + _xlog2y(pm, 2.0 * pm / safe)
        tri = jnp.arange(H)[None, :, None] <= jnp.arange(H)[None, None, :]
        g = jnp.where(tri, g, 0.0)

        NEG = jnp.float32(-3.0e38)
        span = (M - K) // 2
        col = jnp.arange(H)[None, :]
        Scol = jnp.where(col <= span, g[:, 0, :], NEG)
        h_cols = [None]
        for zz in range(1, Kh):
            cand = Scol[:, :-1, None] + g[:, 1:, :]       # rows = ap-1
            ap = jnp.arange(1, H)[None, :, None]
            valid = (ap >= zz) & (ap <= col[:, None, :])
            cand = jnp.where(valid, cand, NEG)
            best_ap = jnp.argmax(cand, axis=1) + 1        # first/lowest wins
            best_val = jnp.max(cand, axis=1)
            sel = (col >= zz) & (col <= zz + span)
            Scol = jnp.where(sel, best_val, NEG)
            h_cols.append(best_ap.astype(jnp.int32))

        astar = [None] * (Kh + 1)
        astar[Kh] = jnp.full((Sb,), H, jnp.int32)
        for kk in range(Kh - 1, 0, -1):
            astar[kk] = jnp.take_along_axis(
                h_cols[kk], astar[kk + 1][:, None] - 1, axis=1)[:, 0]
        astar[0] = jnp.zeros((Sb,), jnp.int32)
        return jnp.stack(astar, axis=1)  # (S, Kh+1)

    @staticmethod
    def _interval_sums(masses, astar):
        """Per-interval sums: masses (S, H), astar (S, Kh+1) -> (S, Kh)."""
        zero = jnp.zeros_like(masses[:, :1])
        c0 = jnp.concatenate([zero, jnp.cumsum(masses, axis=1)], axis=1)
        hi = jnp.take_along_axis(c0, astar[:, 1:], axis=1)
        lo = jnp.take_along_axis(c0, astar[:, :-1], axis=1)
        return hi - lo

    def _quantize(self, p, K):
        """Batched quant_mi_sym (output pmf only): (S, M) -> (S, K).
        Same math as _quantize_q; XLA dead-code-eliminates the unused Q."""
        return self._quantize_q(p, K)[0]

    @staticmethod
    def _labels_from_boundaries(astar, H, K):
        """Sorted-position labels: (S, Kh+1) boundaries -> (S, 2H) labels."""
        Kh = K // 2
        pos = jnp.arange(H)[None, :]
        iv = (pos[:, None, :] >= astar[:, 1:Kh, None]).sum(axis=1)  # (S, H)
        return jnp.concatenate([(Kh - 1 - iv)[:, ::-1], Kh + iv], axis=1)

    def _quantize_q(self, p, K):
        """Batched quant_mi_sym returning (p_out, Q): Q is the label-domain
        map (S, M) with values 0..K-1, symmetric like the host's Q_out —
        what LUT reuse re-applies to later-iteration pmfs."""
        logp = jnp.log(jnp.maximum(p, _LOG_FLOOR))
        llr = logp - logp[:, ::-1]
        idx = jnp.argsort(llr, axis=1, stable=True)
        ps = jnp.take_along_axis(p, idx, axis=1)
        astar = self._design(ps, K)
        H = p.shape[1] // 2
        up = self._interval_sums(ps[:, H:], astar)
        lo = self._interval_sums(ps[:, :H][:, ::-1], astar)
        p_out = jnp.concatenate([lo[:, ::-1], up], axis=1)
        labels = self._labels_from_boundaries(astar, H, K)
        inv = jnp.argsort(idx, axis=1)
        Q = jnp.take_along_axis(labels, inv, axis=1).astype(jnp.int32)
        return p_out, Q

    @staticmethod
    def _apply_q(p, Q, K):
        """Re-apply a stored label map: p_out[k] = sum_m p[m]*[Q[m]=k]."""
        onehot = (Q[:, :, None] == jnp.arange(K)[None, None, :])
        return jnp.sum(jnp.where(onehot, p[:, :, None], 0.0), axis=1)

    # -- shared per-iteration math ---------------------------------------
    def _core(self):
        K = self.Nq_Msg
        ens = self.ens
        order_c = np.argsort(ens.degree_rho)
        dc_vec = [int(d) for d in ens.degree_rho[order_c]]
        rho = [float(x) for x in ens.rho[order_c]]

        def min_comb(a, b):
            # min of two magnitudes: c[k] = a[k]*P(B>=k) + b[k]*P(A>k)
            b_suf = jnp.cumsum(b[:, ::-1], axis=1)[:, ::-1]
            a_suf = jnp.cumsum(a[:, ::-1], axis=1)[:, ::-1]
            a_strict = jnp.concatenate([a_suf[:, 1:], jnp.zeros_like(a[:, :1])], axis=1)
            return a * b_suf + b * a_strict

        def chk_update(v2c):
            # incremental min-LUT CN DE over ascending degrees
            n = v2c.shape[1] // 2
            a_p = v2c[:, n:] + v2c[:, :n][:, ::-1]
            a_m = v2c[:, n:] - v2c[:, :n][:, ::-1]
            c_p, c_m = a_p, a_m
            out = jnp.zeros_like(v2c)
            dc_tmp = 2
            for dc, wgt in zip(dc_vec, rho):
                for _ in range(dc - dc_tmp):
                    c_p = min_comb(a_p, c_p)
                    c_m = min_comb(a_m, c_m)
                dc_tmp = max(dc_tmp, dc)
                pmf = jnp.concatenate(
                    [(0.5 * (c_p - c_m))[:, ::-1], 0.5 * (c_p + c_m)], axis=1)
                out = out + wgt * pmf
            return out

        def join(pa, pb):
            # mixed-radix product, input 0 least significant (common.cpp:30)
            return (pb[:, :, None] * pa[:, None, :]).reshape(pa.shape[0], -1)

        def pe_of(v2c):
            return jnp.sum(v2c[:, : v2c.shape[1] // 2], axis=1)

        return chk_update, join, pe_of

    # -- evolve program ---------------------------------------------------
    def _build_evolve(self):
        Pe_max = self.Pe_max
        max_ni = self.max_ni_de_iters
        maxiter = self.maxiter_de
        schedules = self._schedules
        strategy = self.strategy
        lam = [float(x) for x in self.ens.lam]
        chk_update, join, pe_of = self._core()
        nqv = self.Nq_Msg_vec

        def run_tree(sched, msg, cha, K_in):
            """Post-order evaluation: each internal node's product pmf is
            MI-quantized to the INCOMING resolution before feeding its
            parent (host: set_resolution(nq[ii], nq[ii+1], _),
            de.py:265).  Returns the ROOT's product pmf (its quantization
            is the strategy's job)."""
            outs = []
            for i, (a, b) in enumerate(sched):
                if b is None:  # degree-1 VN: root over the channel leaf
                    outs.append(cha if a == "cha" else msg)
                    continue
                pa = msg if a == "msg" else cha if a == "cha" else outs[a]
                pb = msg if b == "msg" else cha if b == "cha" else outs[b]
                prod = join(pa, pb)
                if i == len(sched) - 1:
                    return prod
                q = self._quantize(prod, K_in)
                outs.append(q / jnp.sum(q, axis=1, keepdims=True))
            return outs[-1]  # degree-1 pass-through root

        def joint_nodes(prods, node_w, K):
            """de.level_lut_tree_update as batched tensor math: concatenate
            the weighted half-pmfs of all nodes symmetrically, one DP at
            resolution K, per-origin interval sums rebuild each node's
            output pmf (normalized).  Returns one (S, K) pmf per node."""
            low_w, low_u, up_w, up_u, org = [], [], [], [], []
            for ll, prm in enumerate(prods):
                M2 = prm.shape[1] // 2
                w = node_w[ll]
                low_w.append(w * prm[:, :M2])
                low_u.append(prm[:, :M2])
                up_w.append(w * prm[:, M2:])
                up_u.append(prm[:, M2:])
                org.append(np.full(M2, ll, np.int32))
            overall = jnp.concatenate(
                low_w + [u for u in reversed(up_w)], axis=1)
            unweighted = jnp.concatenate(
                low_u + [u for u in reversed(up_u)], axis=1)
            origin = np.concatenate(org + [o for o in reversed(org)])
            overall = overall / jnp.sum(overall, axis=1, keepdims=True)

            logp = jnp.log(jnp.maximum(overall, _LOG_FLOOR))
            llr = logp - logp[:, ::-1]
            idx = jnp.argsort(llr, axis=1, stable=True)
            ow = jnp.take_along_axis(overall, idx, axis=1)
            ou = jnp.take_along_axis(unweighted, idx, axis=1)
            oo = jnp.broadcast_to(jnp.asarray(origin)[None, :], idx.shape)
            oo = jnp.take_along_axis(oo, idx, axis=1)

            astar = self._design(ow, K)
            Ht = ow.shape[1] // 2
            outs = []
            for ll in range(len(prods)):
                m_up = jnp.where(oo[:, Ht:] == ll, ou[:, Ht:], 0.0)
                m_lo = jnp.where(oo[:, :Ht][:, ::-1] == ll,
                                 ou[:, :Ht][:, ::-1], 0.0)
                up = self._interval_sums(m_up, astar)
                lo = self._interval_sums(m_lo, astar)
                q = jnp.concatenate([lo[:, ::-1], up], axis=1)
                outs.append(q / jnp.sum(q, axis=1, keepdims=True))
            return outs

        def mix_individual(root_prods, weights, K_out):
            out = 0.0
            for wgt, prod in zip(weights, root_prods):
                if prod.shape[1] != K_out:
                    prod = self._quantize(prod, K_out)
                q = prod / jnp.sum(prod, axis=1, keepdims=True)
                out = out + wgt * q
            return out

        def joint_level_update(scheds, levels, leaves, weights, joinf,
                               leaf_of, K_in, K_out):
            """One shared quantizer per tree LEVEL across degrees
            (de.joint_level_irr_lut_design): bottom-up over levels, each
            level's node product pmfs run ONE DP with host weighting
            (per-tree leaf fractions x degree mass)."""
            outs = [dict() for _ in scheds]

            def resolve(t, src):
                return leaf_of(src) if isinstance(src, str) else outs[t][src]

            maxlev = max((max(lv) if lv else 0) for lv in levels)
            for lev in range(maxlev, -1, -1):
                group, prods, ws = [], [], []
                for t, (sched, lvs, lfs) in enumerate(
                        zip(scheds, levels, leaves)):
                    idxs = [i for i in range(len(sched))
                            if lvs[i] == lev and sched[i][1] is not None]
                    tot = float(sum(lfs[i] for i in idxs)) or 1.0
                    for i in idxs:
                        a, b = sched[i]
                        prods.append(joinf(resolve(t, a), resolve(t, b)))
                        ws.append(weights[t] * lfs[i] / tot)
                        group.append((t, i))
                if not group:
                    continue
                qs = joint_nodes(prods, ws, K_out if lev == 0 else K_in)
                for (t, i), q in zip(group, qs):
                    outs[t][i] = q
            out = 0.0
            for t, sched in enumerate(scheds):
                ri = len(sched) - 1
                if sched[ri][1] is None:  # pass-through (degree-1)
                    q = resolve(t, sched[ri][0])
                    if q.shape[1] != K_out:
                        q = self._quantize(q, K_out)
                        q = q / jnp.sum(q, axis=1, keepdims=True)
                else:
                    q = outs[t][ri]
                out = out + weights[t] * q
            return out

        def var_update(c2v, cha, K_in, K_out):
            if strategy == JOINT_LEVEL and len(schedules) > 1:
                return joint_level_update(
                    schedules, self._sched_levels, self._sched_leaves, lam,
                    join, lambda s: c2v if s == "msg" else cha, K_in, K_out)
            root_prods = [run_tree(s, c2v, cha, K_in) for s in schedules]
            if strategy == INDIVIDUAL or len(schedules) == 1:
                return mix_individual(root_prods, lam, K_out)
            return mix_individual(
                joint_nodes(root_prods, lam, K_out), lam, K_out)

        # full-LUT CN: trees of parity/magnitude folds (get_chk_product_pmf,
        # common.cpp:41-70) with MI quantization per node
        chk_schedules = self._chk_schedules
        if chk_schedules is not None:
            from ..ops.pmf import signed_to_unsigned_map

            rho = [float(x) for x in self.ens.rho]
            fold_maps = {}

            def chk_join(pa, pb):
                Ka, Kb = pa.shape[1], pb.shape[1]
                if (Ka, Kb) not in fold_maps:
                    # cache the NUMPY map (a jnp constant would leak the
                    # tracer across separately-traced programs)
                    fold_maps[(Ka, Kb)] = signed_to_unsigned_map(
                        np.array([Ka, Kb]))
                fold = jnp.asarray(fold_maps[(Ka, Kb)])
                Sb = pa.shape[0]
                p0 = (pb[:, :, None] * pa[:, None, :]).reshape(Sb, -1)
                p1 = (pb[:, ::-1][:, :, None]
                      * pa[:, ::-1][:, None, :]).reshape(Sb, -1)
                prod0 = 0.5 * (p0 + p1)
                out = jnp.zeros((Sb, 2 * (Ka // 2) * (Kb // 2)), prod0.dtype)
                return out.at[:, fold].add(prod0)

            def chk_run_tree(sched, msg, K_in):
                outs = []
                for i, (a, b) in enumerate(sched):
                    pa = msg if a == "msg" else outs[a]
                    pb = msg if b == "msg" else outs[b]
                    prod = chk_join(pa, pb)
                    if i == len(sched) - 1:
                        return prod
                    q = self._quantize(prod, K_in)
                    outs.append(q / jnp.sum(q, axis=1, keepdims=True))
                raise AssertionError("empty chk schedule")

            def chk_update_full(v2c, K_in):
                # host CN resolution per iteration: set_resolution(nq[ii],
                # nq[ii], _) (de.py:222) — in and out both K_in
                if strategy == JOINT_LEVEL and len(chk_schedules) > 1:
                    return joint_level_update(
                        chk_schedules, self._chk_levels, self._chk_leaves,
                        rho, chk_join, lambda s: v2c, K_in, K_in)
                root_prods = [chk_run_tree(s, v2c, K_in)
                              for s in chk_schedules]
                if strategy == INDIVIDUAL or len(chk_schedules) == 1:
                    return mix_individual(root_prods, rho, K_in)
                return mix_individual(
                    joint_nodes(root_prods, rho, K_in), rho, K_in)

            chk_of = chk_update_full
        else:
            chk_of = lambda v2c, K_in: chk_update(v2c)

        def step(v2c, cha, K_in, K_out):
            c2v = chk_of(v2c, K_in)
            return var_update(c2v, cha, K_in, K_out)

        if self.uniform_nq:
            K = self.Nq_Msg

            def evolve(v2c0, cha):
                Sb = v2c0.shape[0]

                def cond(carry):
                    it, _, done, _, _ = carry
                    return (it < maxiter) & ~done.all()

                def body(carry):
                    it, v2c, done, Pe_old, ni = carry
                    v2c_new = step(v2c, cha, K, K)
                    Pe = pe_of(v2c_new)
                    conv = Pe < Pe_max
                    # host counts only STRICTLY worse iterations (de.py:
                    # Pe <= Pe_old is improving); de_bp's host differs
                    worse = Pe > Pe_old
                    ni = jnp.where(~done & worse, ni + 1, ni)
                    fail = ni >= max_ni
                    done_new = done | conv | fail
                    v2c = jnp.where(done[:, None], v2c, v2c_new)
                    Pe_old = jnp.where(done | worse, Pe_old, Pe)
                    return it + 1, v2c, done_new, Pe_old, ni

                done0 = jnp.zeros((Sb,), bool)
                Pe0 = jnp.ones((Sb,), jnp.float32)
                ni0 = jnp.zeros((Sb,), jnp.int32)
                it, v2c, done, _, ni = jax.lax.while_loop(
                    cond, body, (0, v2c0, done0, Pe0, ni0))
                Pe = pe_of(v2c)
                # it broadcast per-point so every output shards over the
                # grid axis (mesh path)
                return (Pe < Pe_max, Pe,
                        jnp.broadcast_to(it, Pe.shape).astype(jnp.int32))

            return evolve

        # -- segmented evolve: non-uniform per-iteration resolutions ------
        # nqv[ii] is the width of v2c ENTERING iteration ii; runs of equal
        # consecutive widths execute as one while_loop, the boundary
        # iteration (output width nqv[ii+1] != nqv[ii]) as a single traced
        # step.  Converged/failed points latch Pe instead of freezing the
        # (width-changing) pmf carry — decision-identical.
        runs = []
        s0 = 0
        for ii in range(1, maxiter + 1):
            if ii == maxiter or nqv[ii] != nqv[s0]:
                runs.append((s0, ii, int(nqv[s0])))
                s0 = ii

        def evolve(v2c0, cha):
            Sb = v2c0.shape[0]
            done = jnp.zeros((Sb,), bool)
            conv_l = jnp.zeros((Sb,), bool)
            Pe_l = jnp.full((Sb,), jnp.inf, jnp.float32)
            Pe_old = jnp.ones((Sb,), jnp.float32)
            ni = jnp.zeros((Sb,), jnp.int32)
            it_l = jnp.full((Sb,), maxiter, jnp.int32)
            v2c = v2c0

            def account(state, v2c_new, it):
                done, conv_l, Pe_l, Pe_old, ni, it_l = state
                Pe = pe_of(v2c_new)
                conv = Pe < Pe_max
                worse = Pe > Pe_old
                ni = jnp.where(~done & worse, ni + 1, ni)
                fail = ni >= max_ni
                newly = ~done & (conv | fail)
                conv_l = jnp.where(newly & conv, True, conv_l)
                Pe_l = jnp.where(newly, Pe, Pe_l)
                it_l = jnp.where(newly, it + 1, it_l)
                done = done | conv | fail
                Pe_old = jnp.where(done | worse, Pe_old, Pe)
                return (done, conv_l, Pe_l, Pe_old, ni, it_l), Pe

            for (lo_it, hi_it, K_in) in runs:
                K_next = int(nqv[hi_it]) if hi_it < maxiter else K_in
                n_inner = (hi_it - lo_it) if K_next == K_in else (
                    hi_it - lo_it - 1)
                if n_inner > 0:
                    def cond(carry):
                        it = carry[0]
                        return (it < lo_it + n_inner) & ~carry[1][0].all()

                    def body(carry):
                        it, state, v2c = carry
                        v2c_new = step(v2c, cha, K_in, K_in)
                        state, _ = account(state, v2c_new, it)
                        # no freeze: converged points latch Pe/it above
                        # and the free-running pmf is never read again
                        return it + 1, state, v2c_new

                    _, state, v2c = jax.lax.while_loop(
                        cond, body,
                        (lo_it, (done, conv_l, Pe_l, Pe_old, ni, it_l),
                         v2c))
                    done, conv_l, Pe_l, Pe_old, ni, it_l = state
                if K_next != K_in:
                    # boundary iteration: output width changes
                    v2c_new = step(v2c, cha, K_in, K_next)
                    state, _ = account(
                        (done, conv_l, Pe_l, Pe_old, ni, it_l), v2c_new,
                        hi_it - 1)
                    done, conv_l, Pe_l, Pe_old, ni, it_l = state
                    v2c = v2c_new

            Pe_fin = jnp.where(done, Pe_l, pe_of(v2c))
            ach = jnp.where(done, conv_l, Pe_fin < Pe_max)
            return ach, Pe_fin, it_l  # per-point (shardable over the grid)

        return evolve

    # -- reuse-aware evolve (design-space tool for reuse_vec_opt) ---------
    def _build_evolve_reuse(self, pmax: float):
        """One program evaluating a batch of LUT-reuse vectors at one noise
        level.  Each node's label-domain Q map is carried in the loop; a
        reuse iteration re-applies the stored maps instead of designing
        (de.DELut._var_update_irr's reuse branch, LDPC_DE.cpp:494-515).
        Returns (final Pe, first iteration with Pe < pmax or maxiter)."""
        K = self.Nq_Msg
        max_ni = self.max_ni_de_iters
        maxiter = self.maxiter_de
        schedules = self._schedules
        strategy = self.strategy
        lam = [float(x) for x in self.ens.lam]
        chk_update, join, pe_of = self._core()

        # static slot registry: every op (incl. roots) carries a label map
        # over its PRODUCT alphabet — K per msg/interior operand, Nq_Cha per
        # channel leaf (they differ when qbits_channel != qbits_message)
        Nq_Cha = self.Nq_Cha

        def src_size(src):
            return Nq_Cha if src == "cha" else K  # interior outputs are K

        slot_sizes = [
            (src_size(a) if b is None else src_size(a) * src_size(b))
            for s in schedules for (a, b) in s
        ]

        def run_tree_q(sched, msg, cha, reuse_f, Qs, qpos):
            """Evaluate one tree; design or re-apply per reuse_f.  Returns
            (root product, root Q slot index, updated Qs, next qpos)."""
            outs = []
            root_prod, root_slot = None, None
            for i, (a, b) in enumerate(sched):
                if b is None:  # degree-1 root over the channel leaf
                    outs.append(cha if a == "cha" else msg)
                    root_prod, root_slot = outs[-1], qpos
                    qpos += 1
                    continue
                pa = msg if a == "msg" else cha if a == "cha" else outs[a]
                pb = msg if b == "msg" else cha if b == "cha" else outs[b]
                prod = join(pa, pb)
                if i == len(sched) - 1:
                    root_prod, root_slot = prod, qpos
                    qpos += 1
                    continue
                q_new, Q_new = self._quantize_q(prod, K)
                q_old = self._apply_q(prod, Qs[qpos], K)
                q = jnp.where(reuse_f[:, None], q_old, q_new)
                Qs[qpos] = jnp.where(reuse_f[:, None], Qs[qpos], Q_new)
                outs.append(q / jnp.sum(q, axis=1, keepdims=True))
                qpos += 1
            return root_prod, root_slot, Qs, qpos

        def joint_root_q(root_prods):
            """level_lut_tree_update emitting per-node label maps."""
            halves = [p.shape[1] // 2 for p in root_prods]
            low_w, low_u, up_w, up_u, org = [], [], [], [], []
            for ll, (p, M2) in enumerate(zip(root_prods, halves)):
                w = lam[ll]
                low_w.append(w * p[:, :M2])
                low_u.append(p[:, :M2])
                up_w.append(w * p[:, M2:])
                up_u.append(p[:, M2:])
                org.append(np.full(M2, ll, np.int32))
            overall = jnp.concatenate(low_w + list(reversed(up_w)), axis=1)
            unweighted = jnp.concatenate(low_u + list(reversed(up_u)), axis=1)
            origin = np.concatenate(org + list(reversed(org)))
            overall = overall / jnp.sum(overall, axis=1, keepdims=True)

            logp = jnp.log(jnp.maximum(overall, _LOG_FLOOR))
            llr = logp - logp[:, ::-1]
            idx = jnp.argsort(llr, axis=1, stable=True)
            ow = jnp.take_along_axis(overall, idx, axis=1)
            ou = jnp.take_along_axis(unweighted, idx, axis=1)
            oo = jnp.broadcast_to(jnp.asarray(origin)[None, :], idx.shape)
            oo = jnp.take_along_axis(oo, idx, axis=1)
            astar = self._design(ow, K)
            Ht = ow.shape[1] // 2
            labels = self._labels_from_boundaries(astar, Ht, K)
            inv = jnp.argsort(idx, axis=1)
            Q_overall = jnp.take_along_axis(labels, inv, axis=1).astype(jnp.int32)

            qs, Q_nodes = [], []
            Mtot = 2 * Ht
            I = 0
            for ll, M2 in enumerate(halves):
                m_up = jnp.where(oo[:, Ht:] == ll, ou[:, Ht:], 0.0)
                m_lo = jnp.where(oo[:, :Ht][:, ::-1] == ll,
                                 ou[:, :Ht][:, ::-1], 0.0)
                up = self._interval_sums(m_up, astar)
                lo = self._interval_sums(m_lo, astar)
                q = jnp.concatenate([lo[:, ::-1], up], axis=1)
                qs.append(q / jnp.sum(q, axis=1, keepdims=True))
                Q_nodes.append(jnp.concatenate(
                    [Q_overall[:, I:I + M2],
                     Q_overall[:, Mtot - I - M2:Mtot - I]], axis=1))
                I += M2
            return qs, Q_nodes

        def evolve(v2c0, cha, reuse_mat):
            C = reuse_mat.shape[0]

            def cond(carry):
                it, *_ = carry
                return (carry[0] < maxiter) & ~carry[3].all()

            def body(carry):
                it, v2c, Qs, done, Pe_old, ni, it_hit = carry
                reuse_f = reuse_mat[:, it]
                c2v = chk_update(v2c)
                root_prods, root_slots = [], []
                qpos = 0
                for sched in schedules:
                    prod, slot, Qs, qpos = run_tree_q(
                        sched, c2v, cha, reuse_f, Qs, qpos)
                    root_prods.append(prod)
                    root_slots.append(slot)
                if strategy == INDIVIDUAL or len(schedules) == 1:
                    q_des, Q_des = [], []
                    for prod in root_prods:
                        if prod.shape[1] > K:
                            qd, Qd = self._quantize_q(prod, K)
                        else:  # degree-1 (Nq_Cha == Nq_Msg): sorted-identity
                            qd = prod
                            Qd = jnp.broadcast_to(
                                jnp.arange(K, dtype=jnp.int32)[None], prod.shape)
                        q_des.append(qd)
                        Q_des.append(Qd)
                else:
                    q_des, Q_des = joint_root_q(root_prods)
                v2c_new = 0.0
                for wgt, prod, slot, qd, Qd in zip(
                        lam, root_prods, root_slots, q_des, Q_des):
                    q_old = self._apply_q(prod, Qs[slot], K)
                    q = jnp.where(reuse_f[:, None], q_old, qd)
                    Qs[slot] = jnp.where(reuse_f[:, None], Qs[slot], Qd)
                    q = q / jnp.sum(q, axis=1, keepdims=True)
                    v2c_new = v2c_new + wgt * q
                Pe = pe_of(v2c_new)
                conv = Pe < pmax
                # strictly-worse only, matching the host engine (de.py)
                worse = Pe > Pe_old
                ni = jnp.where(~done & worse, ni + 1, ni)
                fail = ni >= max_ni
                it_hit = jnp.where(conv & ~done & (it_hit == maxiter), it, it_hit)
                done_new = done | conv | fail
                v2c = jnp.where(done[:, None], v2c, v2c_new)
                Pe_old = jnp.where(done | worse, Pe_old, Pe)
                return it + 1, v2c, Qs, done_new, Pe_old, ni, it_hit

            Qs0 = [jnp.zeros((C, sz), jnp.int32) for sz in slot_sizes]
            carry = (0, v2c0, Qs0, jnp.zeros((C,), bool),
                     jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.int32),
                     jnp.full((C,), maxiter, jnp.int32))
            it, v2c, _, done, _, ni, it_hit = jax.lax.while_loop(
                cond, body, carry)
            return pe_of(v2c), it_hit

        return evolve

    def prerank_reuse(self, sig: float, reuse_mat, pmax: float = 1e-17):
        """Evaluate a batch of reuse vectors at noise level sig in one
        program.  Returns (final Pe, first iteration with Pe < pmax or
        maxiter) per row — f32 exploration for reuse_vec_opt's greedy
        search; host f64 confirms the top candidates."""
        if not self.min_lut:
            raise NotImplementedError(
                "reuse pre-ranking covers min-LUT mode only")
        if not self.uniform_nq:
            raise NotImplementedError(
                "reuse pre-ranking needs a uniform message resolution")
        reuse_mat = np.asarray(reuse_mat, dtype=bool)
        if reuse_mat.ndim != 2 or reuse_mat.shape[1] != self.maxiter_de:
            raise ValueError("reuse_mat must be (num_candidates, maxiter_de)")
        if reuse_mat[:, 0].any():
            raise ValueError("reuse not possible for initial iteration")
        key = float(pmax)
        if key not in self._evolve_reuse:
            fn = self._build_evolve_reuse(key)
            if self.mesh is not None:
                from jax import shard_map
                from jax.sharding import PartitionSpec as P

                fn = shard_map(
                    fn, mesh=self.mesh,
                    in_specs=(P("dp"), P("dp"), P("dp")),
                    out_specs=(P("dp"), P("dp")), check_vma=False)
            self._evolve_reuse[key] = jax.jit(fn)
        C = reuse_mat.shape[0]
        pad = self._mesh_pad()
        Cp = -(-C // pad) * pad
        if Cp != C:  # wrap-pad candidate rows to the mesh size
            reuse_mat = np.resize(reuse_mat, (Cp, reuse_mat.shape[1]))
        delta = 2 * self.LLR_max / self.Nq_fine
        fine = get_gaussian_pmf(2 / sig**2, 2 / sig, self.Nq_fine, delta)
        _, p_cha, _ = quant_mi_sym(fine, self.Nq_Cha, is_sorted=True)
        _, p_msg, _ = quant_mi_sym(fine, self.Nq_Msg, is_sorted=True)
        cha = jnp.broadcast_to(jnp.asarray(p_cha, jnp.float32)[None],
                               (Cp, self.Nq_Cha))
        v2c = jnp.broadcast_to(jnp.asarray(p_msg, jnp.float32)[None],
                               (Cp, self.Nq_Msg))
        Pe, it_hit = self._evolve_reuse[key](v2c, cha, jnp.asarray(reuse_mat))
        return np.asarray(Pe)[:C], np.asarray(it_hit)[:C]

    # ------------------------------------------------------------------
    def evolve_batch(self, sigmas) -> tuple[np.ndarray, np.ndarray]:
        """(converged mask, final Pe) per sigma, one jitted program.

        Channel pmfs are quantized on the host in f64 (exactly like
        de.DELut.set_channel_pmf) so only the iteration loop runs in f32.
        """
        sigmas = np.asarray(sigmas, dtype=np.float64)
        S = len(sigmas)
        pad = self._mesh_pad()
        sig_run = np.resize(sigmas, -(-S // pad) * pad)  # wrap-pad to mesh
        delta = 2 * self.LLR_max / self.Nq_fine
        chas, msgs = [], []
        for s in sig_run:
            fine = get_gaussian_pmf(2 / s**2, 2 / s, self.Nq_fine, delta)
            _, p_cha, _ = quant_mi_sym(fine, self.Nq_Cha, is_sorted=True)
            _, p_msg, _ = quant_mi_sym(fine, self.Nq_Msg, is_sorted=True)
            chas.append(p_cha)
            msgs.append(p_msg)
        cha = jnp.asarray(np.stack(chas), jnp.float32)
        v2c = jnp.asarray(np.stack(msgs), jnp.float32)
        ach, Pe, _ = self._evolve(v2c, cha)
        return np.asarray(ach)[:S], np.asarray(Pe)[:S]

    def threshold(self, points: int = 17, rounds: int = 3,
                  refine_host: bool = False) -> float:
        """Coarse-to-fine batched grid search for the noise threshold.

        Each round evaluates `points` sigmas across the bracket in one
        program and narrows to the last-converged / first-diverged pair.
        refine_host finishes with the f64 host engine (requires host=)."""
        lo, hi = self.thr_min, self.thr_max
        for _ in range(rounds):
            grid = np.linspace(lo, hi, points)
            ach, _ = self.evolve_batch(grid)
            if not ach.any():
                hi = grid[1]
                continue
            k = int(np.nonzero(ach)[0].max())
            lo = grid[k]
            if k + 1 < points:
                hi = grid[k + 1]
        if refine_host:
            if self.host is None:
                raise ValueError("threshold(refine_host=True) needs host=DELut(...)")
            self.host.set_bisec_window(lo, hi)
            _, thr = self.host.bisec_search()
            return thr if thr > 0 else lo
        return lo
