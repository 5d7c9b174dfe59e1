"""The designed LUT codec: decoder artifact + design entry point.

Equivalent of LDPC_Code_LUT (/root/reference/src/LDPC_Code_LUT.{hpp,cpp}):
holds the Tanner graph layout, quantizer boundaries, per-iteration LUT trees
with reuse bookkeeping, and the optional systematic generator.  `design`
mirrors design_luts (cpp:699-746); `save`/`load` persist the full artifact
(npz container, trees in the reference's text format so they remain
interchangeable); `decode_ref` is the scalar golden model of lut_decode
(cpp:259-353) used to validate the batched decoders.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from ..core.gf2 import make_systematic_generator
from ..core.tanner import TannerGraph
from ..core.trees import LUTTree, deserialize_tree_array, serialize_tree_array
from ..design.de import DELut
from ..design.templates import get_lut_tree_templates
from ..ops.pmf import get_gaussian_pmf
from ..ops.quant import quant_mi_sym, quant_nonlin

__all__ = ["LUTCodec", "CONT", "QCHA"]

CONT, QCHA = "cont", "qcha"  # initial message modes (LDPC_Code_LUT.hpp:78-84)

CODEC_FILE_VERSION = 1


@dataclass
class LUTCodec:
    graph: TannerGraph
    max_iters: int
    Nq_Cha: int
    Nq_Msg: np.ndarray  # (max_iters,) per-iteration message resolutions
    qb_Cha: np.ndarray  # (Nq_Cha-1,) continuous-LLR channel quantizer boundaries
    qb_Msg: np.ndarray  # (Nq_Msg[0]-1,) initial-message quantizer boundaries
    cha2msg_map: np.ndarray  # (Nq_Cha,) channel-label -> initial-message-label
    reuse_vec: np.ndarray  # (max_iters,) bool
    min_lut: bool
    var_trees: list  # [stored iteration][active degree] LUTTree
    chk_trees: list  # [] when min_lut
    nchk_lin_indep: int = -1
    initial_message_mode: str = CONT
    # systematic generator (column-permuted; None = not built)
    gen_perm: np.ndarray | None = None
    gen_T: np.ndarray | None = None
    # design-time pmf snapshots (enable the arithmetic decoder form):
    # pmf_cha_design: (Nq_Cha,) channel pmf at the design noise level;
    # pmf_chk2var_trace: list of per-iteration chk->var pmfs (len max_iters)
    pmf_cha_design: np.ndarray | None = None
    pmf_chk2var_trace: list | None = None
    # derived
    var_tree_idx_iter: np.ndarray = field(init=False)
    var_tree_degrees: np.ndarray = field(init=False)
    chk_tree_degrees: np.ndarray = field(init=False)

    def __post_init__(self):
        self.Nq_Msg = np.asarray(self.Nq_Msg, dtype=np.int64)
        self.reuse_vec = np.asarray(self.reuse_vec, dtype=bool)
        if len(self.reuse_vec) != self.max_iters:
            raise ValueError("reuse_vec length must equal max_iters")
        if self.reuse_vec[0] or self.reuse_vec[-1]:
            # LDPC_Code_LUT.cpp:122
            raise ValueError("first and last iteration are exempt from tree reuse")
        # iteration -> stored tree row (cumsum(reuse==0)-1, LDPC_Code_LUT.cpp:125)
        self.var_tree_idx_iter = np.cumsum(~self.reuse_vec) - 1
        self.var_tree_degrees = np.array(
            [t.num_leaves for t in self.var_trees[0]], dtype=np.int64
        )
        if self.chk_trees:
            self.chk_tree_degrees = np.array(
                [t.num_leaves + 1 for t in self.chk_trees[0]], dtype=np.int64
            )
        else:
            self.chk_tree_degrees = np.zeros(0, dtype=np.int64)
        # nchk_lin_indep stays -1 until first needed (the GF(2) rank of a
        # DVB-S2-size H takes minutes; PEG-built codes are full rank anyway)

    # ------------------------------------------------------------------
    def _dense_H(self) -> np.ndarray:
        return self.graph.to_dense()

    @property
    def nvar(self) -> int:
        return self.graph.nvar

    @property
    def nchk(self) -> int:
        return self.graph.nchk

    def _ensure_rank(self) -> None:
        if self.nchk_lin_indep < 0:
            from ..core.gf2 import gf2_rank

            if _peel_full_rank(self.graph):
                # O(E) certificate: repeatedly eliminating degree-1 checks
                # exhausts every check, so H contains a column-permuted
                # triangular nchk x nchk submatrix (e.g. the DVB-S2 / IRA
                # accumulator staircase) — full row rank without the
                # minutes-long dense reduction at N=64800
                self.nchk_lin_indep = self.graph.nchk
            elif self.graph.nvar < 1e5:
                self.nchk_lin_indep = gf2_rank(self._dense_H())
            else:
                self.nchk_lin_indep = self.graph.nchk

    @property
    def k(self) -> int:
        """Number of systematic (information) bits."""
        self._ensure_rank()
        return self.graph.nvar - self.nchk_lin_indep

    def rate(self) -> float:
        return self.k / self.graph.nvar

    def var_tree(self, it: int, degree: int) -> LUTTree:
        dd = int(np.nonzero(self.var_tree_degrees == degree)[0][0])
        return self.var_trees[int(self.var_tree_idx_iter[it])][dd]

    def chk_tree(self, it: int, degree: int) -> LUTTree:
        dd = int(np.nonzero(self.chk_tree_degrees == degree)[0][0])
        return self.chk_trees[int(self.var_tree_idx_iter[it])][dd]

    # ------------------------------------------------------------------
    # design (LDPC_Code_LUT.cpp:699-746)
    # ------------------------------------------------------------------
    @classmethod
    def design(
        cls,
        graph: TannerGraph,
        sigma2: float,
        max_iters: int,
        Nq_Cha: int = 16,
        Nq_Msg: int | np.ndarray = 16,
        tree_method: str = "auto_bin_balanced",
        min_lut: bool = True,
        reuse_vec: np.ndarray | None = None,
        irregular_design_strategy: str = "joint_root",
        ens=None,
        build_generator: bool = False,
        generator_cache: str | None = None,
    ) -> "LUTCodec":
        """Run DE at noise power sigma2 and assemble the decoder artifact.

        With build_generator, H's columns are permuted for a systematic
        generator (like IT++ LDPC_Generator_Systematic) and the returned
        codec's graph is the *permuted* one.  generator_cache names an
        npz cached next to the alist (the reference caches `<code>.gen.it`
        the same way, LDPC_BER_Sim.cpp:168-189): loaded when present and
        its H digest matches, written atomically otherwise.
        """
        if np.isscalar(Nq_Msg):
            Nq_Msg = np.full(max_iters, int(Nq_Msg), dtype=np.int64)
        Nq_Msg = np.asarray(Nq_Msg, dtype=np.int64)
        if reuse_vec is None:
            reuse_vec = np.zeros(max_iters, dtype=bool)
        if getattr(graph, "qc_phantoms", ()) and not min_lut:
            # pinned-phantom exactness relies on the min-sum CN update
            # being neutral to a max-magnitude positive input; CN LUT
            # trees are not (and the completed check degree differs)
            raise ValueError("phantom-completed graphs require min_lut")
        if ens is None:
            ens = graph.empirical_ensemble()  # TRUE-matrix degrees

        gen_perm = gen_T = None
        nchk_lin_indep = -1
        if build_generator and getattr(graph, "qc_phantoms", ()):
            # the systematic column permutation would discard the QC
            # structure the phantom graph exists for; encoded-codeword
            # sims should run the unpermuted realization instead
            raise ValueError("phantom-completed graphs support "
                             "zero-codeword simulation only")
        if build_generator:
            from ..core.gf2 import make_systematic_generator_cached

            H = graph.to_dense()
            perm, gen_T, rank = make_systematic_generator_cached(
                H, generator_cache)
            graph = TannerGraph.from_dense(H[:, perm])
            gen_perm = perm
            nchk_lin_indep = rank

        var_templates, chk_templates = get_lut_tree_templates(
            tree_method, ens, Nq_Msg, Nq_Cha, min_lut
        )
        de = DELut(
            ens,
            Nq_Cha,
            Nq_Msg,
            max_iters,
            var_templates,
            chk_templates if not min_lut else None,
            reuse_vec=reuse_vec,
            irregular_design_strategy=irregular_design_strategy,
        )
        sig = float(np.sqrt(sigma2))
        qb_Cha, qb_Msg = de.get_quant_bound(sig)
        var_trees, chk_trees = de.get_lut_trees(sig)
        pmf_cha_design = de.pmf_cha.copy()
        pmf_chk2var_trace = [p.copy() for p in de.pmf_chk2var_trace]

        # channel-label -> initial-message-label map (LDPC_Code_LUT.cpp:735-741)
        LLR_max = 25.0
        delta = 2 * LLR_max / Nq_Cha
        pmf_channel = get_gaussian_pmf(2 / sigma2, 2 / sig, Nq_Cha, delta)
        _, _, cha2msg_map = quant_mi_sym(pmf_channel, int(Nq_Msg[0]), is_sorted=True)

        return cls(
            graph=graph,
            max_iters=max_iters,
            Nq_Cha=Nq_Cha,
            Nq_Msg=Nq_Msg,
            qb_Cha=qb_Cha,
            qb_Msg=qb_Msg,
            cha2msg_map=cha2msg_map,
            reuse_vec=reuse_vec,
            min_lut=min_lut,
            var_trees=var_trees,
            chk_trees=chk_trees,
            nchk_lin_indep=nchk_lin_indep,
            gen_perm=gen_perm,
            gen_T=gen_T,
            pmf_cha_design=pmf_cha_design,
            pmf_chk2var_trace=pmf_chk2var_trace,
        )

    # ------------------------------------------------------------------
    # encode / quantize
    # ------------------------------------------------------------------
    def encode(self, u: np.ndarray) -> np.ndarray:
        """Systematic encode: x = [u, parity] of the (permuted) H."""
        if self.gen_T is None:
            raise ValueError("encode: no generator built")
        u = np.asarray(u, dtype=np.uint8)
        parity = (u @ self.gen_T) % 2
        return np.concatenate([u, parity.astype(np.uint8)], axis=-1)

    def quantize_channel(self, llr: np.ndarray):
        """Continuous LLR -> (channel labels, initial message labels)
        (LDPC_Code_LUT.cpp:204-221)."""
        llr_cha = quant_nonlin(llr, self.qb_Cha)
        if self.initial_message_mode == CONT:
            llr_msg = quant_nonlin(llr, self.qb_Msg)
        else:
            llr_msg = self.cha2msg_map[llr_cha]
        return llr_cha, llr_msg

    # ------------------------------------------------------------------
    # scalar golden decoder (LDPC_Code_LUT.cpp:259-353)
    # ------------------------------------------------------------------
    def decode_ref(self, llr_cha: np.ndarray, llr_msg: np.ndarray, psc: bool = True,
                   pisc: bool = False, verbosity: int = 0, out=None):
        """Single-frame scalar decode; returns (hard bits, iterations).

        Positive return = converged at that iteration, negative = failure
        after max_iters (reference return-code convention).  psc = per-
        iteration syndrome check / early exit (LDPC_Code_LUT `psc` flag).

        pisc = syndrome check on the channel hard decisions before any
        iteration (the reference's `pisc` flag, LDPC_Code_LUT.cpp:277-279;
        default off, as in the reference).

        verbosity reproduces the reference's stimuli dumps for the VHDL
        hardware flow (LDPC_Code_LUT.cpp:228-238, 292-337): >0 prints the
        (channel label, hard output) stimuli pair, >1 the VN-to-CN message
        stream per iteration, >2 the CN-to-VN messages; all hex, written to
        `out` (default stdout).
        """
        import sys

        if out is None:
            out = sys.stdout

        def hexline(vals):
            return "  ".join(f"{int(x):08X}" for x in vals) + "  "
        g = self.graph
        llr_cha = np.asarray(llr_cha, dtype=np.int64)
        llr_msg = np.asarray(llr_msg, dtype=np.int64)
        edge_var = g.var_llr_edge_expand()
        msgs = llr_msg[edge_var].copy()

        # per-node edge lists (VN-major layout)
        starts = np.concatenate([[0], np.cumsum(g.dv_vec)])
        vn_edges = [np.arange(starts[v], starts[v + 1]) for v in range(g.nvar)]
        cn_edges = [None] * g.nchk
        cn_vars = [None] * g.nchk
        for d in g.cn_degrees:
            d = int(d)
            for j, c in enumerate(g.cn_node_idx[d]):
                cn_edges[int(c)] = g.cn_edge_idx[d][j]
                cn_vars[int(c)] = g.cn_var_idx[d][j]

        # phantom completion edges (core/qc.py qc_expand): the graph's
        # index arrays carry them, the TRUE matrix does not.  Semantics
        # (the golden definition every batched decoder must reproduce):
        # - a phantom v2c message is pinned to the strongest-positive
        #   label at every CN pass, making the completed check's outputs,
        #   sign parity, and syndrome EXACTLY those of the true check
        #   (min-sum is neutral to a max-magnitude positive input);
        # - a variable with phantom sockets updates with its TRUE-degree
        #   trees over its real sockets; its phantom sockets mirror the
        #   first real output so the unanimity sweep needs no masking;
        # - the bit-level syndrome ignores phantom (var, check) pairs.
        ph = g.phantoms
        ph_edges = np.array(sorted(p["edge"] for p in ph), dtype=np.int64)
        ph_nodes = {}
        for p in ph:
            ph_nodes.setdefault(p["var"], []).append(p["edge"])
        ph_true_d = {v: len(vn_edges[v]) - len(es)
                     for v, es in ph_nodes.items()}
        ph_pairs = {(p["chk"], p["var"]) for p in ph}
        cn_vars_true = list(cn_vars)
        for c, v in ph_pairs:
            cn_vars_true[c] = np.array(
                [x for x in cn_vars[c] if x != v], dtype=cn_vars[c].dtype)

        def syndrome_ok(b):
            for c in range(g.nchk):
                if int(b[cn_vars_true[c]].sum()) % 2:
                    return False
            return True

        def unanimity(nz):
            b = np.zeros(g.nvar, dtype=np.uint8)
            for v in range(g.nvar):
                neg = msgs[vn_edges[v]] < nz
                if not (neg.all() or (~neg).all()):
                    return None
                b[v] = 1 if neg[0] else 0
            return b if syndrome_ok(b) else None

        if pisc:
            b0 = (llr_cha < self.Nq_Cha // 2).astype(np.uint8)
            if syndrome_ok(b0):
                return b0, 0

        if verbosity > 1:
            out.write("Initial VN-to-CN messages: \n" + hexline(msgs) + "\n")

        for ii in range(self.max_iters):
            nz = int(self.Nq_Msg[ii]) // 2
            # CN pass
            if ph_edges.size:
                msgs[ph_edges] = 2 * nz - 1  # pin: strongest positive
            for c in range(g.nchk):
                e = cn_edges[c]
                if self.min_lut:
                    msgs[e] = _chk_minsum_scalar(msgs[e], nz)
                else:
                    tree = self.chk_tree(ii, len(e))
                    msgs[e] = tree.chk_msg_update(list(int(x) for x in msgs[e]))
            if verbosity > 2:
                out.write(
                    f"CN-to-VN messages after CN update at iteration {ii}:\n"
                    + hexline(msgs) + "\n"
                )
            # VN pass (skipped on last iteration)
            if ii != self.max_iters - 1:
                for v in range(g.nvar):
                    e = vn_edges[v]
                    if v in ph_nodes:
                        er = [x for x in e if x not in ph_nodes[v]]
                        tree = self.var_tree(ii, ph_true_d[v])
                        out = tree.var_msg_update(
                            [int(msgs[x]) for x in er], int(llr_cha[v]))
                        msgs[er] = out
                        msgs[ph_nodes[v]] = out[0]  # mirror for unanimity
                        continue
                    tree = self.var_tree(ii, len(e))
                    msgs[e] = tree.var_msg_update(
                        [int(x) for x in msgs[e]], int(llr_cha[v])
                    )
                if psc:
                    b = unanimity(int(self.Nq_Msg[ii + 1]) // 2)
                    if b is not None:
                        if verbosity > 0:
                            self._print_stimuli(llr_cha, b, out)
                        return b, ii + 1
                if verbosity > 1:
                    out.write(
                        f"VN-to-CN messages after VN update at iteration {ii}:\n"
                        + hexline(msgs) + "\n"
                    )
        # decision pass
        b = np.zeros(g.nvar, dtype=np.uint8)
        for v in range(g.nvar):
            e = vn_edges[v]
            if v in ph_nodes:
                er = [x for x in e if x not in ph_nodes[v]]
                tree = self.var_tree(self.max_iters - 1, ph_true_d[v])
                o = tree.dec_update([int(msgs[x]) for x in er],
                                    int(llr_cha[v]))
            else:
                tree = self.var_tree(self.max_iters - 1, len(e))
                o = tree.dec_update([int(x) for x in msgs[e]], int(llr_cha[v]))
            b[v] = 1 if o < 1 else 0
        if verbosity > 0:
            self._print_stimuli(llr_cha, b, out)
        return b, (self.max_iters if syndrome_ok(b) else -self.max_iters)

    def _print_stimuli(self, llr_cha, bits, out) -> None:
        """The stimuli pair consumed by the VHDL testbench flow
        (LDPC_Code_LUT.cpp:228-238, QUICKSTART.md:44)."""
        out.write(
            "Stimuli Pair (Quantized channel LLR decoder inputs in hex format "
            "and decoder output in binary format): \n"
        )
        out.write("  ".join(f"{int(x):08X}" for x in llr_cha) + "  \n")
        out.write("  ".join(str(int(x)) for x in bits) + "  \n\n")

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        g = self.graph
        H = self._dense_H()
        col_lists = [np.nonzero(H[:, v])[0].astype(np.int32) for v in range(g.nvar)]
        cols_flat = np.concatenate(col_lists) if col_lists else np.zeros(0, np.int32)
        arrays = dict(
            file_version=np.int64(CODEC_FILE_VERSION),
            nvar=np.int64(g.nvar),
            nchk=np.int64(g.nchk),
            nchk_lin_indep=np.int64(self.nchk_lin_indep),
            dv_vec=g.dv_vec.astype(np.int32),
            cols_flat=cols_flat,
            max_iters=np.int64(self.max_iters),
            Nq_Cha=np.int64(self.Nq_Cha),
            Nq_Msg=self.Nq_Msg,
            qb_Cha=self.qb_Cha,
            qb_Msg=self.qb_Msg,
            cha2msg_map=self.cha2msg_map,
            reuse_vec=self.reuse_vec,
            min_lut=np.bool_(self.min_lut),
            initial_message_mode=np.str_(self.initial_message_mode),
            var_tree_string=np.str_(serialize_tree_array(self.var_trees)),
            chk_tree_string=np.str_(serialize_tree_array(self.chk_trees)),
        )
        if self.gen_perm is not None:
            arrays["gen_perm"] = self.gen_perm.astype(np.int64)
            arrays["gen_T"] = self.gen_T.astype(np.uint8)
        qc = getattr(g, "qc", None)
        if qc is not None:
            # persist the quasi-cyclic structure so a reloaded codec keeps
            # the SAME graph realization (slot order = leaf assignment)
            # and decodes identically; phantom completions ride
            # along (cols_flat/to_dense stay the TRUE matrix)
            arrays["qc_Z"] = np.int64(qc.Z)
            arrays["qc_base"] = np.asarray(qc.base, np.int64)
            if qc.base2 is not None:
                arrays["qc_base2"] = np.asarray(qc.base2, np.int64)
            if qc.phantoms:
                arrays["qc_phantoms"] = np.asarray(qc.phantoms, np.int64)
        if self.pmf_cha_design is not None:
            arrays["pmf_cha_design"] = self.pmf_cha_design
        if self.pmf_chk2var_trace is not None:
            # ragged when Nq_Msg varies; store flat + lengths
            arrays["pmf_trace_flat"] = np.concatenate(self.pmf_chk2var_trace)
            arrays["pmf_trace_len"] = np.array(
                [len(p) for p in self.pmf_chk2var_trace], dtype=np.int64
            )
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "LUTCodec":
        z = np.load(path, allow_pickle=False)
        ver = int(z["file_version"])
        if ver != CODEC_FILE_VERSION:
            raise ValueError(f"unsupported codec file version {ver}")
        nvar = int(z["nvar"])
        nchk = int(z["nchk"])
        dv_vec = z["dv_vec"]
        if "qc_Z" in z.files:
            from ..core.qc import QCStructure, qc_expand

            qc = QCStructure(
                Z=int(z["qc_Z"]), mb=z["qc_base"].shape[0],
                nb=z["qc_base"].shape[1], base=z["qc_base"],
                base2=z["qc_base2"] if "qc_base2" in z.files else None,
                phantoms=tuple(tuple(int(x) for x in row)
                               for row in z["qc_phantoms"])
                if "qc_phantoms" in z.files else (),
            )
            graph = qc_expand(qc)  # identical realization
            if graph.nvar != nvar or graph.nchk != nchk:
                raise ValueError("codec qc structure inconsistent")
        else:
            cols_flat = z["cols_flat"]
            starts = np.concatenate([[0], np.cumsum(dv_vec)])
            cols = [cols_flat[starts[v] : starts[v + 1]] for v in range(nvar)]
            graph = TannerGraph.from_cols(cols, nvar, nchk)
        var_trees = deserialize_tree_array(io.StringIO(str(z["var_tree_string"])))
        chk_trees = deserialize_tree_array(io.StringIO(str(z["chk_tree_string"])))
        pmf_trace = None
        if "pmf_trace_flat" in z.files:
            flat, lens = z["pmf_trace_flat"], z["pmf_trace_len"]
            offs = np.concatenate([[0], np.cumsum(lens)])
            pmf_trace = [flat[offs[i] : offs[i + 1]] for i in range(len(lens))]
        return cls(
            graph=graph,
            max_iters=int(z["max_iters"]),
            Nq_Cha=int(z["Nq_Cha"]),
            Nq_Msg=z["Nq_Msg"],
            qb_Cha=z["qb_Cha"],
            qb_Msg=z["qb_Msg"],
            cha2msg_map=z["cha2msg_map"],
            reuse_vec=z["reuse_vec"],
            min_lut=bool(z["min_lut"]),
            var_trees=var_trees,
            chk_trees=chk_trees,
            nchk_lin_indep=int(z["nchk_lin_indep"]),
            initial_message_mode=str(z["initial_message_mode"]),
            gen_perm=z["gen_perm"] if "gen_perm" in z.files else None,
            gen_T=z["gen_T"] if "gen_T" in z.files else None,
            pmf_cha_design=z["pmf_cha_design"] if "pmf_cha_design" in z.files else None,
            pmf_chk2var_trace=pmf_trace,
        )

    # -- IT++ .it artifact (reference save_code schema) ---------------------
    def _cn_msg_idx(self) -> np.ndarray:
        """CN-ordered edge -> VN-major edge index (decoder_parameterization,
        LDPC_Code_LUT.cpp:510-527)."""
        g = self.graph
        per_check = [None] * g.nchk
        for d in g.cn_degrees:
            d = int(d)
            for row, c in zip(g.cn_edge_idx[d], g.cn_node_idx[d]):
                per_check[int(c)] = row
        return np.concatenate(per_check).astype(np.int32)

    def _chk_equ_idx(self) -> list:
        g = self.graph
        per_check = [None] * g.nchk
        for d in g.cn_degrees:
            d = int(d)
            for row, c in zip(g.cn_var_idx[d], g.cn_node_idx[d]):
                per_check[int(c)] = np.asarray(row, dtype=np.int32)
        return per_check

    def save_itfile(self, path: str) -> None:
        """Write the reference's binary codec artifact (save_code,
        LDPC_Code_LUT.cpp:568-697; Fileversion 1) — the input of the
        lut_ldpc_vhdl hardware-generation flow.  Generator data is not
        included (G_defined = 0)."""
        from ..utils.itfile import ItBin, itsave

        self._ensure_rank()  # the reference schema stores the true rank

        itsave(path, {
            "Fileversion": 1,
            "H_defined": ItBin(True),
            "G_defined": ItBin(False),
            "LUTs_defined": ItBin(True),
            "nvar": self.graph.nvar,
            "nchk": self.graph.nchk,
            "nchk_lin_indep": self.nchk_lin_indep,
            "dv_vec": self.graph.dv_vec.astype(np.int32),
            "dc_vec": self.graph.dc_vec.astype(np.int32),
            "chk_equ_idx": self._chk_equ_idx(),
            "cn_msg_idx": self._cn_msg_idx(),
            "max_iters": self.max_iters,
            "Nq_Cha": self.Nq_Cha,
            "Nq_Msg": self.Nq_Msg.astype(np.int32),
            "Nq_Cha_2_Nq_Msg_map": self.cha2msg_map.astype(np.int32),
            "qb_Cha": self.qb_Cha.astype(np.float64),
            "qb_Msg": self.qb_Msg.astype(np.float64),
            "reuse_vec": self.reuse_vec.astype(np.uint8),
            "minLUT": ItBin(self.min_lut),
            "output_verbosity": 0,
            "var_tree_string": serialize_tree_array(self.var_trees),
            "chk_tree_string": serialize_tree_array(self.chk_trees),
        })

    @classmethod
    def load_itfile(cls, path: str) -> "LUTCodec":
        """Read a reference-format binary codec artifact (load_code,
        LDPC_Code_LUT.cpp:568-640)."""
        from ..utils.itfile import itload

        z = itload(path)
        if int(z["Fileversion"]) != 1:
            raise ValueError("unsupported codec file version")
        nvar, nchk = int(z["nvar"]), int(z["nchk"])
        cols = [[] for _ in range(nvar)]
        for cc, row in enumerate(z["chk_equ_idx"]):
            for v in row:
                cols[int(v)].append(cc)
        graph = TannerGraph.from_cols(
            [np.asarray(c, dtype=np.int64) for c in cols], nvar, nchk
        )
        var_trees = deserialize_tree_array(str(z["var_tree_string"]))
        chk_trees = deserialize_tree_array(str(z["chk_tree_string"]))
        return cls(
            graph=graph,
            max_iters=int(z["max_iters"]),
            Nq_Cha=int(z["Nq_Cha"]),
            Nq_Msg=np.asarray(z["Nq_Msg"], dtype=np.int64),
            qb_Cha=np.asarray(z["qb_Cha"], dtype=np.float64),
            qb_Msg=np.asarray(z["qb_Msg"], dtype=np.float64),
            cha2msg_map=np.asarray(z["Nq_Cha_2_Nq_Msg_map"], dtype=np.int64),
            reuse_vec=np.asarray(z["reuse_vec"], dtype=bool),
            min_lut=bool(int(z["minLUT"])),
            var_trees=var_trees,
            chk_trees=chk_trees,
            nchk_lin_indep=int(z["nchk_lin_indep"]),
        )

    def integrity_check(self) -> bool:
        """Encode shifted unit vectors; syndrome-check each codeword
        (LDPC_Code_LUT.cpp:547-566)."""
        if self.gen_T is None:
            return True
        H = self._dense_H()
        k = self.k
        u = np.eye(k, dtype=np.uint8)
        x = self.encode(u)
        return bool(((H @ x.T) % 2 == 0).all())


def _peel_full_rank(graph) -> bool:
    """True iff greedy peeling of degree-1 VARIABLES eliminates every
    check of the TRUE matrix (phantom edges excluded): each peeled
    (variable, check) pair pivots a column whose only remaining row is
    that check, so the pivots form a column-permuted triangular
    nchk x nchk submatrix — full row rank, certified in O(E).
    Staircase/accumulator codes (the DVB-S2 parity chain, IRA) peel
    completely from the dv=1 wrap column; unstructured codes stall and
    callers fall back to the dense reduction."""
    import collections

    chk_of_var: list[list[int]] = [[] for _ in range(graph.nvar)]
    ph_pairs = {(p["chk"], p["var"]) for p in graph.phantoms}
    for d in graph.cn_degrees:
        d = int(d)
        for c, vs in zip(graph.cn_node_idx[d], graph.cn_var_idx[d]):
            c = int(c)
            for v in vs:
                if (c, int(v)) not in ph_pairs:
                    chk_of_var[int(v)].append(c)
    chk_alive = np.ones(graph.nchk, dtype=bool)
    vdeg = np.array([len(cs) for cs in chk_of_var], dtype=np.int64)
    queue = collections.deque(np.nonzero(vdeg == 1)[0].tolist())
    removed = 0
    while queue:
        v = queue.popleft()
        if vdeg[v] != 1:
            continue
        c = next(x for x in chk_of_var[v] if chk_alive[x])
        chk_alive[c] = False
        removed += 1
        for v2 in _vars_of_check(graph, c):
            if (c, v2) not in ph_pairs:
                vdeg[v2] -= 1
                if vdeg[v2] == 1:
                    queue.append(v2)
    return removed == graph.nchk


def _vars_of_check(graph, c: int):
    if not hasattr(graph, "_vars_of_chk_cache"):
        cache = [None] * graph.nchk
        for d in graph.cn_degrees:
            d = int(d)
            for cc, vs in zip(graph.cn_node_idx[d], graph.cn_var_idx[d]):
                cache[int(cc)] = [int(v) for v in vs]
        graph._vars_of_chk_cache = cache
    return graph._vars_of_chk_cache[c]


def _chk_minsum_scalar(m: np.ndarray, nz: int) -> np.ndarray:
    """Integer label min-sum CN update (LDPC_Code_LUT.cpp:355-402)."""
    neg = m < nz
    mag = np.where(neg, nz - 1 - m, m - nz)
    order = np.argsort(mag, kind="stable")
    min_idx = order[0]
    min1 = mag[min_idx]
    min2 = np.min(np.delete(mag, min_idx)) if len(m) > 1 else nz
    sign_prod = int(neg.sum()) & 1
    tmp = np.where(np.arange(len(m)) == min_idx, min2, min1)
    sign_msg = sign_prod ^ neg.astype(np.int64)
    return np.where(sign_msg == 1, nz - 1 - tmp, nz + tmp)
