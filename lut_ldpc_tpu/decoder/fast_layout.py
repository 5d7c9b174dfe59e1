"""Degree-grouped permutation layout + composed LUTs for the fast decoder.

Two ideas turn the message-passing sweep into a handful of dense streaming
ops (a re-design of the reference's per-edge walks, its
src/LDPC_Code_LUT.cpp:259-353 — not a translation of them):

1. **Permutation layout, no scatters.**  Edges live in two static orders:
   VN-grouped (variables sorted by degree, each variable's edges contiguous)
   and CN-grouped (likewise for checks).  Each order is partitioned into
   per-degree *contiguous slices* that reshape to dense (nodes, degree)
   blocks for free.  One iteration is then:
   gather(perm_v2c) -> CN blocks -> gather(perm_c2v) -> VN blocks —
   two (B, E) permutation gathers and elementwise block math.  The
   reference's cn_msg_idx scatter/gather pair (cpp:488-541) disappears.

2. **Composed leave-one-out LUTs.**  A whole degree-d VN tree update —
   including all d leave-one-out evaluations — is precomposed into ONE
   table over the joint input label (d messages + channel), with the d
   4-bit outputs packed into one integer.  A VN update becomes a single
   vector gather from a small table plus shift/mask unpacking,
   instead of d tree walks of 2-input LUT lookups.  Tables are composed
   only while they fit (Nq^d * Nq_Cha entries <= 2^20); high-degree nodes
   fall back to per-op TreeProgram evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.tanner import TannerGraph
from .layout import TreeProgram, leave_one_out_idx, tree_program

__all__ = [
    "GroupedLayout",
    "compose_var_loo_table",
    "compose_dec_table",
    "MAX_COMPOSED_ENTRIES",
]

MAX_COMPOSED_ENTRIES = 1 << 20


@dataclass(frozen=True)
class Block:
    degree: int
    node_start: int  # start in grouped node order (padded coordinates)
    num_nodes: int  # REAL nodes in this block
    edge_start: int  # start in grouped edge order (padded coordinates)
    n_pad: int = 0  # padded node count (== num_nodes when align == 1)


class GroupedLayout:
    """Static index arrays for the permutation-form decoder.

    slot_major=True lays each degree block out with the edge-slot axis
    OUTERMOST (block range reshapes to (d, n, B)), so per-slot reductions
    and leave-one-out arrangements are contiguous slices.
    slot_major=False keeps (n, d, B) node-major order.  The permutations
    absorb the difference.

    align > 1 pads every block's node count to a multiple of `align`, so
    each per-slot plane starts on an aligned row boundary.  Padded node /
    edge rows carry garbage values by design; permutation entries for them
    point at row 0 and all reductions must mask with the blocks'
    [num_nodes, n_pad) ranges.  FastLUTDecoder keeps align=1.
    """

    def __init__(self, graph: TannerGraph, slot_major: bool = False,
                 align: int = 1):
        g = graph
        self.nvar = g.nvar
        self.nchk = g.nchk
        self.num_edges = g.num_edges
        self.slot_major = slot_major
        self.align = align

        def pad(n: int) -> int:
            return -(-n // align) * align

        def block_edges(edge_idx, n_pad):
            # edge_idx (n, d): grouped order within the block; -1 rows pad
            n, d = edge_idx.shape
            if n_pad > n:
                fill = np.full((n_pad - n, d), -1, dtype=edge_idx.dtype)
                edge_idx = np.concatenate([edge_idx, fill], axis=0)
            return edge_idx.T.reshape(-1) if slot_major else edge_idx.reshape(-1)

        # --- VN-grouped order -------------------------------------------
        vn_blocks: list[Block] = []
        vn_nodes = []  # natural var ids in grouped PADDED order (-1 pads)
        vnG_edge_orig = []  # grouped edge position -> original edge id (-1 pads)
        self.vn_node_pos = np.empty(g.nvar, dtype=np.int32)
        npos = epos = 0
        for d in g.vn_degrees:
            d = int(d)
            nodes = g.vn_node_idx[d]
            n, n_pad = len(nodes), pad(len(nodes))
            vn_blocks.append(Block(d, npos, n, epos, n_pad))
            vn_nodes.append(np.concatenate(
                [nodes, np.full(n_pad - n, -1, dtype=nodes.dtype)]))
            self.vn_node_pos[nodes] = npos + np.arange(n, dtype=np.int32)
            vnG_edge_orig.append(block_edges(g.vn_edge_idx[d], n_pad))
            npos += n_pad
            epos += n_pad * d
        self.vn_blocks = vn_blocks
        self.nvar_pad = npos
        self.num_edges_vn = epos
        vn_nodes = np.concatenate(vn_nodes)  # (nvar_pad,)
        self.vn_nodes = np.where(vn_nodes < 0, 0, vn_nodes)
        vnG_edge_orig = np.concatenate(vnG_edge_orig)  # (E_vn_pad,)
        # grouped edge position -> original edge id (-1 at pad rows); kept
        # for cross-layout bridging (hybrid decoder: padded slot-major
        # arith state -> unpadded node-major table state)
        self.vn_edge_orig = vnG_edge_orig

        # --- CN-grouped order -------------------------------------------
        cn_blocks: list[Block] = []
        cnG_edge_orig = []
        cn_var_natural = []  # variable id of each cn-grouped edge (-1 pads)
        cn_nodes = []  # natural check ids in grouped PADDED order (-1 pads)
        npos = epos = 0
        for d in g.cn_degrees:
            d = int(d)
            nodes = g.cn_node_idx[d]
            n, n_pad = len(nodes), pad(len(nodes))
            cn_blocks.append(Block(d, npos, n, epos, n_pad))
            cn_nodes.append(np.concatenate(
                [nodes, np.full(n_pad - n, -1, dtype=nodes.dtype)]))
            cnG_edge_orig.append(block_edges(g.cn_edge_idx[d], n_pad))
            cn_var_natural.append(block_edges(g.cn_var_idx[d], n_pad))
            npos += n_pad
            epos += n_pad * d
        self.cn_blocks = cn_blocks
        # kept with -1 pads (vn_nodes clamps pads to 0 for gather use)
        self.cn_nodes = np.concatenate(cn_nodes)
        self.nchk_pad = npos
        self.num_edges_cn = epos
        cnG_edge_orig = np.concatenate(cnG_edge_orig)

        # --- permutations ------------------------------------------------
        inv_vnG = np.empty(g.num_edges, dtype=np.int64)
        inv_vnG[vnG_edge_orig[vnG_edge_orig >= 0]] = np.nonzero(
            vnG_edge_orig >= 0
        )[0]
        inv_cnG = np.empty(g.num_edges, dtype=np.int64)
        inv_cnG[cnG_edge_orig[cnG_edge_orig >= 0]] = np.nonzero(
            cnG_edge_orig >= 0
        )[0]
        # cn-grouped position -> vn-grouped position of the same edge
        self.perm_v2c = np.where(
            cnG_edge_orig >= 0, inv_vnG[cnG_edge_orig], 0
        ).astype(np.int32)
        # vn-grouped position -> cn-grouped position
        self.perm_c2v = np.where(
            vnG_edge_orig >= 0, inv_cnG[vnG_edge_orig], 0
        ).astype(np.int32)

        # grouped-bit-vector positions of each cn-grouped edge's variable
        # (for the final syndrome check on decision bits)
        cn_var_natural = np.concatenate(cn_var_natural)
        self.cn_var_pos = np.where(
            cn_var_natural >= 0, self.vn_node_pos[cn_var_natural], 0
        ).astype(np.int32)

    # ------------------------------------------------------------------


def _mixed_radix_digits(n: int, radices: list[int]) -> np.ndarray:
    """(n, len(radices)) digit table, radix 0 least significant."""
    idx = np.arange(n, dtype=np.int64)
    out = np.empty((n, len(radices)), dtype=np.int32)
    for j, r in enumerate(radices):
        out[:, j] = idx % r
        idx //= r
    return out


def composed_entries(d: int, Nq_msg: int, Nq_cha: int) -> int:
    return Nq_msg**d * Nq_cha


def compose_var_loo_table(
    prog: TreeProgram, d: int, Nq_msg: int, Nq_cha: int, out_bits: int
) -> np.ndarray:
    """Packed leave-one-out table for a degree-d VN tree.

    Entry at joint label (m_0 + Nq*m_1 + ... + Nq^{d-1}*m_{d-1} +
    Nq^d*cha) packs the d leave-one-out outputs, output i in bits
    [i*out_bits, (i+1)*out_bits).  dtype int32 (callers may narrow)."""
    if d * out_bits > 31:
        raise ValueError("compose_var_loo_table: packed width exceeds int32")
    n = composed_entries(d, Nq_msg, Nq_cha)
    inputs = _mixed_radix_digits(n, [Nq_msg] * d + [Nq_cha])
    loo = leave_one_out_idx(d + 1, d)
    packed = np.zeros(n, dtype=np.int64)
    for i in range(d):
        out = prog.eval_np(inputs[:, loo[i]]).astype(np.int64)
        packed |= out << (i * out_bits)
    return packed.astype(np.int32)


def compose_dec_table(prog: TreeProgram, d: int, Nq_msg: int, Nq_cha: int) -> np.ndarray:
    """Hard-decision table for a degree-d decision tree: entry = output
    label (resolution 2) at joint label (d messages + channel)."""
    n = composed_entries(d, Nq_msg, Nq_cha)
    inputs = _mixed_radix_digits(n, [Nq_msg] * d + [Nq_cha])
    return prog.eval_np(inputs).astype(np.int32)


def var_tree_tables(tree, d: int, Nq_msg: int, Nq_cha: int, Nq_out: int):
    """Either ('composed', packed table) or ('program', (prog, tables))."""
    prog = tree_program(tree)
    out_bits = max(1, int(np.ceil(np.log2(Nq_out))))
    if (
        composed_entries(d, Nq_msg, Nq_cha) <= MAX_COMPOSED_ENTRIES
        and d * out_bits <= 31
    ):
        return "composed", compose_var_loo_table(prog, d, Nq_msg, Nq_cha, out_bits)
    return "program", prog
