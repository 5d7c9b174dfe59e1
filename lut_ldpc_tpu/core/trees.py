"""LUT trees: the decoder's per-node compute graph and its DE design object.

A LUT tree decomposes a degree-d node update into a tree of small lookup
tables.  At design time, symmetric pmfs flow leaves->root and each internal
node's LUT is designed with the MI-optimal quantizer; at run time, integer
message labels flow leaves->root through the designed tables.

This module is the host-side (design/serialization/reference-eval) form;
`lut_ldpc_tpu.decoder.layout` flattens designed trees into stacked integer
tables for the batched decoders.

Semantics mirror /root/reference/src/LUT_Tree.{hpp,cpp}; the text
serialization format is byte-compatible with the reference
(trees/README.md) so codec artifacts are interchangeable.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from ..ops.pmf import get_chk_product_pmf, get_var_product_pmf, seq_sum
from ..ops.quant import quant_mi_sym

# node types (LUT_Tree.hpp:188-194); integer codes fixed by the file format
IM, ROOT, MSG, CHA = 0, 1, 2, 3
NODE_CHARS = {"i": IM, "r": ROOT, "m": MSG, "c": CHA}

# tree types (LUT_Tree.hpp:50-55)
VARTREE, CHKTREE, DECTREE = 0, 1, 2


@dataclass
class TreeNode:
    type: int
    children: list["TreeNode"] = field(default_factory=list)
    K: int = 0  # output resolution
    Q: np.ndarray | None = None  # half-LUT: len = prod(child res)/2
    p: np.ndarray | None = None  # design-time output pmf

    # -- structure ---------------------------------------------------------
    def deep_copy(self) -> "TreeNode":
        return TreeNode(
            self.type,
            [c.deep_copy() for c in self.children],
            self.K,
            None if self.Q is None else self.Q.copy(),
            None if self.p is None else self.p.copy(),
        )

    def is_leaf(self) -> bool:
        return self.type in (MSG, CHA)

    def num_leaves(self) -> int:
        if self.is_leaf():
            return 1
        return sum(c.num_leaves() for c in self.children)

    def height(self) -> int:
        h = 0
        for c in self.children:
            h = max(h, c.height() + 1)
        return h

    def set_resolution(self, Nq_in: int, Nq_out: int, Nq_cha: int = 0) -> None:
        if self.type == ROOT:
            self.K = Nq_out
        elif self.type == CHA:
            self.K = Nq_cha
        else:
            self.K = Nq_in
        for c in self.children:
            c.set_resolution(Nq_in, Nq_out, Nq_cha)

    def set_leaves(self, p_msg: np.ndarray, p_cha: np.ndarray) -> None:
        if self.type == MSG:
            self.p = np.asarray(p_msg, dtype=np.float64)
        elif self.type == CHA:
            self.p = np.asarray(p_cha, dtype=np.float64)
        else:
            for c in self.children:
                c.set_leaves(p_msg, p_cha)

    def reset_pmfs(self) -> None:
        self.p = None
        for c in self.children:
            c.reset_pmfs()

    def level_nodes(self, req_level: int, cur_level: int = 0) -> list["TreeNode"]:
        if req_level == cur_level:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.level_nodes(req_level, cur_level + 1))
        return out

    # -- design-time -------------------------------------------------------
    def get_input_product_pmf(self, tree_type: int) -> np.ndarray:
        p_in = [c.p for c in self.children]
        if tree_type in (VARTREE, DECTREE):
            return get_var_product_pmf(p_in)
        if tree_type == CHKTREE:
            return get_chk_product_pmf(p_in)
        raise ValueError("unsupported tree type")

    def tree_update(self, reuse: bool, update_fn) -> np.ndarray:
        if self.is_leaf():
            return self.p
        p_in = [c.tree_update(reuse, update_fn) for c in self.children]
        self.p, self.Q = update_fn(p_in, self.K, self.Q if reuse else None)
        return self.p

    # -- run-time reference evaluation (scalar; golden model for the batched path) --
    def var_eval(self, msgs: list[int]) -> int:
        """Mixed-radix label build + mirrored half-LUT lookup (LUT_Tree.cpp:402)."""
        if self.is_leaf():
            return msgs.pop(0)
        label = 0
        base = 1
        for c in self.children:
            label += base * c.var_eval(msgs)
            base *= c.K
        if label < len(self.Q):
            return int(self.Q[label])
        return self.K - 1 - int(self.Q[2 * len(self.Q) - 1 - label])

    def chk_eval(self, msgs: list[int]) -> int:
        """Parity-tracked magnitude label + half-LUT lookup (LUT_Tree.cpp:420)."""
        if self.type == MSG:
            return msgs.pop(0)
        label = 0
        base = 1
        parity = 0
        for c in self.children:
            s = c.chk_eval(msgs)
            K = c.K
            if s < K // 2:
                parity ^= 1
                label += base * (K // 2 - 1 - s)
            else:
                label += base * (s - K // 2)
            base *= K // 2
        if parity == 1:
            return int(self.Q[label])
        return self.K - 1 - int(self.Q[label])

    # -- TikZ drawing (LUT_Tree.cpp:308-368) --------------------------------
    def tikz_draw(self) -> str:
        """TikZ code drawing this (sub)tree, reference style."""
        height = self.height()
        out = [
            "\\tikzset{",
            "   leavenode/.style = {align=center, inner sep=2pt, text centered },",
            "   imnode/.style = {align=center, inner sep=1pt, text centered},",
        ]
        for hh in range(1, height + 1):
            out.append(
                f"   level {hh}/.style={{sibling distance="
                f"{7 * 2 ** (height - hh)}mm}},"
            )
        out += [
            "}",
            "",
            "\\def\\imstring{$\\Phi$}",
            "\\def\\chastring{$L$}",
            "\\def\\msgstring{$\\mu$}",
            "",
            "\\begin{tikzpicture}[<-, >=stealth]",
        ]
        body = []
        self._tikz_recursive(body, 0)
        return "\n".join(out) + "".join(body) + "\n\\end{tikzpicture}"

    def _tikz_recursive(self, out: list, level: int) -> None:
        indent = "\n" + "   " * level
        if self.type == ROOT:
            out.append(indent + "\\node (root)[imnode] {\\imstring}")
        elif self.type == MSG:
            out.append(indent + "child{ node [leavenode] {\\msgstring}")
        elif self.type == CHA:
            out.append(indent + "child{ node [leavenode] {\\chastring}")
        else:
            out.append(indent + "child{ node[imnode] {\\imstring}")
        for c in self.children:
            c._tikz_recursive(out, level + 1)
        out.append(indent + (";" if self.type == ROOT else "}"))

    # -- serialization (format of trees/README.md) --------------------------
    def template_string(self) -> str:
        s = {IM: "i", ROOT: "r", MSG: "m", CHA: "c"}[self.type]
        for c in self.children:
            s += c.template_string()
        return s + "/"

    def serialize(self, out: io.TextIOBase) -> None:
        out.write(f"{len(self.children)}\n")
        inres = 0 if self.Q is None else len(self.Q)
        out.write(f"{self.type} {inres} {self.K}\n")
        if inres > 0:
            out.write(" ".join(str(int(q)) for q in self.Q) + "\n")
        for c in self.children:
            c.serialize(out)

    @staticmethod
    def deserialize(inp: io.TextIOBase) -> "TreeNode":
        num_children = int(inp.readline().split()[0])
        t, inres, outres = (int(x) for x in inp.readline().split()[:3])
        node = TreeNode(t, K=outres)
        if inres > 0:
            node.Q = np.array([int(x) for x in inp.readline().split()], dtype=np.int64)
            assert len(node.Q) == inres
        for _ in range(num_children):
            node.children.append(TreeNode.deserialize(inp))
        return node


# ---------------------------------------------------------------------------
# template-string parsing and auto generators (LUT_Tree.cpp:167-294)
# ---------------------------------------------------------------------------


def parse_template(s: str) -> TreeNode:
    """Pre-order DFS template string: r/i/m/c chars, '/' closes a node."""
    stream = iter(s)

    def rec() -> TreeNode | None:
        c = next(stream, None)
        if c is None or c == "/":
            return None
        if c not in NODE_CHARS:
            raise ValueError(f"parse_template: invalid character {c!r}")
        node = TreeNode(NODE_CHARS[c])
        while True:
            child = rec()
            if child is None:
                break
            node.children.append(child)
        return node

    root = rec()
    if root is None:
        raise ValueError("parse_template: empty template")
    return root


def _root_cha_only() -> TreeNode:
    """Degree-1 VN tree: ROOT over the channel leaf alone (no incoming
    messages in the leave-one-out queue).  The reference cannot design this
    shape (LUT_Tree.cpp:202 asserts num_leaves >= 2) so codes like the
    standard DVB-S2 matrix, whose accumulator tail leaves one degree-1
    column, are out of its design reach; here the root LUT degenerates to
    the MI-optimal requantization of the channel pmf, which quant_mi_sym
    handles like any other node."""
    return TreeNode(ROOT, [TreeNode(CHA)])


def gen_bin_balanced_tree(num_leaves: int, var: bool, leaf_type: int = MSG) -> TreeNode:
    """Bottom-up pairing queue; var trees get the channel leaf at the root."""
    if var and num_leaves == 1:
        return _root_cha_only()
    assert num_leaves >= 2
    nodes = [TreeNode(leaf_type) for _ in range(num_leaves - int(var))]
    while True:
        if len(nodes) == 1:
            if var:
                root = TreeNode(ROOT, [nodes[0], TreeNode(CHA)])
            else:
                root = nodes[0]
                root.type = ROOT
            return root
        left = nodes.pop(0)
        right = nodes.pop(0)
        nodes.append(TreeNode(IM, [left, right]))


def gen_bin_high_tree(num_leaves: int, var: bool, leaf_type: int = MSG) -> TreeNode:
    """Maximum-height binary chain (trellis shape)."""
    if var and num_leaves == 1:
        return _root_cha_only()
    assert num_leaves >= 2
    root = TreeNode(ROOT)
    root.children.append(TreeNode(CHA if var else leaf_type))
    cur = root
    todo = num_leaves - 1
    while todo > 1:
        im = TreeNode(IM)
        cur.children.insert(0, im)
        cur = im
        cur.children.append(TreeNode(leaf_type))
        todo -= 1
    cur.children.append(TreeNode(leaf_type))
    return root


def gen_root_only_tree(num_leaves: int, var: bool, leaf_type: int = MSG) -> TreeNode:
    if var and num_leaves == 1:
        return _root_cha_only()
    assert num_leaves >= 2
    root = TreeNode(ROOT, [TreeNode(leaf_type) for _ in range(num_leaves - 1)])
    root.children.append(TreeNode(CHA if var else leaf_type))
    return root


_AUTO_GEN = {
    "auto_bin_balanced": gen_bin_balanced_tree,
    "auto_bin_high": gen_bin_high_tree,
    "root_only": gen_root_only_tree,
}


# ---------------------------------------------------------------------------
# design-time node updates (LUT_Tree.cpp:709-766)
# ---------------------------------------------------------------------------


def _apply_half_lut_pmf(p_prod: np.ndarray, Q_half: np.ndarray, Nq: int) -> np.ndarray:
    """Output pmf of a designed half-LUT applied to the product pmf."""
    M = len(p_prod)
    p_out = np.zeros(Nq, dtype=np.float64)
    np.add.at(p_out, Q_half, p_prod[: M // 2])
    np.add.at(p_out, Nq - 1 - Q_half[::-1], p_prod[M // 2 :])
    return p_out


def _design_sym_masked(p_prod: np.ndarray, Nq: int):
    """quant_mi_sym on the nonzero-mass support, symmetric defaults elsewhere.

    Zero-mass labels get the least-confident magnitudes (Nq/2-1 / Nq/2),
    matching LUT_Tree.cpp:724-738.
    """
    M = len(p_prod)
    nz = 0.5 * (p_prod + p_prod[::-1]) != 0
    _, p_out, Q_nz = quant_mi_sym(p_prod[nz], Nq, is_sorted=False)
    Q_full = np.concatenate(
        [np.full(M // 2, Nq // 2 - 1, dtype=np.int64), np.full(M // 2, Nq // 2, dtype=np.int64)]
    )
    Q_full[nz] = Q_nz
    return p_out, Q_full


def var_update(p_in: list[np.ndarray], Nq: int, Q_reuse: np.ndarray | None):
    """Design (or reuse) a VN-combine LUT; returns (p_out, Q_half)."""
    p_prod = get_var_product_pmf(p_in)
    if Q_reuse is not None:
        p_out = _apply_half_lut_pmf(p_prod, Q_reuse, Nq)
        Q_half = Q_reuse
    else:
        p_out, Q_full = _design_sym_masked(p_prod, Nq)
        Q_half = Q_full[: len(Q_full) // 2]
    return p_out / seq_sum(p_out), Q_half


def chk_update(p_in: list[np.ndarray], Nq: int, Q_reuse: np.ndarray | None):
    """Design (or reuse) a CN-combine LUT; returns (p_out, Q_half)."""
    p_prod = get_chk_product_pmf(p_in)
    if Q_reuse is not None:
        p_out = _apply_half_lut_pmf(p_prod, Q_reuse, Nq)
        Q_half = Q_reuse
    else:
        _, p_out, Q_full = quant_mi_sym(p_prod, Nq, is_sorted=False)
        Q_half = Q_full[: len(Q_full) // 2]
    return p_out / seq_sum(p_out), Q_half


# ---------------------------------------------------------------------------
# LUTTree
# ---------------------------------------------------------------------------


class LUTTree:
    """A typed LUT tree (VARTREE / CHKTREE / DECTREE)."""

    def __init__(self, root: TreeNode, tree_type: int):
        self.root = root
        self.type = tree_type
        self.num_leaves = root.num_leaves()

    # -- constructors --------------------------------------------------
    @classmethod
    def from_template(cls, template: str, tree_type: int) -> "LUTTree":
        if "c" not in template and tree_type != CHKTREE:
            raise ValueError("non-CHKTREE templates need a channel leaf")
        return cls(parse_template(template), tree_type)

    @classmethod
    def auto(cls, num_leaves: int, tree_type: int, mode: str) -> "LUTTree":
        gen = _AUTO_GEN[mode]
        return cls(gen(num_leaves, var=tree_type in (VARTREE, DECTREE)), tree_type)

    def copy(self) -> "LUTTree":
        return LUTTree(self.root.deep_copy(), self.type)

    # -- config ----------------------------------------------------------
    def set_resolution(self, Nq_in: int, Nq_out: int, Nq_cha: int = 0) -> None:
        self.root.set_resolution(Nq_in, Nq_out, Nq_cha)

    def set_leaves(self, p_msg, p_cha=None) -> None:
        self.root.set_leaves(p_msg, p_cha)

    def reset_pmfs(self) -> None:
        self.root.reset_pmfs()

    def height(self) -> int:
        return self.root.height()

    def level_nodes(self, level: int) -> list[TreeNode]:
        return self.root.level_nodes(level)

    def template_string(self) -> str:
        return self.root.template_string()

    # -- design ----------------------------------------------------------
    def update(self, reuse: bool = False) -> np.ndarray:
        fn = chk_update if self.type == CHKTREE else var_update
        return self.root.tree_update(reuse, fn)

    # -- run-time reference evaluation ------------------------------------
    def var_msg_update(self, msgs: list[int], llr: int) -> list[int]:
        """All-d leave-one-out outputs of a VN (LUT_Tree.cpp:774-790)."""
        if len(msgs) != self.num_leaves:
            raise ValueError(
                f"var_msg_update: need {self.num_leaves} messages, got {len(msgs)}"
            )
        out = []
        full = list(msgs) + [llr]
        for ii in range(len(msgs)):
            que = full[:ii] + full[ii + 1 :]
            out.append(self.root.var_eval(que))
        return out

    def chk_msg_update(self, msgs: list[int]) -> list[int]:
        """All-d leave-one-out outputs of a CN (LUT_Tree.cpp:792-807)."""
        if len(msgs) != self.num_leaves + 1:
            raise ValueError(
                f"chk_msg_update: need {self.num_leaves + 1} messages, got {len(msgs)}"
            )
        out = []
        for ii in range(len(msgs)):
            que = msgs[:ii] + msgs[ii + 1 :]
            out.append(self.root.chk_eval(que))
        return out

    def dec_update(self, msgs: list[int], llr: int) -> int:
        if len(msgs) + 1 != self.num_leaves:
            raise ValueError(
                f"dec_update: need {self.num_leaves - 1} messages, got {len(msgs)}"
            )
        que = list(msgs) + [llr]
        return self.root.var_eval(que)

    # -- serialization ------------------------------------------------------
    def serialize(self) -> str:
        buf = io.StringIO()
        buf.write(f"{self.type} {self.num_leaves}\n")
        self.root.serialize(buf)
        return buf.getvalue()

    @classmethod
    def deserialize(cls, inp: io.TextIOBase | str) -> "LUTTree":
        if isinstance(inp, str):
            inp = io.StringIO(inp)
        t, numl = (int(x) for x in inp.readline().split()[:2])
        tree = cls(TreeNode.deserialize(inp), t)
        assert tree.num_leaves == numl
        return tree

    def __str__(self) -> str:
        return self.serialize()


def serialize_tree_array(trees: list[list[LUTTree]]) -> str:
    """Array<Array<LUT_Tree>> text format (LUT_Tree.cpp:855-864)."""
    buf = io.StringIO()
    buf.write(f"{len(trees)}\n")
    for row in trees:
        buf.write(f"{len(row)}\n")
        for t in row:
            buf.write(t.serialize())
    return buf.getvalue()


def deserialize_tree_array(inp: io.TextIOBase | str) -> list[list[LUTTree]]:
    if isinstance(inp, str):
        inp = io.StringIO(inp)
    first = inp.readline().split()
    n = int(first[0]) if first else 0
    out = []
    for _ in range(n):
        deg = int(inp.readline().split()[0])
        out.append([LUTTree.deserialize(inp) for _ in range(deg)])
    return out
