"""Flatten designed LUT trees into dense table programs for the batched decoders.

The reference evaluates each node update by walking an object tree per edge
(its src/LUT_Tree.cpp:402-445, 774-820).  Here a tree becomes a
*program*: a topologically ordered list of ops, each op a mixed-radix label
build over its operands followed by one gather from a small integer table.
Two tricks make every op a plain gather:

- var/dec nodes: the reference stores only the half LUT and mirrors at
  lookup time (``K-1-Q[2L-1-label]``, LUT_Tree.cpp:414-417).  We expand to a
  full table once at layout time, so the runtime op is branch-free.
- chk nodes: the reference folds signed labels to (parity, magnitude) pairs
  on the fly (LUT_Tree.cpp:420-445).  We bake the fold into a full
  signed-label table, so chk ops use the *same* label formula as var ops.

All arrays here are host-side numpy; the decoder lifts them to device
constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.trees import CHKTREE, LUTTree, TreeNode

__all__ = ["TreeOp", "TreeProgram", "tree_program", "leave_one_out_idx"]


@dataclass(frozen=True)
class TreeOp:
    operands: tuple  # operand slots: 0..num_inputs-1 leaves (DFS order), then ops
    bases: tuple  # mixed-radix bases (input 0 least significant)
    table: np.ndarray  # full LUT, int32, len = prod(child resolutions)
    out_res: int


@dataclass(frozen=True)
class TreeProgram:
    num_inputs: int  # leaves, in DFS (queue-consumption) order
    ops: tuple  # topological: children before parents; last op = root
    out_res: int

    def structure_key(self):
        """Hashable shape signature: programs with equal keys differ only in
        table *contents* and can share one compiled decoder body."""
        return (
            self.num_inputs,
            tuple((op.operands, op.bases, len(op.table), op.out_res) for op in self.ops),
        )

    def eval_np(self, inputs: np.ndarray) -> np.ndarray:
        """Vectorized numpy evaluation; inputs (..., num_inputs) int."""
        vals = [inputs[..., i] for i in range(self.num_inputs)]
        for op in self.ops:
            label = np.zeros(inputs.shape[:-1], dtype=np.int64)
            for b, s in zip(op.bases, op.operands):
                label += b * vals[s]
            vals.append(op.table[label])
        return vals[-1]


def _var_full_table(Q_half: np.ndarray, L: int, K: int) -> np.ndarray:
    """Expand a half LUT to the full signed-label table (mirror symmetry)."""
    idx = np.arange(L)
    half = L // 2
    lo = Q_half[np.minimum(idx, half - 1)]
    hi = K - 1 - Q_half[np.minimum(L - 1 - idx, half - 1)]
    return np.where(idx < half, lo, hi).astype(np.int32)


def _chk_full_table(Q_half: np.ndarray, child_res: list[int], K: int) -> np.ndarray:
    """Signed-label table for a chk node: fold each child label into
    (sign, magnitude), build the magnitude mixed-radix label, track total
    parity, and mirror the output for even parity (LUT_Tree.cpp:420-445)."""
    L = int(np.prod(child_res))
    idx = np.arange(L)
    parity = np.zeros(L, dtype=np.int64)
    mag = np.zeros(L, dtype=np.int64)
    base = 1
    t = idx.copy()
    for k in child_res:
        d = t % k
        t //= k
        neg = d < k // 2
        parity ^= neg.astype(np.int64)
        mag += base * np.where(neg, k // 2 - 1 - d, d - k // 2)
        base *= k // 2
    out = np.where(parity == 1, Q_half[mag], K - 1 - Q_half[mag])
    return out.astype(np.int32)


def tree_program(tree: LUTTree) -> TreeProgram:
    """Compile a designed LUTTree into a TreeProgram."""
    ops: list[TreeOp] = []
    leaf_count = 0
    num_leaves = tree.num_leaves

    def rec(node: TreeNode) -> tuple[int, int]:
        nonlocal leaf_count
        if node.is_leaf():
            slot = leaf_count
            leaf_count += 1
            return slot, node.K
        pairs = [rec(c) for c in node.children]
        child_slots = tuple(p[0] for p in pairs)
        child_res = [p[1] for p in pairs]
        bases = tuple(int(b) for b in np.cumprod([1] + child_res[:-1]))
        L = int(np.prod(child_res))
        if node.Q is None:
            raise ValueError("tree_program: tree has undesigned nodes")
        # var/dec half-LUTs span half the joint signed-label space; chk
        # half-LUTs span the joint *magnitude* space prod(K_i/2)
        want = int(np.prod([k // 2 for k in child_res])) if tree.type == CHKTREE else L // 2
        if len(node.Q) != want:
            raise ValueError(f"tree_program: half-LUT length {len(node.Q)} != {want}")
        if tree.type == CHKTREE:
            table = _chk_full_table(np.asarray(node.Q), child_res, node.K)
        else:
            table = _var_full_table(np.asarray(node.Q), L, node.K)
        ops.append(TreeOp(child_slots, bases, table, node.K))
        return num_leaves + len(ops) - 1, node.K

    _, out_res = rec(tree.root)
    return TreeProgram(num_inputs=leaf_count, ops=tuple(ops), out_res=out_res)


def leave_one_out_idx(num_total: int, num_outputs: int) -> np.ndarray:
    """(num_outputs, num_total-1) int32: row i = [0..num_total) minus {i} —
    the per-output input arrangement of the reference's leave-one-out node
    updates (LUT_Tree.cpp:774-807).  VN updates use (d+1, d): the excluded
    slot ranges over the d message inputs, the trailing channel label is
    always kept; CN updates use (d, d)."""
    full = np.arange(num_total, dtype=np.int32)
    return np.stack([np.delete(full, i) for i in range(num_outputs)])
