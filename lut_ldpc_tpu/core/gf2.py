"""Dense GF(2) linear algebra on bit-packed uint64 words.

Used for rank computation and systematic-generator construction (the
equivalents of IT++ GF2mat::row_rank and LDPC_Generator_Systematic used by
/root/reference/src/LDPC_Code_LUT.cpp:488-541 and LDPC_BER_Sim.cpp:157-244).
Row operations are vectorized over packed words, so elimination runs at
memory bandwidth rather than per-bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack_rows", "unpack_rows", "gf2_row_reduce", "gf2_rank", "make_systematic_generator", "make_systematic_generator_cached"]


def pack_rows(M: np.ndarray) -> np.ndarray:
    """Pack a (r, c) 0/1 matrix into (r, ceil(c/64)) uint64 words (LSB-first)."""
    M = np.asarray(M, dtype=np.uint8)
    r, c = M.shape
    # one bit per entry, 8 per byte LSB-first, then 8 bytes per
    # little-endian word: column 64*w + j lands on bit j of word w
    packed = np.packbits(M != 0, axis=1, bitorder="little")
    pad = (-packed.shape[1]) % 8
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((r, pad), dtype=np.uint8)], axis=1)
    return np.ascontiguousarray(packed).view("<u8").astype(np.uint64)


def unpack_rows(P: np.ndarray, ncols: int) -> np.ndarray:
    r, w = P.shape
    shifts = np.arange(64, dtype=np.uint64)[None, None, :]
    bits = (P[:, :, None] >> shifts) & np.uint64(1)
    return bits.reshape(r, w * 64)[:, :ncols].astype(np.uint8)


def _getbit(P: np.ndarray, row: int, col: int) -> int:
    return int((P[row, col // 64] >> np.uint64(col % 64)) & np.uint64(1))


def gf2_row_reduce(P: np.ndarray, ncols: int, full: bool = True):
    """In-place row reduction of packed matrix P; returns (rank, pivot_cols).

    If full, produces reduced row-echelon form (eliminates above pivots too).
    """
    nrows = P.shape[0]
    pivot_cols = []
    r = 0
    for col in range(ncols):
        if r >= nrows:
            break
        # find a pivot row
        word, bit = col // 64, np.uint64(col % 64)
        colbits = (P[r:, word] >> bit) & np.uint64(1)
        nz = np.nonzero(colbits)[0]
        if len(nz) == 0:
            continue
        piv = r + int(nz[0])
        if piv != r:
            P[[r, piv]] = P[[piv, r]]
        # eliminate this column from all other rows (or rows below)
        start = 0 if full else r + 1
        colbits_all = (P[start:, word] >> bit) & np.uint64(1)
        mask = np.nonzero(colbits_all)[0] + start
        mask = mask[mask != r]
        if len(mask):
            P[mask] ^= P[r]
        pivot_cols.append(col)
        r += 1
    return r, np.array(pivot_cols, dtype=np.int64)


def gf2_rank(M: np.ndarray) -> int:
    P = pack_rows(M)
    rank, _ = gf2_row_reduce(P, M.shape[1], full=False)
    return rank


def make_systematic_generator(H: np.ndarray):
    """Column-permute H so its last `rank` columns are invertible; derive G.

    Returns (perm, gen_T, rank) where
    - perm: column permutation applied to H (new_H = H[:, perm]); the
      permuted code has systematic bits first, parity bits last,
    - gen_T: (k, rank) uint8 matrix with parity = u @ gen_T mod 2,
    - rank: number of linearly independent checks (nchk_lin_indep).

    Encoding of u (k = nvar - rank bits): x = [u, u @ gen_T mod 2] is a
    codeword of the permuted H.
    """
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    P = pack_rows(H)
    rank, pivots = gf2_row_reduce(P, n, full=True)
    R = unpack_rows(P[:rank], n)  # RREF, rank rows
    nonpivots = np.setdiff1d(np.arange(n), pivots)
    # permuted H: [nonpivot (systematic) columns | pivot (parity) columns]
    perm = np.concatenate([nonpivots, pivots])
    # In RREF, R[:, pivots] = I, so parity bits p satisfy p = R[:, nonpivots] @ u
    A = R[:, nonpivots]  # (rank, k)
    gen_T = A.T.copy()  # (k, rank)
    return perm, gen_T, rank


def make_systematic_generator_cached(H: np.ndarray, cache: str | None):
    """make_systematic_generator with an npz cache next to the code file.

    Mirrors the reference's `<code>.gen.it` caching
    (/root/reference/src/LDPC_BER_Sim.cpp:168-189): loaded when the cached
    H digest matches, written atomically (temp + rename) otherwise."""
    import hashlib
    import os
    import tempfile

    H = np.asarray(H, dtype=np.uint8)
    digest = hashlib.sha256(H.tobytes()).hexdigest()
    if cache and os.path.exists(cache):
        d = np.load(cache)
        if str(d["h_sha256"]) == digest:
            return d["perm"], d["gen_T"], int(d["rank"])
    perm, gen_T, rank = make_systematic_generator(H)
    if cache:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache) or ".",
                                   suffix=".npz")
        os.close(fd)
        np.savez_compressed(tmp, perm=perm, gen_T=gen_T, rank=rank,
                            h_sha256=digest)
        os.replace(tmp, cache)
    return perm, gen_T, rank
