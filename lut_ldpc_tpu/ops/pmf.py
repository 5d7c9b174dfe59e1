"""Symmetric-pmf algebra for discrete density evolution.

Design-time math runs on the host in float64 numpy: the pmfs involved are
tiny (<= Nq_fine entries) and the algorithms are sequential dynamic programs,
so there is nothing for an accelerator to do here.  The batched decoders
consume only the *outputs* of this module (integer LUT tables).

Semantics follow the reference implementation of LUT-LDPC
(/root/reference/src/common.cpp, /root/reference/src/LDPC_DE.cpp) but are
re-derived as vectorized numpy:

- label convention: a pmf of length M over message labels 0..M-1 represents a
  *symmetric* binary-input channel output; label m and its mirror M-1-m swap
  roles when the channel input flips.  Lower half = "error" half (LLR < 0 for
  the transmitted bit).
- joint labels of multiple inputs use mixed radix with input 0 least
  significant (common.cpp:30-70, LUT_Tree.cpp:402-445).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "seq_sum",
    "get_gaussian_pmf",
    "get_var_product_pmf",
    "get_chk_product_pmf",
    "signed_to_unsigned_idx",
    "signed_to_unsigned_map",
    "pmf_plus",
    "pmf_minus",
    "pmf_join",
    "chk_update_minsum",
    "get_mi_bcpmf_sym",
    "sig2snr",
    "snr2sig",
    "rate_to_shannon_thr",
    "shannon_thr_to_rate",
    "qfunc",
]


def seq_sum(x) -> float:
    """Strictly sequential float64 sum (left-to-right accumulation).

    numpy's pairwise summation rounds differently than the reference's
    sequential loops; design-path normalizations use this so downstream
    argmax/comparison ties resolve identically and designed LUTs are
    bit-identical to the reference.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 0.0
    return float(np.cumsum(x)[-1])


def qfunc(x):
    """Gaussian tail function Q(x) = P(N(0,1) > x)."""
    from math import erfc, sqrt

    x = np.asarray(x, dtype=np.float64)
    return 0.5 * np.vectorize(erfc)(x / np.sqrt(2.0))


def get_gaussian_pmf(mu: float, sig: float, N: int, delta: float) -> np.ndarray:
    """Quantize N(mu, sig^2) onto N uniform bins of width delta centered at 0.

    Bin n covers ((n - N/2) * delta, (n + 1 - N/2) * delta]; the first and
    last bins absorb the overload tails.  Matches common.cpp:140-149.
    """
    n = np.arange(1, N - 1, dtype=np.float64)
    pmf = np.empty(N, dtype=np.float64)
    pmf[0] = 1.0 - qfunc(((-N / 2.0 + 1) * delta - mu) / sig)
    pmf[1:-1] = qfunc(((n - N / 2.0) * delta - mu) / sig) - qfunc(
        ((n + 1 - N / 2.0) * delta - mu) / sig
    )
    pmf[-1] = qfunc(((N / 2.0 - 1) * delta - mu) / sig)
    return pmf / seq_sum(pmf)


def get_var_product_pmf(p_in: list[np.ndarray]) -> np.ndarray:
    """Joint pmf of independent inputs under mixed-radix labels.

    Output index m decodes as (m % K0, (m // K0) % K1, ...): input 0 is the
    least-significant digit.  Matches common.cpp:30-39.
    """
    prod = np.asarray(p_in[-1], dtype=np.float64)
    for ii in range(len(p_in) - 2, -1, -1):
        prod = np.kron(prod, np.asarray(p_in[ii], dtype=np.float64))
    return prod


def signed_to_unsigned_idx(idx: int, inres: np.ndarray) -> int:
    """Map a mixed-radix signed-label index to a parity/magnitude index.

    Each input label l with resolution K splits into sign (l < K/2) and
    magnitude; the output index packs the magnitudes in mixed radix (base
    K_i/2) and the total parity selects the lower (odd parity) or mirrored
    upper (even parity) half.  Matches common.cpp:193-228.
    """
    inres = np.asarray(inres, dtype=np.int64)
    out_max = 2 * np.prod(inres // 2)
    parity = 0
    idx_out = 0
    base = 1
    t = idx
    for K in inres:
        d = t % K
        t //= K
        if d < K // 2:
            parity ^= 1
            idx_out += base * (K // 2 - 1 - d)
        else:
            idx_out += base * (d - K // 2)
        base *= K // 2
    return idx_out if parity == 1 else int(out_max) - 1 - idx_out


def signed_to_unsigned_map(inres: np.ndarray) -> np.ndarray:
    """Vectorized signed_to_unsigned_idx for all prod(inres) indices."""
    inres = np.asarray(inres, dtype=np.int64)
    n = int(np.prod(inres))
    idx = np.arange(n, dtype=np.int64)
    out_max = 2 * int(np.prod(inres // 2))
    parity = np.zeros(n, dtype=np.int64)
    idx_out = np.zeros(n, dtype=np.int64)
    base = 1
    t = idx
    for K in inres:
        K = int(K)
        d = t % K
        t = t // K
        neg = d < K // 2
        parity ^= neg.astype(np.int64)
        idx_out += base * np.where(neg, K // 2 - 1 - d, d - K // 2)
        base *= K // 2
    return np.where(parity == 1, idx_out, out_max - 1 - idx_out)


def get_chk_product_pmf(p_in: list[np.ndarray]) -> np.ndarray:
    """Joint pmf at a check node combine, folded to parity/magnitude labels.

    Tracks the label-joint pmf conditioned on even/odd parity of the hidden
    bits, then folds signed labels to (parity, magnitudes) indices; symmetry
    is restored by the fold.  Matches common.cpp:41-70.
    """
    p_in = [np.asarray(p, dtype=np.float64) for p in p_in]
    res_inputs = np.array([len(p) for p in p_in], dtype=np.int64)

    prod0 = p_in[-1]
    prod1 = p_in[-1][::-1].copy()
    for ii in range(len(p_in) - 2, -1, -1):
        pi = p_in[ii]
        pif = pi[::-1]
        new0 = 0.5 * (np.kron(prod0, pi) + np.kron(prod1, pif))
        new1 = 0.5 * (np.kron(prod1, pi) + np.kron(prod0, pif))
        prod0, prod1 = new0, new1

    out = np.zeros(2 * int(np.prod(res_inputs // 2)), dtype=np.float64)
    np.add.at(out, signed_to_unsigned_map(res_inputs), prod0)
    return out


def pmf_plus(pmf: np.ndarray) -> np.ndarray:
    """Magnitude pmf: p+[n] = p[N/2+n] + p[N/2-1-n] (LDPC_DE.cpp:1091)."""
    pmf = np.asarray(pmf, dtype=np.float64)
    N = len(pmf)
    assert N % 2 == 0
    return pmf[N // 2 :] + pmf[: N // 2][::-1]


def pmf_minus(pmf: np.ndarray) -> np.ndarray:
    """Signed magnitude pmf: p-[n] = p[N/2+n] - p[N/2-1-n] (LDPC_DE.cpp:1101)."""
    pmf = np.asarray(pmf, dtype=np.float64)
    N = len(pmf)
    assert N % 2 == 0
    return pmf[N // 2 :] - pmf[: N // 2][::-1]


def pmf_join(pmf_p: np.ndarray, pmf_m: np.ndarray) -> np.ndarray:
    """Inverse of (pmf_plus, pmf_minus) (LDPC_DE.cpp:1111)."""
    pmf_p = np.asarray(pmf_p, dtype=np.float64)
    pmf_m = np.asarray(pmf_m, dtype=np.float64)
    n = len(pmf_p)
    out = np.empty(2 * n, dtype=np.float64)
    out[n:] = 0.5 * (pmf_p + pmf_m)
    out[:n] = (0.5 * (pmf_p - pmf_m))[::-1]
    return out


def chk_update_minsum(p_in: np.ndarray, dc: int) -> np.ndarray:
    """Density evolution of the integer min-sum check update (min-LUT mode).

    Output message = min of dc-1 incoming magnitudes with XORed signs;
    in the +/- transform domain the min-combination of two magnitude pmfs is
    c[k] = a[k] * B>=k + b[k] * A>k (suffix sums).  Matches the quadratic-loop
    accumulation of LDPC_DE.cpp:1061-1089 up to fp summation order.
    """
    from .._native import chk_update_minsum_native

    native = chk_update_minsum_native(np.asarray(p_in, dtype=np.float64), dc)
    if native is not None:
        return native

    p_in = np.asarray(p_in, dtype=np.float64)
    a_plus = pmf_plus(p_in)
    a_minus = pmf_minus(p_in)
    b_plus = a_plus.copy()
    b_minus = a_minus.copy()

    def min_comb(a, b):
        # suffix[k] = sum_{j>=k} b[j]
        b_suf = np.cumsum(b[::-1])[::-1]
        a_suf_strict = np.concatenate([np.cumsum(a[::-1])[::-1][1:], [0.0]])
        return a * b_suf + b * a_suf_strict

    c_plus, c_minus = b_plus, b_minus
    for _ in range(dc - 2):
        c_plus = min_comb(a_plus, b_plus)
        c_minus = min_comb(a_minus, b_minus)
        b_plus, b_minus = c_plus, c_minus
    return pmf_join(c_plus, c_minus)


def get_mi_bcpmf_sym(p: np.ndarray) -> float:
    """Mutual information of a symmetric binary-channel pmf (common.cpp:371)."""
    p = np.asarray(p, dtype=np.float64)
    K = len(p)
    assert K > 0 and K % 2 == 0
    a = p[: K // 2]
    b = p[K // 2 :][::-1]  # mirror partners
    s = a + b
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(a > 0, a * np.log2(np.where(a > 0, 2 * a / s, 1.0)), 0.0) + np.where(
            b > 0, b * np.log2(np.where(b > 0, 2 * b / s, 1.0)), 0.0
        )
    return float(t.sum())


def sig2snr(rate: float, sig):
    """Noise stdev -> Eb/N0 in dB (common.cpp:88)."""
    return -10.0 * np.log10(2.0 * rate * np.square(np.asarray(sig, dtype=np.float64)))


def snr2sig(rate: float, snr):
    """Eb/N0 in dB -> noise stdev (common.cpp:92)."""
    return 10.0 ** (-np.asarray(snr, dtype=np.float64) / 20.0) / np.sqrt(2.0 * rate)


def rate_to_shannon_thr(R: float) -> float:
    """Max noise stdev at which rate R is below BIAWGN capacity proxy (common.cpp:152)."""
    return 1.0 / np.sqrt(2.0 ** (2.0 * R) - 1.0)


def shannon_thr_to_rate(sig: float) -> float:
    return 0.5 * np.log2(1.0 + 1.0 / sig**2)
