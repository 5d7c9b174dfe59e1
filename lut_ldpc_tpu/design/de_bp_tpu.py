"""Batched density evolution for BP on the accelerator: the SURVEY §2 parallelism
mapping for DE ("pmf updates as dense on-chip convolutions/reductions").

The host engine (de_bp.DEBp) is float64 and sequential over both DE
iterations and sigma points — exactly what the reference does
(/root/reference/src/LDPC_DE.cpp:617-1042) and what bit-exact threshold
numbers require.  Threshold *sweeps*, however, evaluate evolve() at many
noise levels, and those evaluations are independent: this module runs a
whole sigma grid in ONE jitted program, with

- VN updates as batched weighted rFFT convolutions over the (S, grid)
  pmf block (dense math),
- CN box-plus combinations as banded static-table gathers +
  segment-sums (the tq/tq2 tables are host-precomputed constants shared
  across the batch),
- the per-point exit conditions (Pe < Pe_max, non-improving-iteration
  budget) carried as masks in a lax.while_loop that stops when every
  point has decided.

Device arithmetic is float32, so a grid evaluation locates the threshold to
~1e-3 in sigma rather than the 1e-6 the f64 host bisection resolves.
threshold() therefore runs coarse-to-fine f32 grid rounds on the
accelerator and (optionally) hands the final bracket to the host f64
engine — sweeps get accelerator throughput, published numbers keep host
precision.  On the CPU backend the same code runs in f32 as well, which
tests exploit to validate against DEBp within f32 tolerance.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .de_bp import DEBp

__all__ = ["DEBpTPU"]


class DEBpTPU:
    """Batched-evolve DE-BP engine.

    Wraps a host DEBp for tables/grids; evolve_batch(sigmas) evaluates
    the whole batch on the default JAX device in one jit.
    """

    def __init__(self, ens, Nb: int = 10, Lmax: float = 25.0,
                 maxiter_de: int = 1000, Pe_max: float = 1e-6,
                 max_ni_de_iters: int = 1):
        self.host = DEBp(ens, Nb=Nb, Lmax=Lmax)
        self.ens = ens
        self.maxiter_de = int(maxiter_de)
        # f32 floor: below ~1e-7 the pmf tails are rounding noise, so a
        # tighter Pe target than 1e-6 cannot be certified in f32
        self.Pe_max = max(float(Pe_max), 1e-6)
        self.max_ni_de_iters = int(max_ni_de_iters)
        h = self.host
        self.N = h.N
        self.delta = h.delta
        self.Nfft = h.Nfft
        self.K = h.K
        # static tables (host f64 -> device constants)
        self._tq = jnp.asarray(h.tq)
        self._tq2 = jnp.asarray(h.tq2)
        self._w = jnp.asarray(h.var_conv_weight, jnp.float32)
        # banded scatter pattern for the CN combine: contributions at
        # (i, k) accumulate into bin i-k; k runs 0..K with k <= i
        N, K = self.N, self.K
        ii = np.arange(N + 1)[:, None]
        kk = np.arange(K + 1)[None, :]
        self._band_tgt = jnp.asarray(np.where(kk <= ii, ii - kk, N + 1))
        self._band_mask = jnp.asarray((kk <= ii).astype(np.float32))
        self._evolve = jax.jit(self._build_evolve())

    # ------------------------------------------------------------------
    def _build_evolve(self):
        N, K = self.N, self.K
        Nfft = self.Nfft
        w = self._w
        tq, tq2 = self._tq, self._tq2
        band_tgt, band_mask = self._band_tgt, self._band_mask
        ens = self.ens
        Pe_max = self.Pe_max
        max_ni = self.max_ni_de_iters
        maxiter = self.maxiter_de

        def pmf_plus(pmf):  # (S, 2N+2) -> (S, N+2)
            return jnp.concatenate(
                [pmf[:, N:N + 1],
                 pmf[:, N + 1:2 * N + 1] + pmf[:, :N][:, ::-1],
                 pmf[:, 2 * N + 1:]], axis=1)

        def pmf_minus(pmf):
            return jnp.concatenate(
                [jnp.zeros_like(pmf[:, :1]),
                 pmf[:, N + 1:2 * N + 1] - pmf[:, :N][:, ::-1],
                 pmf[:, 2 * N + 1:]], axis=1)

        def pmf_orig(p, m):
            return jnp.concatenate(
                [(0.5 * (p[:, 1:N + 1] - m[:, 1:N + 1]))[:, ::-1],
                 p[:, :1],
                 0.5 * (p[:, 1:N + 2] + m[:, 1:N + 2])], axis=1)

        def var_conv(pmf_in, pmf_out):  # both (S, 2N+2)
            a = w * pmf_in[:, :2 * N + 1]
            b = w * pmf_out[:, :2 * N + 1]
            conv = jnp.fft.irfft(
                jnp.fft.rfft(a, Nfft, axis=1) * jnp.fft.rfft(b, Nfft, axis=1),
                Nfft, axis=1)
            out = conv[:, N:3 * N + 1] / w
            inf = 1.0 - out.sum(axis=1, keepdims=True)
            return jnp.concatenate([out, inf], axis=1)

        def suffix(v):  # (S, N+2) -> (S, N+3)
            fin = v[:, :N + 1]
            s = fin.sum(axis=1, keepdims=True)
            base = jnp.concatenate(
                [s, s - jnp.cumsum(fin[:, :N], axis=1)], axis=1) + v[:, N + 1:]
            return jnp.concatenate([base, jnp.zeros_like(s)], axis=1)

        def chk_conv(a_p, a_m, b_p, b_m):
            Ap, Am, Bp, Bm = suffix(a_p), suffix(a_m), suffix(b_p), suffix(b_m)

            def combine(x, X_self, Y_other):
                # x: (S, N+2) pmf of this operand; Y_other: (S, N+3)
                # suffix-cdf of the other; gathers over the static band
                hi = Y_other[:, tq[:N + 1, 1:K + 2]]   # (S, N+1, K+1)
                lo = Y_other[:, tq[:N + 1, 0:K + 1]]
                return x[:, :N + 1, None] * (hi - lo)

            def combine2(x, Y_other):
                hi = Y_other[:, tq2[:N + 1, 1:K + 2]]
                lo = Y_other[:, tq2[:N + 1, 0:K + 1]]
                return x[:, :N + 1, None] * (hi - lo)

            contrib_p = (combine(a_p, Ap, Bp) + combine2(b_p, Ap)) * band_mask
            contrib_m = (combine(a_m, Am, Bm) + combine2(b_m, Am)) * band_mask
            tgt = band_tgt.reshape(-1)

            def scatter(contrib):
                flat = contrib.reshape(contrib.shape[0], -1)
                c = jnp.zeros((contrib.shape[0], N + 2), contrib.dtype)
                return c.at[:, tgt].add(flat)

            c_p = scatter(contrib_p)
            c_m = scatter(contrib_m)
            inf = (a_p[:, N + 1] * b_p[:, N + 1])[:, None]
            c_p = jnp.concatenate([c_p[:, :N + 1], inf], axis=1)
            c_m = jnp.concatenate([c_m[:, :N + 1], inf], axis=1)
            return c_p, c_m

        order_c = np.argsort(ens.degree_rho)
        dc_vec = [int(d) for d in ens.degree_rho[order_c]]
        rho = [float(x) for x in ens.rho[order_c]]
        order_v = np.argsort(ens.degree_lam)
        dv_vec = [int(d) for d in ens.degree_lam[order_v]]
        lam = [float(x) for x in ens.lam[order_v]]

        def chk_update_irr(pmf_var2chk):
            out = jnp.zeros_like(pmf_var2chk)
            p_in_p = pmf_plus(pmf_var2chk)
            p_in_m = pmf_minus(pmf_var2chk)
            out_p, out_m = p_in_p, p_in_m
            dc_tmp = 2
            for dc, wgt in zip(dc_vec, rho):
                for _ in range(dc - dc_tmp):
                    out_p, out_m = chk_conv(p_in_p, p_in_m, out_p, out_m)
                dc_tmp = max(dc_tmp, dc)
                out = out + wgt * pmf_orig(out_p, out_m)
            return out

        def var_update_irr(pmf_LLR, pmf_chk2var):
            out = jnp.zeros_like(pmf_LLR)
            pmf_tmp = pmf_LLR
            dv_tmp = 1
            for dv, wgt in zip(dv_vec, lam):
                for _ in range(dv - dv_tmp):
                    pmf_tmp = var_conv(pmf_chk2var, pmf_tmp)
                dv_tmp = max(dv_tmp, dv)
                out = out + wgt * pmf_tmp
            return out

        def pe_of(pmf):
            return pmf[:, :N].sum(axis=1) + 0.5 * pmf[:, N]

        def evolve(pmf_LLR):
            S = pmf_LLR.shape[0]

            def cond(carry):
                it, _, done, _, _ = carry
                return (it < maxiter) & ~done.all()

            def body(carry):
                it, v2c, done, Pe_old, ni = carry
                c2v = chk_update_irr(v2c)
                v2c_new = var_update_irr(pmf_LLR, c2v)
                Pe = pe_of(v2c_new)
                conv = Pe < Pe_max
                worse = Pe >= Pe_old
                ni = jnp.where(~done & worse, ni + 1, ni)
                fail = ni >= max_ni
                done_new = done | conv | fail
                v2c = jnp.where(done[:, None], v2c, v2c_new)
                Pe_old = jnp.where(done | worse, Pe_old, Pe)
                return it + 1, v2c, done_new, Pe_old, ni

            done0 = jnp.zeros((S,), bool)
            Pe0 = jnp.ones((S,), jnp.float32)
            ni0 = jnp.zeros((S,), jnp.int32)
            it, v2c, done, _, ni = jax.lax.while_loop(
                cond, body, (0, pmf_LLR, done0, Pe0, ni0))
            Pe = pe_of(v2c)
            achieved = Pe < Pe_max
            return achieved, Pe, it

        return evolve

    # ------------------------------------------------------------------
    def evolve_batch(self, sigmas) -> tuple[np.ndarray, np.ndarray]:
        """(converged mask, final Pe) for each sigma, one jitted program."""
        from ..ops.pmf import get_gaussian_pmf

        N = self.N
        pmfs = np.stack([
            np.concatenate([
                get_gaussian_pmf(2 / s**2, 2 / s, 2 * N + 1, self.delta),
                [0.0],
            ]) for s in np.asarray(sigmas, dtype=np.float64)
        ]).astype(np.float32)
        ach, Pe, _ = self._evolve(jnp.asarray(pmfs))
        return np.asarray(ach), np.asarray(Pe)

    def threshold(self, points: int = 17, rounds: int = 3,
                  refine_host: bool = False) -> float:
        """Coarse-to-fine batched grid search for the noise threshold.

        Each round evaluates `points` sigmas across the bracket in one
        program and narrows the bracket to the last-converged /
        first-diverged pair; ~log_points precision per round vs one bit
        per evolve for scalar bisection.  refine_host finishes with the
        f64 host engine inside the final bracket."""
        lo, hi = self.host.thr_min, self.host.thr_max
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
            self.host.set_bisec_window(lo, hi)
            _, thr = self.host.bisec_search()
            return thr if thr > 0 else lo
        return lo
