"""lut_ldpc_tpu: design and evaluation of finite-alphabet (lookup-table)
message-passing LDPC decoders in JAX.

Layers (bottom to top):

- `ops`: symmetric-pmf algebra and the MI-optimal quantizer DP (the LUT
  designer), host-side float64 with native C++ kernels;
- `core`: ensembles (.ens), alist I/O, GF(2) linear algebra, Tanner-graph
  layouts, LUT trees, PEG code construction;
- `design`: density evolution engines (LUT + BP), tree-template factory,
  threshold bisection, reuse optimization, stability functionals;
- `decoder`: the designed codec artifact and four interchangeable,
  bit-identical decoder implementations (scalar golden, unrolled table,
  scan table, arithmetic value-domain) plus float BP baselines and staged
  decoding;
- `sim`: Monte-Carlo BER/FER harness with the reference's INI config
  surface, counters, early-exit policy, .npz/.it results, analysis;
- `parallel`: SPMD data parallelism over a jax device mesh;
- `cli`: ber_sim, de_sim, reuse_vec_opt, peg_gen, alist2ens, ens2deg,
  dat2alist;
- `utils`: IT++ .it binary file interop.
"""

__version__ = "0.2.0"

from .utils.compile_cache import enable_compilation_cache as _enable_cc

_enable_cc()
del _enable_cc
