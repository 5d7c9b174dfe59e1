"""ber_sim CLI: INI-driven Monte-Carlo BER simulation.

Mirrors the reference's prog/ber_sim.cpp: -p/--params INI file, -s/--seed,
-b/--basedir, -c/--custom-name; the presence of a [LUT] vs [BP] section
selects the decoder family.  Extra device flags: --mesh N runs data-
parallel over the first N devices, --cpu forces the CPU backend.

Results land in <results_dir>/<prefix>_N..._R..._maxIter..._zcw..._frames...
as npz + JSON (schema of LDPC_BER_Sim.cpp:342-362).
"""

from __future__ import annotations

import argparse
import os
import sys


def gen_filename(cfg, nvar: int, rate: float, custom: str = "") -> str:
    """Results directory/file base name (LDPC_BER_Sim.cpp:104-115)."""
    max_iter = cfg.lut.max_iter if cfg.lut is not None else cfg.bp.max_iter
    name = (
        f"{cfg.sim.results_prefix}_N{nvar}_R{rate:g}_maxIter{max_iter}"
        f"_zcw{int(cfg.ldpc.zero_codeword)}_frames{cfg.sim.Nframes}"
    )
    if cfg.lut is not None and cfg.lut.min_lut:
        name += "_minLUT"
    return name + cfg.sim.custom_name + custom


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ber_sim", description=__doc__)
    ap.add_argument("-p", "--params", required=True, help="input parameter file (INI)")
    ap.add_argument("-s", "--seed", type=int, default=0, help="random seed")
    ap.add_argument("-b", "--basedir", default=os.getcwd(),
                    help="paths in params files are relative to this directory")
    ap.add_argument("-c", "--custom-name", default="",
                    help="append this string to the results file name")
    ap.add_argument("--mesh", type=int, default=0,
                    help="data-parallel over first N devices (0 = single device)")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from ..parallel import dp_mesh, multihost_init
    from ..sim import parse_ini, run_from_config

    multihost_init()
    cfg = parse_ini(args.params)
    mesh = dp_mesh(args.mesh) if args.mesh else None

    results, sim = run_from_config(
        cfg, codes_root=args.basedir, seed=args.seed, mesh=mesh
    )

    out_base = gen_filename(cfg, sim.graph.nvar, sim.rate, args.custom_name)
    out_dir = os.path.join(args.basedir, cfg.sim.results_dir, out_base)
    os.makedirs(out_dir, exist_ok=True)
    seed_eff = args.seed + cfg.sim.rand_seed_offset
    out_path = os.path.join(out_dir, f"{out_base}_rseed{seed_eff:04d}.npz")
    results.save(out_path)
    # also write the reference's .it schema for the MATLAB analysis scripts
    results.save_itfile(out_path.removesuffix(".npz") + ".it")
    # copy the params file next to the results (LDPC_BER_Sim.cpp:331-338)
    params_copy = os.path.join(out_dir, os.path.basename(args.params))
    if not os.path.exists(params_copy):
        import shutil

        shutil.copyfile(args.params, params_copy)
    print(f"Done simulating. Runtime = {results.runtime:.2f} seconds")
    print(f"Results written to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
