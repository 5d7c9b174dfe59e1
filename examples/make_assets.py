"""Generate the repo's data assets with the framework's own tools.

Creates ensembles/ (degree distributions), codes/ (PEG-constructed alist
parity matrices) and params/ (example INI configs) — the same asset
categories the reference ships, produced here by our ensemble writer and
native PEG generator rather than copied.

Run from the repo root:  python examples/make_assets.py [--big]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lut_ldpc_tpu.core.alist import write_alist
from lut_ldpc_tpu.core.ensemble import LDPCEnsemble
from lut_ldpc_tpu.core.peg import peg_code_from_ensemble


def graph_to_H(graph):
    return graph.to_dense()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true",
                    help="also build the N=10000 code (slower)")
    args = ap.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ens_dir = os.path.join(root, "ensembles")
    codes_dir = os.path.join(root, "codes")
    os.makedirs(ens_dir, exist_ok=True)
    os.makedirs(codes_dir, exist_ok=True)

    # --- ensembles ---------------------------------------------------------
    # regular (3,6), rate 1/2
    ens36 = LDPCEnsemble(np.array([3]), np.array([1.0]),
                         np.array([6]), np.array([1.0]))
    ens36.write(os.path.join(ens_dir, "rate0.50_dv03_dc06.ens"))

    # LUT-optimized irregular rate-1/2 ensemble, dv {2,3,9,17} / dc {8,9}:
    # the published degree distribution of the 4-bit min-LUT design point
    # (Meidlinger & Matz; the reference's worked example, DE threshold
    # sigma* = 0.929193)
    ens_irr = LDPCEnsemble(
        np.array([2, 3, 9, 17]),
        np.array([0.138045, 0.401038, 0.026586, 0.434331]),
        np.array([8, 9]),
        np.array([0.323376, 0.676624]),
    )
    ens_irr.write(os.path.join(ens_dir, "rate0.50_dv02-17_dc08-09_lut_q4.ens"))

    # 10GBase-T style regular (6,32), rate ~0.84
    ens1032 = LDPCEnsemble(np.array([6]), np.array([1.0]),
                           np.array([32]), np.array([1.0]))
    ens1032.write(os.path.join(ens_dir, "rate0.84_dv06_dc32.ens"))

    # Published BIAWGN-optimized irregular rate-1/2 ensembles (Richardson,
    # Shokrollahi & Urbanke 2001, tables II/III — the same distributions the
    # reference ships, ensembles/README.md), keyed by maximum VN degree.
    published = {
        "rate0.50_dv02-04_dc05-06.ens": (
            [2, 3, 4], [0.38354, 0.04237, 0.57409],
            [5, 6], [0.24123, 0.75877],
        ),
        "rate0.50_dv02-05_dc06-07.ens": (
            [2, 3, 4, 5], [0.32660, 0.11960, 0.18393, 0.36988],
            [6, 7], [0.78555, 0.21445],
        ),
        "rate0.50_dv02-08_dc06-07.ens": (
            [2, 3, 8], [0.30013, 0.28395, 0.41592],
            [6, 7], [0.22919, 0.77081],
        ),
        "rate0.50_dv02-11_dc07-08.ens": (
            [2, 3, 4, 11], [0.23882, 0.29515, 0.03261, 0.43342],
            [7, 8], [0.43011, 0.56989],
        ),
        "rate0.50_dv02-15_dc08-09.ens": (
            [2, 3, 4, 5, 7, 14, 15],
            [0.23802, 0.20997, 0.03492, 0.12015, 0.01587, 0.0048, 0.37627],
            [8, 9], [0.98013, 0.01987],
        ),
        "rate0.50_dv02-50_dc09-11.ens": (
            [2, 3, 4, 7, 8, 9, 10, 15, 30, 50],
            [0.17120, 0.21053, 0.00273, 0.00009, 0.15269, 0.09227,
             0.02802, 0.01206, 0.07212, 0.25830],
            [9, 10, 11], [0.3362, 0.08883, 0.57497],
        ),
        # LUT-q4-optimized distribution with max VN degree 8 (Meidlinger &
        # Matz; reference ensembles/rate0.50_dv02-08_dc07-08_lut_q4.ens)
        "rate0.50_dv02-08_dc07-08_lut_q4.ens": (
            [2, 3, 8], [0.163844, 0.40637, 0.429786],
            [7, 8], [0.591665, 0.408335],
        ),
    }
    for name, (dv, lam, dc, rho) in published.items():
        LDPCEnsemble(
            np.array(dv), np.array(lam), np.array(dc), np.array(rho)
        ).write(os.path.join(ens_dir, name))

    # --- DVB-S2 rate-1/2 N=64800 (the true standard matrix) ---------------
    # ETSI EN 302 307 defines this code; we import the parity matrix
    # shipped by the reference toolchain (codes/rate0.50_irreg_dvbs2_N64800
    # .alist) — it is standardized data, not designable — and round-trip it
    # through our Tanner-graph layer to validate and normalize the format.
    ref_dvbs2 = "/root/reference/codes/rate0.50_irreg_dvbs2_N64800.alist"
    out_dvbs2 = os.path.join(codes_dir, "rate0.50_irreg_dvbs2_N64800.alist")
    if os.path.exists(ref_dvbs2) and not os.path.exists(out_dvbs2):
        from lut_ldpc_tpu.core.alist import read_alist
        from lut_ldpc_tpu.core.tanner import TannerGraph

        print("importing DVB-S2 N=64800 standard matrix ...", flush=True)
        g = TannerGraph.from_dense(read_alist(ref_dvbs2))
        assert g.nvar == 64800 and g.nchk == 32400
        write_alist(out_dvbs2, g.to_dense())

    # --- quasi-cyclic codes (core/qc.py) ------------------------------------
    # girth-8 QC structures whose decode permutations are cyclic rolls; the
    # .qc.json stores the (Z, mb, nb, base-shift) grid, qc_expand() the graph
    from lut_ldpc_tpu.core.qc import (qc_expand, qc_generate_irregular,
                                      qc_generate_regular, save_qc)

    qc36 = os.path.join(codes_dir, "rate0.50_dv03_dc06_N10000_qc.qc.json")
    if not os.path.exists(qc36):
        print("QC: (3,6) N=10000 ...", flush=True)
        save_qc(qc36, qc_generate_regular(3, 6, Z=1000, nb=10, seed=1))
    qcirr = os.path.join(codes_dir,
                         "rate0.50_dv02-17_dc08-09_N64800_qc.qc.json")
    if not os.path.exists(qcirr):
        # Z=720, nb=90, mb=45: rate exactly 1/2; node-perspective degree
        # fractions quantize to [27, 52, 1, 10]/90 for dv {2, 3, 9, 17}
        # (vs the ensemble's [0.2985, 0.5782, 0.0128, 0.1105]) and the
        # check blocks to [16, 29]/45 for dc {8, 9} (vs [0.3497, 0.6503])
        print("QC: irregular dv02-17 N=64800 ...", flush=True)
        ens = LDPCEnsemble.read(
            os.path.join(ens_dir, "rate0.50_dv02-17_dc08-09_lut_q4.ens"))
        qc = qc_generate_irregular(ens, Z=720, nb=90, seed=3, mb=45)
        g = qc_expand(qc)
        assert g.nvar == 64800 and g.nchk == 32400
        save_qc(qcirr, qc)

    # --- PEG codes ---------------------------------------------------------
    ens_15 = LDPCEnsemble(
        np.array(published["rate0.50_dv02-15_dc08-09.ens"][0]),
        np.array(published["rate0.50_dv02-15_dc08-09.ens"][1]),
        np.array(published["rate0.50_dv02-15_dc08-09.ens"][2]),
        np.array(published["rate0.50_dv02-15_dc08-09.ens"][3]),
    )
    jobs = [
        (ens36, 500, 1000, "rate0.50_dv03_dc06_N1000.alist"),
        (ens_irr, 250, 500, "rate0.50_dv02-17_dc08-09_lut_q4_N500.alist"),
        (ens1032, 384, 2048, "rate0.84_reg_v6c32_N2048.alist"),
        (ens_irr, 500, 1000, "rate0.50_dv02-17_dc08-09_lut_q4_N1000.alist"),
    ]
    ens_dv08 = LDPCEnsemble(
        np.array(published["rate0.50_dv02-08_dc07-08_lut_q4.ens"][0]),
        np.array(published["rate0.50_dv02-08_dc07-08_lut_q4.ens"][1]),
        np.array(published["rate0.50_dv02-08_dc07-08_lut_q4.ens"][2]),
        np.array(published["rate0.50_dv02-08_dc07-08_lut_q4.ens"][3]),
    )
    if args.big:
        jobs.append((ens36, 5000, 10000, "rate0.50_dv03_dc06_N10000.alist"))
        jobs.append((ens_15, 5000, 10000, "rate0.50_dv02-15_dc08-09_N10000.alist"))
        jobs.append((ens_irr, 5000, 10000,
                     "rate0.50_dv02-17_dc08-09_lut_q4_N10000.alist"))
        # the reference's second shipped N=64800 LUT design point
        # (/root/reference/codes/README.md: rate0.50_dv02-08_dc07-08_
        # lut_q4_N64800.alist); ~2 h of PEG
        jobs.append((ens_dv08, 32400, 64800,
                     "rate0.50_dv02-08_dc07-08_lut_q4_N64800.alist"))
    for ens, M, N, name in jobs:
        if os.path.exists(os.path.join(codes_dir, name)):
            print(f"PEG: {name} exists, skipping", flush=True)
            continue
        print(f"PEG: {name} ...", flush=True)
        graph, lg = peg_code_from_ensemble(ens, M, N, seed=20260817)
        write_alist(os.path.join(codes_dir, name), graph_to_H(graph))
        finite = lg[lg > 0]
        print(f"  N={N} M={M} edges={graph.num_edges} "
              f"girth={'inf' if not len(finite) else int(finite.min())}")

    # --- rendered tree example (reference trees/example.{tikz,png}) --------
    if not os.path.exists(os.path.join(root, "trees", "example.tikz")):
        import subprocess

        subprocess.run([sys.executable, os.path.join(
            root, "examples", "render_tree_example.py")], check=True)

    print("Assets written to ensembles/ and codes/")


if __name__ == "__main__":
    main()
