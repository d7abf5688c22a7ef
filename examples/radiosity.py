"""Radiosity: view-factor matrix assembly + radiosity solve on a mesh.

Parity with the reference example (examples/radiosity/radiosity.c): load a
mesh, assemble the CSR view-factor matrix via the midpoint rule
(src/mat_csr_real.c:387-440) with batched ray-traced visibility (the device
replacement for Embree, geom/visibility.py), then go further: solve the
radiosity equation (I - diag(rho) F) B = E with GMRES and report timings and
sparsity — the metrics the reference prints plus the solve it stops short of.

Usage: python examples/radiosity.py [--subdiv 3] [--occlusion] [--rho 0.3]
       python examples/radiosity.py --obj mesh.obj
"""

import argparse
import os
import sys

import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from butterfly_tpu.geom.trimesh import Trimesh, icosphere
    from butterfly_tpu.models.radiosity import RadiosityModel, view_factor_matrix

    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", type=str, default=None)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--rho", type=float, default=0.3)
    ap.add_argument("--occlusion", action="store_true",
                    help="ray-traced visibility culling (Embree analogue)")
    args = ap.parse_args()

    mesh = Trimesh.from_obj(args.obj) if args.obj else icosphere(args.subdiv)
    print(f"loaded mesh with {mesh.num_verts} verts and {mesh.num_faces} "
          f"faces")

    t0 = time.time()
    F = view_factor_matrix(mesh, occlusion=args.occlusion)
    dt = time.time() - t0
    nnz_frac = F.nnz / (F.shape[0] * F.shape[1])
    print(f"computed view factor matrix [{dt:.2f}s]: shape {F.shape}, "
          f"{F.nnz} nonzeros ({100 * nnz_frac:.1f}%)")

    # radiosity solve with a point emitter
    model = RadiosityModel(mesh, rho=args.rho, apply_F=F)
    E = np.zeros(mesh.num_faces)
    E[0] = 1.0
    t0 = time.time()
    B, iters = model.solve(E)
    print(f"radiosity GMRES solve: {iters} iterations [{time.time()-t0:.2f}s]")
    resid = B - (E + args.rho * (F @ B))
    print(f"fixed-point residual: {np.linalg.norm(resid):.3e}")
    print(f"total radiosity: {B.sum():.6f} (emitted {E.sum():.1f})")


if __name__ == "__main__":
    main()
