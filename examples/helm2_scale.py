"""Large-N Helmholtz butterfly: setup cost, device apply, GMRES solve.

Reference parity with the multiple-scattering collector grid
(examples/multiple_scattering/collect_multiple_scattering_data.py:10-13,
k in logspace up to 250k points): factorize the 2D Helmholtz combined-field
operator on an ellipse at n up to 65536 with points-per-wavelength held
fixed (k grows with n), run the compressed apply on the device through the
partition cell plan, check rel err against a row-sampled dense
oracle (utils/oracle.py — no dense operator exists at these sizes), and
solve the second-kind BIE with the device-resident GMRES driver
(ops/linalg.py solve_gmres_plan: Krylov basis on chip, host sees only one
Hessenberg column per iteration), so solve wall time ~= iters x apply.

Usage:
  python examples/helm2_scale.py --sizes 4096 16384 65536 --out helm2_scale.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_one(n: int, ppw: float, leaf: int, queries: int = 64):
    """Factorize, plan, apply, check and solve one size; returns a record
    of set-up times, apply time, accuracy and the GMRES result."""
    import jax
    import jax.numpy as jnp

    from butterfly_tpu.fac import helm2 as fac_helm2
    from butterfly_tpu.fac.partition import partition_apply_plan
    from butterfly_tpu.geom import Ellipse
    from butterfly_tpu.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu.ops.linalg import solve_gmres_plan
    from butterfly_tpu.trees import Quadtree
    from butterfly_tpu.utils.oracle import row_oracle_rel_err
    from butterfly_tpu.utils.profiling import time_call

    ell = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, _, Nrm, w = ell.sample_linspaced(n)
    perimeter = float(np.sum(w))
    k = 2 * np.pi * n / (ppw * perimeter)
    # exterior-Dirichlet combined field D - i*k*S: resonance-free, so
    # GMRES converges at every wavenumber (S'-alone stalls near interior
    # resonances)
    helm = Helm2(k=k, layer_pot=LayerPot.COMBINED_FIELD,
                 alpha=-1j * k, beta=1.0)
    rec = {"n": n, "k": k, "ppw": ppw}
    log(f"n={n}: k={k:.1f} (ppw={ppw})")

    t0 = time.perf_counter()
    tree = Quadtree(X, leaf_size=leaf, normals=Nrm)
    A = fac_helm2.make_multilevel(helm, tree, tree)
    rec["setup_fac_s"] = time.perf_counter() - t0
    log(f"  fac setup: {rec['setup_fac_s']:.1f} s")

    t0 = time.perf_counter()
    plan = partition_apply_plan(A)
    rec["setup_plan_s"] = time.perf_counter() - t0
    rec["weight_bytes"] = plan.nbytes()
    rec["compression_ratio"] = plan.nbytes() / (n * n * 16)
    rec["num_mega_blocks"] = len(plan._mega)
    rec["mega_streamed_bytes"] = plan.mega_streamed_bytes
    log(f"  plan: {rec['setup_plan_s']:.1f} s, "
        f"{plan.nbytes() / 1e6:.1f} MB "
        f"({rec['compression_ratio']:.4f} of dense c128)")

    # ---- device apply ----------------------------------------------------
    r = queries
    x0 = jax.random.normal(jax.random.key(0), (2 * n, r), jnp.float32)
    per = time_call(plan.apply_device, x0)
    rec["apply_r"] = r
    rec["apply_ms"] = per * 1e3
    rec["apply_tflops"] = plan.flops_per_col() * r / per / 1e12
    log(f"  apply r={r}: {per * 1e3:.3f} ms -> "
        f"{rec['apply_tflops']:.2f} TFLOP/s")

    # ---- accuracy vs row-sampled dense oracle ---------------------------
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    got = plan.apply_complex(zs)
    Xp, Np = X[tree.perm], Nrm[tree.perm]

    def exact_rows(rows):
        Kd = helm.kernel_matrix(Xp, Xp[rows], Np, None)
        return Kd @ zs

    rel, _ = row_oracle_rel_err(got, exact_rows, n, num_rows=128)
    rec["rel_err_vs_dense"] = rel
    log(f"  rel err vs dense (128-row oracle): {rel:.3e}")

    # ---- GMRES on the second-kind BIE (device-resident driver) ----------
    # system: (I/2 + (D - ikS)_w) sigma = u_inc of an interior source —
    # the combined-field analogue of the reference flagship example
    # (examples/simple/helm2_bie.c:162-175), solved in the interleaved
    # real embedding with vectors on the device throughout.
    x_src = np.array([[0.1, -0.05]])
    rhs = Helm2(k=k, layer_pot=LayerPot.SINGLE).kernel_matrix(x_src, Xp)[:, 0]
    wp2 = jnp.asarray(np.repeat(w[tree.perm], 2), jnp.float32)
    b2 = np.empty(2 * n, np.float32)
    b2[0::2], b2[1::2] = rhs.real, rhs.imag

    post = jax.jit(lambda v, y: 0.5 * v + y[:, 0])
    weigh = jax.jit(lambda v: (v * wp2)[:, None])

    def sys_apply(v):
        return post(v, plan.apply_device(weigh(v)))

    jax.block_until_ready(sys_apply(jnp.asarray(b2)))  # compile at r=1
    t0 = time.perf_counter()
    res = solve_gmres_plan(sys_apply, jnp.asarray(b2), tol=3e-7,
                           restart=80, max_iter=300)
    jax.block_until_ready(res.x)
    rec["gmres_s"] = time.perf_counter() - t0
    rec["gmres_iters"] = int(res.num_iter)
    rec["gmres_rel_res"] = float(res.residuals[-1])
    rec["gmres_converged"] = bool(res.converged)
    log(f"  GMRES: {res.num_iter} iters, rel res "
        f"{res.residuals[-1]:.2e}, {rec['gmres_s']:.3f} s")
    dev = jax.devices()[0]
    rec["device"] = dev.device_kind
    rec["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[16384, 65536])
    ap.add_argument("--ppw", type=float, default=64.0)
    ap.add_argument("--leaf", type=int, default=64)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    rows = []
    for n in args.sizes:
        rows.append(run_one(n, args.ppw, args.leaf, queries=args.queries))
        print(json.dumps(rows[-1]), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
