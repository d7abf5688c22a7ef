"""Device-resident apply of a hierarchical-LU factorization.

The reference's fast-direct-solver SOLVE walks the recursive node tree on
the host, one BLAS call per block (fast_direct_solver.py:752-762). Our
builder (fac/solver.py) is rightly host-f64 — factorization is setup time —
but the AMORTIZED path (many right-hand sides through one factorization)
wants the substitution's GEMMs on the device.

`DeviceSolver` compiles a `FastDirectSolver` into one jitted program:

- leaf `_DenseLU` nodes become explicit inverses (computed once from the
  stored LU, host f64, shipped f32) applied as dense GEMMs — batched small
  triangular solves are slow next to GEMMs, and an explicit inverse of a
  well-conditioned <=base_size block is benign;
- each node's compressed off-diagonal operators A21/A12 (middle-out
  butterfly Products or Dense, fac/middle_out.py) are packed once into
  StagePlans (ops/packed.py) and applied on device;
- the recursion UNROLLS AT TRACE TIME (the node tree is static), so the
  whole forward/backward substitution is one XLA program.

Device f32 caps a single pass at ~1e-6; `solve_refined` wraps the device
solve in classical mixed-precision iterative refinement — host-f64
residual, device-f32 correction — converging to f64-level residuals in
2-3 passes (each pass costs one operator apply + one device solve).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from butterfly_tpu.fac.solver import FastDirectSolver, _DenseLU
from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = ["DeviceSolver"]


class DeviceSolver:
    def __init__(self, fds: FastDirectSolver, block_align: int = 32):
        import jax
        import jax.numpy as jnp

        from butterfly_tpu.ops.packed import pack

        self.shape = fds.shape
        hp = jax.lax.Precision.HIGHEST

        def build(node):
            if isinstance(node, _DenseLU):
                n = node._lu[0].shape[0]
                inv = sla.lu_solve(node._lu, np.eye(n))
                check(not np.iscomplexobj(inv),
                      "DeviceSolver is real-only for now (embed complex "
                      "systems first)", InvalidArgumentsError)
                return ("leaf",), jnp.asarray(inv, jnp.float32)
            # solver nodes may hold _SampledOp wrappers (thin build-time
            # cache around the stored LinOp) — pack the stored operator
            op21 = getattr(node.A21, "op", node.A21)
            op12 = getattr(node.A12, "op", node.A12)
            a21 = pack(op21, dtype=np.float32, block_align=block_align)
            a12 = pack(op12, dtype=np.float32, block_align=block_align)
            m1, p1 = build(node.lu1)
            m2, p2 = build(node.lu2)
            meta = ("node", node.m, a21, a12, m1, m2)
            return meta, (a21._params, a12._params, p1, p2)

        self._meta, self._params = build(fds._root)

        def solve_dev(meta, params, b):
            if meta[0] == "leaf":
                return jnp.einsum("mk,kr->mr", params, b, precision=hp)
            _, m, a21, a12, m1, m2 = meta
            p21, p12, p1, p2 = params
            x1t = solve_dev(m1, p1, b[:m])
            x2 = solve_dev(m2, p2, b[m:] - a21._apply_jit(p21, x1t))
            x1 = x1t - solve_dev(m1, p1, a12._apply_jit(p12, x2))
            return jnp.concatenate([x1, x2], axis=0)

        self._solve_jit = jax.jit(
            lambda params, b: solve_dev(self._meta, params, b))
        self._jnp = jnp

    def solve(self, b):
        """One f32 device substitution pass: (n,) or (n, r)."""
        jnp = self._jnp
        b = jnp.asarray(b, jnp.float32)
        was_vec = b.ndim == 1
        x = self._solve_jit(self._params, b[:, None] if was_vec else b)
        return x[:, 0] if was_vec else x

    def solve_refined(self, b, matmat, iters: int = 2):
        """Mixed-precision refinement: device-f32 solves, host-f64
        residuals through `matmat` (the ORIGINAL operator's apply).
        Returns a host f64 solution with f64-grade residual."""
        b = np.asarray(b, np.float64)
        x = np.asarray(self.solve(b.astype(np.float32)), np.float64)
        for _ in range(iters):
            r = b - matmat(x)
            x = x + np.asarray(
                self.solve(r.astype(np.float32)), np.float64)
        return x

    def nbytes(self) -> int:
        import jax

        return sum(
            w.nbytes for w in jax.tree_util.tree_leaves(self._params))
