"""Hierarchical-LU fast direct solver.

Parity with the reference prototype
(examples/fast_direct_solver/fast_direct_solver.py): factorize a
tree-ordered system once, then amortize many solves. Two modes:

- default: quadtree-ordered Helmholtz BIE system (dense input, moderate n) —
  accuracy vs dense LU.
- --operator: OPERATOR-FIRST at large n — the matrix never exists densely.
  A = alpha*I + Toeplitz(gaussian kernel) is reachable only through an
  FFT matvec + analytic small blocks; the solver compresses off-diagonals
  and reflectors by randomized multilevel butterfly sampling and keeps
  Schur complements lazy. Reports peak RSS vs the dense-A footprint
  (the o(N^2)-memory demonstration).

Usage:
  python examples/fast_direct_solver.py [--n 2048] [--k 25]
  python examples/fast_direct_solver.py --operator --n 16384
"""

import argparse
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_bie(args) -> None:
    from butterfly_tpu.fac.solver import FastDirectSolver
    from butterfly_tpu.geom import Ellipse
    from butterfly_tpu.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu.trees import Quadtree

    n, k = args.n, args.k
    X, T, N, w = Ellipse(1.0, 0.6, (0.0, 0.0), 0.2).sample_linspaced(n)
    helm = Helm2(k=k, layer_pot=LayerPot.PV_NORMAL_DERIV_SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=N)
    P = tree.perm
    A = (helm.kernel_matrix(X, X, None, N) * w[None, :] + 0.5 * np.eye(n))
    A = A[np.ix_(P, P)]

    t0 = time.time()
    fds = FastDirectSolver(A, base_size=args.base, tol=1e-12, rank=64)
    print(f"factorized in {time.time()-t0:.1f}s; storage "
          f"{fds.nbytes()/1e6:.1f} MB vs dense {A.nbytes/1e6:.1f} MB")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n) + 0j
    t0 = time.time()
    x = fds.solve(b)
    print(f"first solve {1e3*(time.time()-t0):.1f} ms, residual "
          f"{np.linalg.norm(A @ x - b)/np.linalg.norm(b):.2e}")
    t0 = time.time()
    for _ in range(20):
        fds.solve(b)
    print(f"amortized solve: {1e3*(time.time()-t0)/20:.1f} ms")


class ToeplitzKernelAccess:
    """A = alpha*I + K, K[i,j] = g(i - j + delta): rectangular Toeplitz with
    FFT matvec and analytic blocks — block access without ever forming A.
    `sub` returns a DIRECT sub-Toeplitz (shifted diagonal), so deep
    recursion levels apply at their own size rather than zero-embedding up
    to the top operator."""

    def __init__(self, m: int, n: int | None = None, alpha: float = 1.0,
                 sigma: float | None = None, delta: int = 0, _g=None):
        n = m if n is None else n
        self.m, self.n = m, n
        self.alpha = alpha
        self.delta = delta
        self.shape = (m, n)
        if _g is not None:
            self._g, self._sigma = _g, sigma
        else:
            if sigma is None:
                sigma = m / 16  # globally smooth: block ranks stay moderate
            self._sigma = sigma
            self._g = lambda d: np.exp(-(d / sigma) ** 2)
        # first column g(i + delta), i in [0, m); first row g(delta - j)
        L = m + n
        c = np.zeros(L)
        c[:m] = self._g(np.arange(m) + delta)
        c[m + 1 :] = self._g(delta - np.arange(n - 1, 0, -1))
        self._fc = np.fft.rfft(c)

    def matmat(self, X):
        X = np.asarray(X, dtype=np.float64)
        was1 = X.ndim == 1
        if was1:
            X = X[:, None]
        L = self.m + self.n
        Xp = np.zeros((L, X.shape[1]))
        Xp[: self.n] = X
        Y = np.fft.irfft(np.fft.rfft(Xp, axis=0) * self._fc[:, None], axis=0,
                         n=L)
        out = Y[: self.m]
        if self.alpha and self.delta == 0 and self.m == self.n:
            out = out + self.alpha * X
        elif self.alpha:
            # diagonal hits where i == j - delta within range
            jd = np.arange(self.n) + self.delta
            ok = (jd >= 0) & (jd < self.m)
            out[jd[ok]] += self.alpha * X[np.arange(self.n)[ok]]
        return out[:, 0] if was1 else out

    def rmatmat(self, X):
        # K^T is Toeplitz with g'(d) = g(-d): reuse via a flipped access
        if not hasattr(self, "_adj"):
            g = self._g
            self._adj = ToeplitzKernelAccess(
                self.n, self.m, alpha=self.alpha, sigma=self._sigma,
                delta=-self.delta, _g=lambda d: g(-d),
            )
        return self._adj.matmat(X)

    def block(self, i0, i1, j0, j1):
        i = np.arange(i0, i1)[:, None]
        j = np.arange(j0, j1)[None, :]
        B = self._g((i - j) + self.delta)
        if self.alpha:
            mask = (i - j) + self.delta == 0
            B = B + self.alpha * mask
        return B

    def sub(self, i0, i1, j0, j1):
        return ToeplitzKernelAccess(
            i1 - i0, j1 - j0, alpha=self.alpha, sigma=self._sigma,
            delta=self.delta + (i0 - j0), _g=self._g,
        )

    @property
    def dtype(self):
        return np.float64


def run_operator(args) -> None:
    from butterfly_tpu.fac.solver import FastDirectSolver

    n = args.n
    dense_mb = n * n * 8 / 1e6
    acc = ToeplitzKernelAccess(n)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024  # MB
    t0 = time.time()
    fds = FastDirectSolver(acc, base_size=max(args.base, 512), tol=1e-9,
                           rank=48)
    t_fac = time.time() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"operator-first factorization n={n}: {t_fac:.1f}s, storage "
          f"{fds.nbytes()/1e6:.1f} MB, max dense block "
          f"{fds.max_dense_block_entries*8/1e6:.1f} MB")
    print(f"peak RSS {rss1:.0f} MB (baseline {rss0:.0f} MB) vs dense A "
          f"{dense_mb:.0f} MB")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)
    t0 = time.time()
    x = fds.solve(b)
    t_solve = time.time() - t0
    res = np.linalg.norm(acc.matmat(x) - b) / np.linalg.norm(b)
    print(f"solve {1e3*t_solve:.1f} ms, residual {res:.2e}")
    assert res < 1e-8, "residual gate"
    assert rss1 - rss0 < dense_mb, "memory gate: must stay under dense-A"

    if args.device:
        # amortized device path (VERDICT r2 item 8): pack the node
        # operators once, run the substitution's GEMMs on the device for
        # batched right-hand sides, refine to f64-grade residuals
        import jax

        from butterfly_tpu.fac.device_solve import DeviceSolver
        from butterfly_tpu.utils.cache import enable_persistent_compile_cache

        enable_persistent_compile_cache()
        t0 = time.time()
        ds = DeviceSolver(fds)
        print(f"device pack: {time.time()-t0:.1f}s, {ds.nbytes()/1e6:.1f} MB")
        R = 64
        Bm = rng.standard_normal((n, R)).astype(np.float32)
        xb = jax.block_until_ready(ds.solve(Bm))  # compile + warm
        t0 = time.time()
        xb = jax.block_until_ready(ds.solve(Bm))
        t_amort = (time.time() - t0) / R
        xr = ds.solve_refined(b, matmat=acc.matmat, iters=2)
        res_d = np.linalg.norm(acc.matmat(xr) - b) / np.linalg.norm(b)
        print(f"device amortized solve {1e3*t_amort:.2f} ms/rhs "
              f"(batch {R}), refined residual {res_d:.2e}")
        assert res_d < 1e-8, "device refined residual gate"


def main() -> None:
    import jax

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=float, default=25.0)
    ap.add_argument("--base", type=int, default=256)
    ap.add_argument("--operator", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="also run the DeviceSolver amortized path (device)")
    args = ap.parse_args()
    if not args.device:  # host-math demos run on the f64 CPU backend
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    if args.operator:
        run_operator(args)
    else:
        run_bie(args)


if __name__ == "__main__":
    main()
