"""Device-resident eigenband solvers for the LBO pipeline.

The reference computes eigenbands with ARPACK shift-invert Lanczos, each
iteration an UMFPACK sparse solve on the host (src/linalg.c:472-1000).
SURVEY.md §2.3/§7.5 plans the device analogue: eigenbands produced on
the device and fed straight to the streaming factorizer without host
round-trips. This module provides it in two regimes:

- **dense path** (n <= `dense_cutoff`): one generalized eigendecomposition
  computed ON DEVICE — M-Cholesky reduction to a standard symmetric problem
  and `jnp.linalg.eigh` (the classic Wilkinson reduction; everything is one
  jitted call). Small meshes hit this path; it is exact to fp precision.

- **LOBPCG path** (large n): constrained, preconditioned, M-generalized
  block LOBPCG working directly on the pencil (L, M) with sparse BCOO
  matvecs — NO inner linear solves at all, unlike shift-invert Lanczos.
  Previously-converged eigenvectors enter as constraints (deflation), so a
  session walks the spectrum bottom-up band by band, exactly the access
  pattern of the LBO column tree (src/lbo.c:70-150: leaves are visited
  left-to-right in frequency order).

`DeviceEigSession` wraps both behind the access pattern
`next_band(lo, hi) -> (vals, vecs)` used by models/lbo.py.

Precision note: on the CPU backend (tests, x64 enabled) results match scipy
to ~1e-10. The device computes in f32 — fine for f32-tolerance
factorizations; keep the host scipy path for f64-certified setups.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from butterfly_tpu.utils.errors import InvalidArgumentsError, check
from butterfly_tpu.utils.logging import log_info

__all__ = ["DeviceEigSession", "dense_generalized_eigh_device",
           "lobpcg_generalized"]


def _to_dense_dev(A, dtype):
    import jax.numpy as jnp

    if sp.issparse(A):
        A = A.toarray()
    return jnp.asarray(np.asarray(A), dtype=dtype)


def _to_bcoo(A, dtype):
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    A = sp.coo_matrix(A)
    data = jnp.asarray(A.data, dtype=dtype)
    idx = jnp.asarray(np.stack([A.row, A.col], axis=1))
    return jsparse.BCOO((data, idx), shape=A.shape)


def dense_generalized_eigh_device(L, M, dtype=None):
    """All eigenpairs of L x = lam M x, computed on the device.

    Reduction: M = C C^T (Cholesky), A = C^{-1} L C^{-T} symmetric,
    eigh(A) -> lam, V; eigenvectors X = C^{-T} V are M-orthonormal.
    One jitted call; returns host numpy (vals ascending, vecs (n, n)).
    """
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import solve_triangular

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    Ld = _to_dense_dev(L, dtype)
    Md = _to_dense_dev(M, dtype)

    @jax.jit
    def solve(Ld, Md):
        C = jnp.linalg.cholesky(Md)
        # A = C^{-1} L C^{-T}
        T1 = solve_triangular(C, Ld, lower=True)
        A = solve_triangular(C, T1.T, lower=True).T
        A = 0.5 * (A + A.T)
        lam, V = jnp.linalg.eigh(A)
        X = solve_triangular(C.T, V, lower=False)
        return lam, X

    lam, X = solve(Ld, Md)
    return np.asarray(lam), np.asarray(X)


def _m_whiten(S, MS, delta):
    """M-whiten a (possibly near-dependent) block: eigendecompose the Gram
    G = S^T M S and scale by 1/sqrt(d) on the well-conditioned directions.
    Near-dependent directions (d <= delta*dmax) are NOT scaled up (their
    columns become ~zero) and are flagged in `good`; callers mask their
    Ritz values with a large penalty so they are never selected. This is
    the static-shape analogue of scipy lobpcg's drop-and-restart handling
    of basis breakdown — a jittered Cholesky here produces amplified-noise
    directions whose near-zero Rayleigh quotients pose as smallest
    eigenvalues (observed on the sphere pencil)."""
    import jax.numpy as jnp

    G = 0.5 * ((S.T @ MS) + (MS.T @ S))
    d, Q = jnp.linalg.eigh(G)
    dmax = jnp.maximum(d[-1], 1e-300)
    good = d > delta * dmax
    inv = jnp.where(good, 1.0 / jnp.sqrt(jnp.maximum(d, delta * dmax)), 0.0)
    W = Q * inv[None, :]
    return S @ W, MS @ W, good


def lobpcg_generalized(
    L_mv,
    M_mv,
    X0,
    Y=None,
    MY=None,
    precond=None,
    tol: float = 1e-9,
    maxit: int = 500,
):
    """Smallest-m eigenpairs of the SPD pencil (L, M) by constrained,
    preconditioned block LOBPCG with M-inner products.

    L_mv / M_mv: callables (n, k) -> (n, k) device matvecs (sparse or
    dense). X0 (n, m) initial block (device array). Y: (n, p) converged
    eigenvectors to deflate (M-orthonormal); the iteration keeps every basis
    vector M-orthogonal to span(Y), so the returned pairs are the next m up
    the spectrum. No inner solves anywhere — the device-native trade vs the
    reference's ARPACK+UMFPACK shift-invert (src/linalg.c:522-586).

    Returns (vals (m,), vecs (n, m), res (m,)) as host numpy, ascending.
    """
    import jax
    import jax.numpy as jnp

    X = jnp.asarray(X0)
    n, m = X.shape
    dtype = X.dtype
    delta = 1e-12 if dtype == jnp.float64 else 1e-6
    have_Y = Y is not None and Y.shape[1] > 0
    if have_Y:
        Y = jnp.asarray(Y)
        MY = M_mv(Y) if MY is None else jnp.asarray(MY)

    def deflate(V):
        if not have_Y:
            return V
        return V - Y @ (MY.T @ V)

    def masked_ritz(S, MS, good):
        """Rayleigh-Ritz on a whitened basis with bad directions penalized
        out of the smallest-m window."""
        AS = L_mv(S)
        Hs = 0.5 * ((S.T @ AS) + (AS.T @ S))
        penalty = 10.0 * (1.0 + jnp.max(jnp.abs(Hs)))
        Hs = Hs + jnp.diag(jnp.where(good, 0.0, penalty))
        return jnp.linalg.eigh(Hs)

    @jax.jit
    def step(X, P):
        Xd = deflate(X)
        X, MX, goodX = _m_whiten(Xd, M_mv(Xd), delta)
        ts, Cs = masked_ritz(X, MX, goodX)
        theta = ts[:m]
        X = X @ Cs[:, :m]
        MX = MX @ Cs[:, :m]
        AX = L_mv(X)
        R = AX - MX * theta[None, :]
        # normalize by the block's spectral scale, NOT per-column |theta|:
        # the LBO kernel mode has theta ~ 1e-13 and would never "converge"
        # under a per-column relative test
        scale = jnp.maximum(jnp.max(jnp.abs(theta)), 1e-300)
        rnorm = jnp.linalg.norm(R, axis=0) / scale
        W = R if precond is None else precond(R)
        W = deflate(W)
        S = jnp.concatenate([X, W, P], axis=1)
        S, MS, good = _m_whiten(S, M_mv(S), delta)
        ts, Cs = masked_ritz(S, MS, good)
        C = Cs[:, :m]
        Xn = S @ C
        # implicit P: the part of the new X outside the old X block
        Cp = C.at[:m, :].set(0.0)
        Pn = S @ Cp
        return Xn, Pn, ts[:m], rnorm

    key = jax.random.key(17)
    P = deflate(jax.random.normal(key, X.shape, dtype=dtype))
    vals = None
    for it in range(maxit):
        X, P, vals, rnorm = step(X, P)
        r = float(jnp.max(rnorm))
        if r < tol:
            break
    # final Ritz cleanup + honest residuals for the returned pairs
    Xd = deflate(X)
    X, MX, goodX = _m_whiten(Xd, M_mv(Xd), delta)
    theta, Q = masked_ritz(X, MX, goodX)
    theta = theta[:m]
    X = X @ Q[:, :m]
    MX = MX @ Q[:, :m]
    R = L_mv(X) - MX * theta[None, :]
    scale = jnp.maximum(jnp.max(jnp.abs(theta)), 1e-300)
    res = np.asarray(jnp.linalg.norm(R, axis=0) / scale)
    return np.asarray(theta), np.asarray(X), res


class DeviceEigSession:
    """Bottom-up eigenband server over the pencil (L, M), device-resident.

    next_band(lo, hi) returns every eigenpair with lam in [lo, hi), in
    ascending order, computing lazily: bands must be requested left to
    right (the LBO column-tree order). Completeness certification: a band
    is complete when the session has converged eigenpairs strictly beyond
    `hi` (or the whole spectrum), mirroring the reference's bracket logic
    (getPairsCoveringInterval, src/linalg.c:818-899).
    """

    def __init__(self, L, M, dense_cutoff: int = 1024, dtype=None,
                 chunk: int = 32, tol: float = 1e-9, maxit: int = 500,
                 seed: int = 0):
        import jax
        import jax.numpy as jnp

        self.n = L.shape[0]
        check(L.shape == M.shape and L.shape[0] == L.shape[1],
              "L, M must be square and congruent", InvalidArgumentsError)
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self._dtype = dtype
        self._chunk = chunk
        self._tol = tol
        self._maxit = maxit
        self._rng = np.random.default_rng(seed)
        self._served = 0  # eigenpairs already handed out (left to right)

        if self.n <= dense_cutoff:
            vals, vecs = dense_generalized_eigh_device(L, M, dtype=dtype)
            self._vals, self._vecs = vals, vecs
            self._complete = True
            log_info("device eigs: dense path n=%d", self.n)
        else:
            import jax.numpy as jnp

            Ls = _to_bcoo(sp.csr_matrix(L), dtype)
            Ms = _to_bcoo(sp.csr_matrix(M), dtype)
            self._L_mv = lambda V: Ls @ V
            self._M_mv = lambda V: Ms @ V
            dL = np.maximum(np.asarray(sp.csr_matrix(L).diagonal()), 0.0)
            dL = dL + 1e-6 * max(dL.mean(), 1e-300)
            dinv = jnp.asarray(1.0 / dL, dtype=dtype)[:, None]
            self._precond = lambda R: R * dinv
            self._vals = np.empty(0)
            self._vecs = np.zeros((self.n, 0))
            self._complete = False
            log_info("device eigs: LOBPCG path n=%d chunk=%d", self.n, chunk)

    # -- internal ---------------------------------------------------------
    def _extend(self):
        """Converge (a prefix of) the next `chunk` eigenpairs above the
        current set. Only the contiguous converged prefix is accepted —
        the tail of a LOBPCG block always lags, and accepting it would
        poison the deflation space for every later band."""
        import jax.numpy as jnp

        m = min(self._chunk + 8, self.n - self._vals.size)
        if m <= 0:
            self._complete = True
            return
        X0 = jnp.asarray(
            self._rng.standard_normal((self.n, m)), dtype=self._dtype)
        Y = (jnp.asarray(self._vecs, dtype=self._dtype)
             if self._vals.size else None)
        vals, vecs, res = lobpcg_generalized(
            self._L_mv, self._M_mv, X0, Y=Y, precond=self._precond,
            tol=self._tol, maxit=self._maxit,
        )
        # residual acceptance: eigenvalue error is QUADRATIC in the
        # (spectral-scale-relative) residual for symmetric pencils, so
        # res <= 1e-6 certifies ~1e-12-relative eigenvalues; Jacobi-
        # preconditioned LOBPCG typically stagnates around 1e-7 here
        accept_tol = max(100 * self._tol, 1e-6)
        bad = np.flatnonzero(res > accept_tol)
        k = int(bad[0]) if bad.size else res.size
        if self._vals.size + k >= self.n:
            k = self.n - self._vals.size
        check(k > 0,
              f"device LOBPCG made no progress (res[0] {res[0]:.2e})")
        self._vals = np.concatenate([self._vals, vals[:k]])
        self._vecs = np.concatenate(
            [self._vecs, np.asarray(vecs)[:, :k]], axis=1)
        if self._vals.size >= self.n:
            self._complete = True

    # -- public -----------------------------------------------------------
    def next_band(self, lo: float, hi: float):
        """All eigenpairs with lam in [lo, hi); bands must be requested in
        ascending order (lo >= previous hi)."""
        while not self._complete and (
            self._vals.size == 0 or self._vals[-1] < hi
        ):
            self._extend()
        vals = self._vals
        i0 = self._served if not np.isfinite(lo) else int(
            np.searchsorted(vals, lo, side="left"))
        i0 = max(i0, self._served)
        i1 = vals.size if not np.isfinite(hi) else int(
            np.searchsorted(vals, hi, side="left"))
        check(i1 >= i0, "bands must be requested left to right",
              InvalidArgumentsError)
        self._served = i1
        return vals[i0:i1].copy(), self._vecs[:, i0:i1].copy()
