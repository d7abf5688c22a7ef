"""Iterative numerics: GMRES, extreme/interior eigenvalues, eigenbands.

Replacement for the reference's L3 layer (src/linalg.c):
- `solve_gmres`       <- bfSolveGMRES (src/linalg.c:47-317): left-
                         preconditioned restarted GMRES with modified
                         Gram-Schmidt and Givens-rotation least squares,
                         operating on ANY apply callable (LinOp, StagePlan,
                         UniformButterfly, FMM, ...).
- `get_max_eigenvalue`<- bfGetMaxEigenvalue (src/linalg.c:328-470): largest
                         generalized eigenvalue of (L, M).
- `get_shifted_eigs`  <- bfGetShiftedEigs (src/linalc.c:472-746): k
                         eigenpairs nearest a shift sigma.
- `get_eigenband`     <- bfGetEigenband (src/linalg.c:748-1000): all
                         eigenpairs with lambda in [lam0, lam1], via the
                         DOUBLING or COVERING strategy.

The eigensolvers run at setup time on the host and use scipy's
Lanczos/shift-invert (scipy *is* ARPACK + sparse LU, i.e. the same numerics
the reference reaches through C bindings); the apply-time hot path on the device
never calls them. SURVEY.md §2.3 explicitly sanctions host-side solves for
setup-time work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from butterfly_tpu.utils.errors import InvalidArgumentsError, check
from butterfly_tpu.utils.logging import log_debug, log_info

__all__ = [
    "GmresResult",
    "solve_gmres",
    "solve_gmres_plan",
    "get_max_eigenvalue",
    "get_shifted_eigs",
    "get_eigenband",
]


@dataclasses.dataclass
class GmresResult:
    x: np.ndarray
    num_iter: int
    residuals: list[float]
    converged: bool


def _as_matvec(A) -> Callable[[np.ndarray], np.ndarray]:
    if callable(A) and not hasattr(A, "matvec"):
        return A
    if hasattr(A, "matvec"):
        return lambda v: np.asarray(A.matvec(v))
    return lambda v: np.asarray(A @ v)


def _as_matop(A) -> Callable[[np.ndarray], np.ndarray]:
    """(n, k) -> (m, k) apply for arrays, LinOps, plans, or callables.

    Plain callables keep their historical PER-VECTOR contract (they are
    applied column by column); pass an object with `.matmat` (LinOp,
    StagePlan, ndarray) to get genuinely batched multi-RHS applies."""
    if hasattr(A, "matmat"):
        return lambda V: np.asarray(A.matmat(V))
    if callable(A) and not hasattr(A, "matvec"):
        def apply(V):
            cols = [np.asarray(A(V[:, j])) for j in range(V.shape[1])]
            return np.stack(cols, axis=1)

        return apply
    if hasattr(A, "matvec"):
        def apply_mv(V):
            cols = [np.asarray(A.matvec(V[:, j])) for j in range(V.shape[1])]
            return np.stack(cols, axis=1)

        return apply_mv
    return lambda V: np.asarray(A @ V)


def _gmres_cycle(matop, prec, X, B, m, tol, bnorm):
    """One batched restart cycle of length m on all RHS columns.

    Returns (X_new, residual_history, converged_mask). Batched over the k
    columns: V (m+1, n, k), H (m+1, m, k); converged columns keep iterating
    harmlessly behind division guards."""
    n, k = B.shape
    R = prec(B - matop(X))
    beta = np.linalg.norm(R, axis=0)  # (k,)
    dtype = np.result_type(B.dtype, R.dtype, np.float64)
    V = np.zeros((m + 1, n, k), dtype=dtype)
    H = np.zeros((m + 1, m, k), dtype=dtype)
    cs = np.zeros((m, k), dtype=dtype)
    sn = np.zeros((m, k), dtype=dtype)
    g = np.zeros((m + 1, k), dtype=dtype)
    safe_beta = np.where(beta > 0, beta, 1.0)
    V[0] = R / safe_beta
    g[0] = beta
    history = [np.abs(beta) / bnorm]
    j_used = 0
    for j in range(m):
        W = prec(matop(V[j]))
        # batched modified Gram-Schmidt (reference: src/linalg.c:154-193)
        for i in range(j + 1):
            hij = np.einsum("nk,nk->k", np.conj(V[i]), W)
            H[i, j] = hij
            W = W - hij[None, :] * V[i]
        h = np.linalg.norm(W, axis=0)
        H[j + 1, j] = h
        V[j + 1] = np.where(h > 0, W / np.where(h > 0, h, 1.0), 0.0)
        # accumulated Givens rotations on the new column
        for i in range(j):
            t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
            H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
            H[i, j] = t
        a, bb = H[j, j], H[j + 1, j]
        denom = np.sqrt(np.abs(a) ** 2 + np.abs(bb) ** 2)
        safe_d = np.where(denom > 0, denom, 1.0)
        phase = np.where(np.abs(a) > 0, a / np.where(np.abs(a) > 0, np.abs(a), 1.0), 1.0)
        cs[j] = np.where(denom > 0, np.abs(a) / safe_d, 1.0)
        sn[j] = np.where(denom > 0, phase * np.conj(bb) / safe_d, 0.0)
        H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
        H[j + 1, j] = 0.0
        g[j + 1] = -np.conj(sn[j]) * g[j]
        g[j] = cs[j] * g[j]
        res = np.abs(g[j + 1]) / bnorm
        history.append(res)
        j_used = j + 1
        if np.all(res < tol):
            break
    # batched back substitution
    j = j_used
    y = np.zeros((j, k), dtype=dtype)
    for i in range(j - 1, -1, -1):
        num = g[i] - np.einsum("mk,mk->k", H[i, i + 1 : j], y[i + 1 :])
        y[i] = num / np.where(np.abs(H[i, i]) > 0, H[i, i], 1.0)
    X = X + np.einsum("mnk,mk->nk", V[:j], y)
    return X, history, history[-1] < tol


def solve_gmres(
    A,
    b: np.ndarray,
    tol: float = 1e-10,
    max_iter: int | None = None,
    M=None,
    x0: np.ndarray | None = None,
    restart: int | None = None,
) -> GmresResult:
    """Left-preconditioned restarted GMRES with modified Gram-Schmidt +
    Givens least-squares, MULTI-RHS (reference: bfSolveGMRES,
    src/linalg.c:47-317). All RHS columns iterate together as batched
    vector ops — one matop per iteration regardless of k.

    A and M may be LinOps, packed plans, arrays, or callables. b may be
    (n,) or (n, k). `restart` enables GMRES(m) cycles (default: one full
    cycle of max_iter steps, the reference's behavior).
    """
    matop = _as_matop(A)
    prec = _as_matop(M) if M is not None else (lambda V: V)
    b = np.asarray(b)
    was_vec = b.ndim == 1
    B = b[:, None] if was_vec else b
    check(B.ndim == 2, "b must be (n,) or (n, k)", InvalidArgumentsError)
    n, k = B.shape
    if max_iter is None:
        max_iter = min(n, 256)
    m = restart if restart is not None else max_iter

    X = np.zeros_like(B) if x0 is None else (
        x0[:, None] if x0.ndim == 1 else x0
    ).astype(B.dtype, copy=True)
    bnorm = np.linalg.norm(prec(B), axis=0)
    if np.all(bnorm == 0):
        x = X[:, 0] if was_vec else X
        return GmresResult(x, 0, [0.0], True)
    bnorm = np.where(bnorm > 0, bnorm, 1.0)

    residuals: list[float] = []
    total = 0
    converged = np.zeros(k, dtype=bool)
    while total < max_iter:
        steps = min(m, max_iter - total)
        X, hist, converged = _gmres_cycle(matop, prec, X, B, steps, tol, bnorm)
        residuals.extend(float(np.max(h)) for h in hist[1:])
        total += len(hist) - 1
        if np.all(converged):
            break
    log_debug("gmres: %d iters (k=%d rhs), final rel res %.3e",
              total, k, residuals[-1] if residuals else 0.0)
    x = X[:, 0] if was_vec else X
    return GmresResult(x, total, residuals or [0.0], bool(np.all(converged)))


def solve_gmres_device(
    matvec,
    b,
    tol: float = 1e-6,
    restart: int = 32,
    max_cycles: int = 8,
    M=None,
):
    """Device-resident restarted GMRES: the whole iteration (Krylov basis,
    Givens recurrence, back substitution) lives in one jitted
    lax.while_loop — matvecs never leave the chip.

    Real dtypes only (run Helmholtz through the 2x2 real-embedded stacked
    system, e.g. `StagePlan.apply_stacked`). matvec/M: jittable
    (n, k) -> (n, k) callables or arrays. Returns (x, total_iters, rel_res)
    as jax arrays. The Gram-Schmidt products run at HIGHEST precision: a
    default-precision f32 product may run in TF32, whose ~1e-3 error would
    floor the basis orthogonality far above a 1e-6 residual target.
    """
    import jax
    import jax.numpy as jnp

    hp = jax.lax.Precision.HIGHEST
    apply_a = matvec if callable(matvec) else (lambda V: matvec @ V)
    apply_m = (M if callable(M) else (lambda V: M @ V)) if M is not None \
        else (lambda V: V)

    b = jnp.asarray(b)
    was_vec = b.ndim == 1
    B = b[:, None] if was_vec else b
    n, k = B.shape
    m = int(restart)

    def cycle(X):
        R = apply_m(B - apply_a(X))
        beta = jnp.linalg.norm(R, axis=0)
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        V0 = jnp.zeros((m + 1, n, k), B.dtype).at[0].set(R / safe_beta)
        H0 = jnp.zeros((m + 1, m, k), B.dtype)
        cs0 = jnp.zeros((m, k), B.dtype)
        sn0 = jnp.zeros((m, k), B.dtype)
        g0 = jnp.zeros((m + 1, k), B.dtype).at[0].set(beta)

        def step(j, carry):
            V, H, cs, sn, g = carry
            W = apply_m(apply_a(V[j]))
            # classical Gram-Schmidt with one reorthogonalization pass —
            # the batched, fixed-shape form (MGS needs a sequential scan;
            # CGS2 has equivalent stability and is one matmul)
            mask = (jnp.arange(m + 1) <= j)[:, None, None]
            Vm = jnp.where(mask, V, 0.0)
            proj = jnp.einsum("ink,nk->ik", Vm, W, precision=hp)
            W = W - jnp.einsum("ink,ik->nk", Vm, proj, precision=hp)
            proj2 = jnp.einsum("ink,nk->ik", Vm, W, precision=hp)
            W = W - jnp.einsum("ink,ik->nk", Vm, proj2, precision=hp)
            hcol = proj + proj2  # (m+1, k)
            h = jnp.linalg.norm(W, axis=0)
            V = V.at[j + 1].set(jnp.where(h > 0, W / jnp.where(h > 0, h, 1.0), 0.0))
            hcol = hcol.at[j + 1].set(h)

            # apply the accumulated rotations sequentially
            def rot(i, hc):
                t = cs[i] * hc[i] + sn[i] * hc[i + 1]
                hc = hc.at[i + 1].set(-sn[i] * hc[i] + cs[i] * hc[i + 1])
                return hc.at[i].set(t)

            hcol = jax.lax.fori_loop(0, j, rot, hcol)
            a, bb = hcol[j], hcol[j + 1]
            denom = jnp.sqrt(a**2 + bb**2)
            safe_d = jnp.where(denom > 0, denom, 1.0)
            cj = jnp.where(denom > 0, jnp.abs(a) / safe_d, 1.0)
            sj = jnp.where(denom > 0, jnp.sign(a) * bb / safe_d, 0.0)
            hcol = hcol.at[j].set(cj * a + sj * bb).at[j + 1].set(0.0)
            cs = cs.at[j].set(cj)
            sn = sn.at[j].set(sj)
            g = g.at[j + 1].set(-sj * g[j])
            g = g.at[j].set(cj * g[j])
            H = H.at[:, j].set(hcol)
            return V, H, cs, sn, g

        V, H, cs, sn, g = jax.lax.fori_loop(
            0, m, step, (V0, H0, cs0, sn0, g0)
        )

        # back substitution (fixed m)
        def back(i_rev, y):
            i = m - 1 - i_rev
            num = g[i] - jnp.einsum("mk,mk->k", H[i], y)
            hii = H[i, i]
            return y.at[i].set(num / jnp.where(jnp.abs(hii) > 0, hii, 1.0))

        y = jax.lax.fori_loop(0, m, back, jnp.zeros((m, k), B.dtype))
        Xn = X + jnp.einsum("mnk,mk->nk", V[:m], y, precision=hp)
        res = jnp.abs(g[m]) / jnp.where(
            jnp.linalg.norm(B, axis=0) > 0, jnp.linalg.norm(B, axis=0), 1.0
        )
        return Xn, jnp.max(res)

    def cond(carry):
        X, res, c = carry
        return (res >= tol) & (c < max_cycles)

    def body(carry):
        X, _, c = carry
        Xn, res = cycle(X)
        return Xn, res, c + 1

    @jax.jit
    def run(B0):
        X0 = jnp.zeros_like(B0)
        X, res, c = jax.lax.while_loop(
            cond, body, (X0, jnp.asarray(jnp.inf, B0.dtype), 0)
        )
        return X, c * m, res

    X, iters, res = run(B)
    return (X[:, 0] if was_vec else X), iters, res


def solve_gmres_plan(
    apply_fn,
    b,
    tol: float = 1e-6,
    restart: int = 60,
    max_iter: int = 240,
) -> GmresResult:
    """Device-resident restarted GMRES DRIVEN FROM PYTHON: the Krylov
    basis, orthogonalization, and solution update all live on the device;
    the host sees only an (m+1)-float Hessenberg column per iteration (one
    tiny fetch) and runs the Givens recurrence in f64.

    Unlike `solve_gmres_device` (whole loop in one lax.while_loop), the
    operator here may be ANY Python-level device callable — in particular a
    PartitionPlan.apply_device composed of several executables (its
    oversized-block stage plans are separate jits). Large-N Helmholtz
    solves then cost ~ iters x apply time instead of host-GMRES's
    per-iteration host round trips.

    Real dtypes only — run complex systems through the interleaved real
    embedding. f32 basis: attainable relative residual floors around
    1e-6..1e-7; `tol` below that will run to max_iter and report the floor.
    Orthogonalization runs at HIGHEST precision (TF32 would floor it).
    """
    import jax
    import jax.numpy as jnp

    b = jnp.asarray(b)
    check(b.ndim == 1, "solve_gmres_plan is single-RHS ((n,) vector)",
          InvalidArgumentsError)
    n = b.shape[0]
    m = int(restart)

    @jax.jit
    def _norm(v):
        return jnp.linalg.norm(v)

    @jax.jit
    def _start(V, r, rnorm):
        return V.at[0].set(r / jnp.where(rnorm > 0, rnorm, 1.0))

    # keep ALL per-iteration glue inside jitted helpers (one dispatch each)
    hp = jax.lax.Precision.HIGHEST

    @jax.jit
    def _row(V, j):
        return V[j]

    @jax.jit
    def _resid(b, ax):
        return b - ax.reshape(b.shape)

    @jax.jit
    def _orth(V, w, j):
        """CGS2 against V[0..j]; returns (V with V[j+1] set, hcol, hlast)."""
        mask = (jnp.arange(m + 1) <= j)[:, None]
        Vm = jnp.where(mask, V, 0.0)
        h1 = jnp.dot(Vm, w, precision=hp)
        w = w - jnp.dot(Vm.T, h1, precision=hp)
        h2 = jnp.dot(Vm, w, precision=hp)
        w = w - jnp.dot(Vm.T, h2, precision=hp)
        h = h1 + h2
        beta = jnp.linalg.norm(w)
        V = V.at[j + 1].set(w / jnp.where(beta > 0, beta, 1.0))
        return V, h, beta

    @jax.jit
    def _update(x, V, y):
        return x + jnp.dot(V[:m].T, jnp.asarray(y, V.dtype), precision=hp)

    x = jnp.zeros_like(b)
    bnorm = float(_norm(b))
    if bnorm == 0:
        return GmresResult(np.zeros(n), 0, [0.0], True)

    residuals: list[float] = []
    total = 0
    prev = np.inf
    claimed = False  # the last cycle's Givens estimate met tol
    while True:
        # restart on the TRUE residual: the Givens estimate drifts below it
        # at the f32 floor. After a cycle whose estimate met tol, another
        # starts only while it still halves the true residual.
        r = _resid(b, jnp.asarray(apply_fn(x)))
        rnorm = float(_norm(r))
        final = rnorm / bnorm
        residuals.append(final)
        if (final < tol or total >= max_iter
                or (claimed and final > 0.5 * prev)):
            break
        prev, claimed = final, False
        V = jnp.zeros((m + 1, n), b.dtype)
        V = _start(V, r, rnorm)
        # host-side f64 Givens recurrence state
        Hr = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = rnorm
        j_used = 0
        for j in range(m):
            if total >= max_iter:
                break
            w = jnp.asarray(apply_fn(_row(V, jnp.int32(j)))).reshape(n)
            # j as a device scalar: a Python int would retrace/recompile
            # _orth once per iteration (measured 0.8 s/iter of pure
            # compiles at n=16384)
            V, hcol_d, beta_d = _orth(V, w, jnp.int32(j))
            hcol = np.asarray(hcol_d, np.float64)
            hcol[j + 1] = float(beta_d)
            for i in range(j):
                t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t
            a, bb = hcol[j], hcol[j + 1]
            d = np.hypot(a, bb)
            cs[j], sn[j] = (1.0, 0.0) if d == 0 else (a / d, bb / d)
            hcol[j] = cs[j] * a + sn[j] * bb
            hcol[j + 1] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            Hr[: m + 1, j] = hcol[: m + 1]
            total += 1
            j_used = j + 1
            res = abs(g[j + 1]) / bnorm
            residuals.append(res)
            if res < tol:
                claimed = True
                break
        if j_used:
            y = np.zeros(m)
            for i in range(j_used - 1, -1, -1):
                y[i] = (g[i] - Hr[i, i + 1:j_used] @ y[i + 1:j_used]) / (
                    Hr[i, i] if Hr[i, i] != 0 else 1.0)
            x = _update(x, V, y)
    log_info("gmres_plan: %d iters, rel res %.3e (givens est %.3e)",
             total, final, residuals[-2] if len(residuals) > 1 else 0.0)
    return GmresResult(np.asarray(x), total, residuals,
                       bool(final < 10 * tol))


# ---------------------------------------------------------------------------
# Eigen solves (host, setup-time)
# ---------------------------------------------------------------------------


def _as_sparse(A) -> sp.spmatrix:
    if sp.issparse(A):
        return A.tocsc()
    if hasattr(A, "materialize"):
        return sp.csc_matrix(A.materialize())
    return sp.csc_matrix(np.asarray(A))


def _v0(n: int) -> np.ndarray:
    """Deterministic Lanczos start vector: ARPACK otherwise seeds from the
    global legacy RNG, making eigensolves depend on unrelated code having
    drawn random numbers (observed as test-order-dependent eigenband
    results)."""
    return np.random.default_rng(0x5EED).standard_normal(n)


def get_max_eigenvalue(L, M) -> float:
    """Largest eigenvalue of the generalized problem L x = lam M x
    (reference: bfGetMaxEigenvalue, src/linalg.c:328-470)."""
    Ls, Ms = _as_sparse(L), _as_sparse(M)
    vals = spla.eigsh(
        Ls, k=1, M=Ms, which="LA", return_eigenvectors=False, tol=1e-9,
        v0=_v0(Ls.shape[0]),
    )
    return float(vals[0])


def get_shifted_eigs(L, M, sigma: float, k: int):
    """k eigenpairs of (L, M) nearest `sigma` via shift-invert Lanczos,
    sorted ascending (reference: bfGetShiftedEigs, src/linalg.c:472-746)."""
    Ls, Ms = _as_sparse(L), _as_sparse(M)
    vals, vecs = spla.eigsh(Ls, k=k, M=Ms, sigma=sigma, which="LM",
                            v0=_v0(Ls.shape[0]))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def _cluster_edges(vals: np.ndarray) -> np.ndarray:
    """Indices where a new distinct eigenvalue cluster starts."""
    if vals.size == 0:
        return np.empty(0, dtype=np.int64)
    tol = 1e-9 * max(1.0, np.abs(vals).max())
    return np.concatenate([[0], np.flatnonzero(np.diff(vals) > tol) + 1])


def _covering_probe(L, M, sigma: float, k: int, n: int):
    """One COVERING probe: eigenpairs around sigma plus a certified covered
    bracket (reference: getPairsCoveringInterval, src/linalg.c:818-899).

    The certified interval's endpoints are placed strictly BETWEEN distinct
    eigenvalue clusters so multiplets are never split between probes; the
    outermost clusters are discarded (they may be incomplete)."""
    kk = k + 2
    while True:
        kk = min(kk, n - 2)
        vals, vecs = get_shifted_eigs(L, M, sigma, kk)
        starts = _cluster_edges(vals)
        if starts.size >= 3 or kk >= n - 2:
            break
        kk *= 2
    if starts.size < 3:
        # whole reachable spectrum is (at most) two clusters: certify all
        return vals, vecs, (-np.inf, np.inf)
    c0_end = starts[1]  # first kept index
    cm_start = starts[-1]  # first discarded index
    lo = 0.5 * (vals[c0_end - 1] + vals[c0_end])
    hi = 0.5 * (vals[cm_start - 1] + vals[cm_start])
    keep = slice(c0_end, cm_start)
    return vals[keep], vecs[:, keep], (float(lo), float(hi))


def get_eigenband(L, M, lam0: float, lam1: float, method: str = "covering",
                  k_init: int = 8):
    """All eigenpairs with lam in [lam0, lam1]
    (reference: bfGetEigenband, src/linalg.c:969-1000).

    method="doubling": shift-invert at the midpoint, doubling k until the
      returned spectrum covers the band (src/linalg.c:748-816).
    method="covering": maintain a worklist of uncovered subintervals; probe
      each at its midpoint with k_init+2 eigenpairs, certify the midpoint
      bracket, subtract it from the worklist (src/linalg.c:901-967).

    Handles half-open bands: lam0=-inf or lam1=+inf take everything on that
    side reachable from the probes (used by the LBO streamer's brackets,
    src/lbo.c:41-68).
    """
    check(lam0 < lam1, "empty band", InvalidArgumentsError)
    n = _as_sparse(L).shape[0]

    # Resolve half-open bands to the actual spectrum edge first — a shifted
    # probe alone cannot certify that nothing lies further out.
    if not np.isfinite(lam0):
        Ls, Ms = _as_sparse(L), _as_sparse(M)
        # shift-invert just below the spectrum: (L - sigma M) is definite for
        # sigma < lam_min, so this is robust even for singular L (lam_min=0),
        # where plain Lanczos which='SA' can silently miss the kernel.
        scale = abs(Ls.diagonal()).sum() / max(abs(Ms.diagonal()).sum(), 1e-300)
        sigma_probe = -1e-6 * max(scale, 1e-300)
        lam_min = float(
            spla.eigsh(Ls, k=1, M=Ms, sigma=sigma_probe, which="LM",
                       return_eigenvectors=False, v0=_v0(Ls.shape[0]))[0]
        )
        lam0 = lam_min - max(1e-8, 1e-8 * abs(lam_min))
    if not np.isfinite(lam1):
        lam_max = get_max_eigenvalue(L, M)
        lam1 = lam_max + max(1e-8, 1e-8 * abs(lam_max))

    finite_lo = np.isfinite(lam0)
    finite_hi = np.isfinite(lam1)

    if method == "doubling":
        sigma = (
            0.5 * (lam0 + lam1)
            if finite_lo and finite_hi
            else (lam1 - 1.0 if finite_hi else lam0 + 1.0)
        )
        k = k_init
        while True:
            k = min(k, n - 2)
            vals, vecs = get_shifted_eigs(L, M, sigma, k)
            lo_ok = (not finite_lo) or vals[0] < lam0
            hi_ok = (not finite_hi) or vals[-1] > lam1
            if (lo_ok and hi_ok) or k >= n - 2:
                keep = np.ones_like(vals, dtype=bool)
                if finite_lo:
                    keep &= vals >= lam0
                if finite_hi:
                    keep &= vals < lam1
                return vals[keep], vecs[:, keep]
            k *= 2

    check(method == "covering", f"unknown method {method}", InvalidArgumentsError)
    check(finite_lo and finite_hi,
          "covering method needs a finite band; use doubling for half-open",
          InvalidArgumentsError)

    all_vals: list[np.ndarray] = []
    all_vecs: list[np.ndarray] = []
    # worklist of disjoint uncovered intervals (reference: disjoint interval
    # list, src/disjoint_interval_list.c)
    work = [(lam0, lam1)]
    guard = 0
    while work:
        guard += 1
        check(guard <= 1000, "eigenband covering failed to converge")
        a, b = work.pop()
        sigma = 0.5 * (a + b)
        vals, vecs, (lo, hi) = _covering_probe(L, M, sigma, k_init, n)
        if lo >= b or hi <= a:
            # certified interval fell outside the work interval: nothing in
            # (a, b) near sigma was certified — enlarge the probe instead of
            # looping forever
            vals, vecs, (lo, hi) = _covering_probe(L, M, sigma, 4 * k_init, n)
            if lo >= b or hi <= a:
                lo, hi = a, b  # accept what we have for this interval
        keep = (vals >= a) & (vals < b) & (vals >= lo) & (vals < hi)
        all_vals.append(vals[keep])
        all_vecs.append(vecs[:, keep])
        if lo > a:
            work.append((a, min(lo, b)))
        if hi < b:
            work.append((max(hi, a), b))
        log_debug("eigenband covering: probe sigma=%.4g covered (%.4g, %.4g)",
                  sigma, lo, hi)

    vals = np.concatenate(all_vals)
    vecs = np.concatenate(all_vecs, axis=1) if all_vecs else np.zeros((n, 0))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]
