"""GMRES + eigenband solvers vs dense ground truth.

The eigenband test mirrors the reference's one numerical golden test
(tests/test_linalg.c:18-77): compute an interior eigenband of a generalized
problem with BOTH strategies and compare against a dense eigensolve.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from butterfly_tpu.ops.linalg import (
    get_eigenband,
    get_max_eigenvalue,
    get_shifted_eigs,
    solve_gmres,
)


def test_gmres_real(rng):
    n = 80
    A = np.eye(n) * 4 + 0.5 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    res = solve_gmres(A, b, tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(A @ res.x, b, atol=1e-9)


def test_gmres_complex(rng):
    n = 60
    A = np.eye(n) * (2 + 1j) + 0.3 * (
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    )
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    res = solve_gmres(A, b, tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(A @ res.x, b, atol=1e-9)


def test_gmres_operator_and_preconditioner(rng):
    """GMRES on a matrix-free callable with a left preconditioner — the
    butterflied-operator use case (reference: bfSolveGMRES works on any
    BfMat incl. MatFunc/MatProduct)."""
    n = 100
    d = 1.0 + rng.random(n) * 100  # badly scaled diagonal
    A = np.diag(d) + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    matvec = lambda v: A @ v
    plain = solve_gmres(matvec, b, tol=1e-10, max_iter=60)
    precond = solve_gmres(matvec, b, tol=1e-10, max_iter=60, M=lambda v: v / d)
    assert precond.converged
    assert precond.num_iter <= plain.num_iter
    np.testing.assert_allclose(A @ precond.x, b, atol=1e-7)


def test_gmres_reports_nonconvergence(rng):
    n = 50
    A = rng.standard_normal((n, n))  # indefinite, hard
    b = rng.standard_normal(n)
    res = solve_gmres(A, b, tol=1e-14, max_iter=3)
    assert not res.converged
    assert res.num_iter == 3


@pytest.fixture(scope="module")
def lap_problem():
    """1-D FEM-style generalized problem (L, M) with known eigenstructure."""
    n = 200
    h = 1.0 / (n + 1)
    L = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)) / h
    M = sp.diags([1.0 / 6, 4.0 / 6, 1.0 / 6], [-1, 0, 1], shape=(n, n)) * h
    dense_vals = np.sort(
        np.real(np.linalg.eigvals(np.linalg.solve(M.toarray(), L.toarray())))
    )
    return L.tocsc(), M.tocsc(), dense_vals


def test_max_eigenvalue(lap_problem):
    L, M, dense_vals = lap_problem
    lam = get_max_eigenvalue(L, M)
    np.testing.assert_allclose(lam, dense_vals[-1], rtol=1e-6)


def test_shifted_eigs(lap_problem):
    L, M, dense_vals = lap_problem
    sigma = float(dense_vals[10] * 1.001)
    vals, vecs = get_shifted_eigs(L, M, sigma, 5)
    # the 5 closest to sigma, sorted
    want = dense_vals[np.argsort(np.abs(dense_vals - sigma))[:5]]
    np.testing.assert_allclose(np.sort(vals), np.sort(want), rtol=1e-8)
    # residual check L v = lam M v
    r = L @ vecs - (M @ vecs) * vals
    assert np.abs(r).max() < 1e-6


@pytest.mark.parametrize("method", ["doubling", "covering"])
def test_eigenband(lap_problem, method):
    """(reference parity: tests/test_linalg.c runs both DOUBLING and
    COVERING on the same band and checks eigenvalues/eigenvectors)."""
    L, M, dense_vals = lap_problem
    lam0, lam1 = float(dense_vals[5] - 1), float(dense_vals[14] + 1)
    want = dense_vals[(dense_vals >= lam0) & (dense_vals < lam1)]
    vals, vecs = get_eigenband(L, M, lam0, lam1, method=method)
    np.testing.assert_allclose(vals, want, rtol=1e-8)
    r = L @ vecs - (M @ vecs) * vals
    assert np.abs(r).max() < 1e-6


def test_eigenband_half_open(lap_problem):
    """(-inf, lam) bands are what the LBO streamer feeds first
    (reference: getBracketFromNode, src/lbo.c:41-68)."""
    L, M, dense_vals = lap_problem
    lam1 = float(dense_vals[7] + 1)
    vals, vecs = get_eigenband(L, M, -np.inf, lam1, method="doubling")
    want = dense_vals[dense_vals < lam1]
    np.testing.assert_allclose(vals, want, rtol=1e-8)


def test_gmres_multi_rhs_and_restart(rng):
    """Multi-RHS batched Krylov + GMRES(m) restart cycles (reference:
    bfSolveGMRES multi-RHS, src/linalg.c:47-317)."""
    from butterfly_tpu.ops.linalg import solve_gmres

    n = 160
    A = np.diag(np.linspace(1, 2, n)) + 0.02 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, 6))
    r = solve_gmres(A, B, tol=1e-10, restart=15, max_iter=300)
    assert r.converged
    assert r.x.shape == (n, 6)
    rel = np.linalg.norm(A @ r.x - B) / np.linalg.norm(B)
    assert rel < 1e-9, f"multi-rhs restarted rel {rel:.2e}"

    # complex multi-RHS
    Ac = np.eye(n) + 0.05 * (
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    )
    Bc = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    rc = solve_gmres(Ac, Bc, tol=1e-12)
    assert rc.converged
    relc = np.linalg.norm(Ac @ rc.x - Bc) / np.linalg.norm(Bc)
    assert relc < 1e-10


def test_gmres_device_resident(rng):
    """Device-resident GMRES: the whole Krylov iteration in one jitted
    while_loop; matches the host solver."""
    import jax.numpy as jnp

    from butterfly_tpu.ops.linalg import solve_gmres_device

    n = 128
    A = np.diag(np.linspace(1, 2, n)) + 0.02 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, 4))
    Aj = jnp.asarray(A)
    x, iters, res = solve_gmres_device(
        lambda V: Aj @ V, jnp.asarray(B), tol=1e-9, restart=20, max_cycles=10
    )
    rel = np.linalg.norm(A @ np.asarray(x) - B) / np.linalg.norm(B)
    assert rel < 1e-8, f"device gmres rel {rel:.2e}"
    assert float(res) < 1e-9


def test_gmres_device_on_real_embedded_plan(rng):
    """Complex Helmholtz-style GMRES through the real embedding: the system rides
    the 2x2 real-embedded packed plan and the device solver stays real."""
    from butterfly_tpu.ops.linalg import solve_gmres_device
    from butterfly_tpu.ops.linop import Dense
    from butterfly_tpu.ops.packed import pack

    n = 96
    Ac = np.eye(n) + 0.05 * (
        rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    )
    plan = pack(Dense(Ac), dtype=np.complex128, real_embed=True)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    br = np.concatenate([bc.real, bc.imag])
    x, iters, res = solve_gmres_device(
        lambda V: plan.apply_stacked(V), br[:, None],
        tol=1e-10, restart=30, max_cycles=8,
    )
    xr = np.asarray(x)[:, 0]
    xc = xr[:n] + 1j * xr[n:]
    rel = np.linalg.norm(Ac @ xc - bc) / np.linalg.norm(bc)
    assert rel < 1e-8, f"real-embedded device gmres rel {rel:.2e}"


def test_gmres_plan_driver(rng):
    """Python-driven device GMRES (solve_gmres_plan): vectors stay on the
    device, the host runs only the Givens recurrence; the operator may be
    any Python-level callable (e.g. a mega-composed PartitionPlan)."""
    import jax.numpy as jnp

    from butterfly_tpu.ops.linalg import solve_gmres_plan

    n = 160
    A = np.diag(np.linspace(1, 2, n)) + 0.02 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A, jnp.float32)

    res = solve_gmres_plan(lambda v: Aj @ v.astype(jnp.float32),
                           jnp.asarray(b, jnp.float32),
                           tol=1e-5, restart=40, max_iter=160)
    rel = np.linalg.norm(A @ res.x - b) / np.linalg.norm(b)
    assert res.converged
    assert rel < 1e-4, f"gmres_plan rel {rel:.2e}"

    # restart cycles exercise the outer loop
    res2 = solve_gmres_plan(lambda v: Aj @ v.astype(jnp.float32),
                            jnp.asarray(b, jnp.float32),
                            tol=1e-5, restart=10, max_iter=200)
    rel2 = np.linalg.norm(A @ res2.x - b) / np.linalg.norm(b)
    assert rel2 < 1e-4, f"gmres_plan restarted rel {rel2:.2e}"
