"""Radiosity: view-factor operator assembly + radiosity solve.

Reference counterpart: the radiosity example assembles a CSR view-factor
matrix from a triangle mesh using the midpoint rule with Embree-ray
visibility (examples/radiosity/radiosity.c:22,
bfMatCsrRealNewViewFactorMatrixFromTrimesh src/mat_csr_real.c:407-440,
integrateViewFactorMidpointRule src/mat_csr_real.c:387-405).

Device redesign: the view-factor kernel F_ij is evaluated for a whole (rows x
cols) tile at once as fused jnp broadcasting (one VPU pass), visibility is
the batched Möller–Trumbore tile of geom/visibility.py, and the result is
returned either dense-on-device (for butterfly compression / scoring) or as
scipy CSR (the reference's format). The radiosity equation
(I - diag(rho) F) B = E is solved with the framework GMRES on a matrix-free
operator, so a butterfly-compressed F drops straight in.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from butterfly_tpu.geom.visibility import segment_occluded
from butterfly_tpu.ops.linalg import solve_gmres
from butterfly_tpu.ops.linop import FuncOp

__all__ = ["view_factor_tile", "view_factor_matrix", "RadiosityModel"]


@jax.jit
def view_factor_tile(src_cent, src_norm, tgt_cent, tgt_norm, tgt_area):
    """Dense (S, T) tile of midpoint-rule view factors.

    Exactly the reference quadrature (src/mat_csr_real.c:387-405):
      dp = p_src - p_tgt
      F  = area_tgt * max(0, n_src . dp) * max(0, -n_tgt . dp) / (pi |dp|^4)
    evaluated for all (src, tgt) pairs in one broadcasted pass.
    """
    dp = src_cent[:, None, :] - tgt_cent[None, :, :]  # (S, T, 3)
    dot_src = jnp.sum(src_norm[:, None, :] * dp, axis=-1)
    dot_tgt = -jnp.sum(tgt_norm[None, :, :] * dp, axis=-1)
    r2 = jnp.sum(dp * dp, axis=-1)
    num = tgt_area[None, :] * jnp.maximum(0.0, dot_src) * jnp.maximum(
        0.0, dot_tgt
    )
    val = num / (jnp.pi * jnp.maximum(r2, 1e-300) ** 2)
    return jnp.where(r2 > 0.0, val, 0.0)  # zero the self-pair diagonal


def view_factor_matrix(mesh, row_inds=None, col_inds=None, *,
                       occlusion: bool = False, tile: int = 2048,
                       sparse: bool = True):
    """View-factor matrix F[rowInds, colInds] of a trimesh.

    occlusion=True additionally zeroes pairs whose sightline the mesh blocks
    (the reference's Embree path); with False only the back-face cosine
    clamps apply (matches a reference build without BF_EMBREE).

    Returns scipy CSR when sparse=True (the reference's container,
    include/bf/mat_csr_real.h:22-36), else a dense np.ndarray.
    """
    nf = mesh.num_faces
    row_inds = np.arange(nf) if row_inds is None else np.asarray(row_inds)
    col_inds = np.arange(nf) if col_inds is None else np.asarray(col_inds)
    cent = mesh.face_centroids().astype(np.float64)
    norm = mesh.face_normals().astype(np.float64)
    area = mesh.face_areas().astype(np.float64)

    S, T = len(row_inds), len(col_inds)
    out = np.zeros((S, T))
    for i0 in range(0, S, tile):
        i1 = min(S, i0 + tile)
        ri = row_inds[i0:i1]
        for j0 in range(0, T, tile):
            j1 = min(T, j0 + tile)
            cj = col_inds[j0:j1]
            blk = np.array(
                view_factor_tile(
                    jnp.asarray(cent[ri]), jnp.asarray(norm[ri]),
                    jnp.asarray(cent[cj]), jnp.asarray(norm[cj]),
                    jnp.asarray(area[cj]),
                )
            )
            if occlusion:
                ii, jj = np.nonzero(blk)
                if ii.size:
                    occ = segment_occluded(mesh, ri[ii], cj[jj])
                    blk[ii[occ], jj[occ]] = 0.0
            out[i0:i1, j0:j1] = blk
    if sparse:
        return sp.csr_matrix(out)
    return out


class RadiosityModel:
    """Radiosity solve B = E + diag(rho) F B on a trimesh.

    `apply_F` may be the dense/CSR matrix from view_factor_matrix or any
    matrix-free operator (e.g. a butterfly-compressed F), mirroring how every
    reference solver works on abstract BfMat operators (src/linalg.c:47)."""

    def __init__(self, mesh, rho, apply_F=None, **vf_kw):
        self.mesh = mesh
        self.rho = np.broadcast_to(np.asarray(rho, dtype=np.float64),
                                   (mesh.num_faces,)).copy()
        if apply_F is None:
            F = view_factor_matrix(mesh, **vf_kw)
            self.apply_F = lambda x: F @ x
        elif hasattr(apply_F, "matvec"):
            self.apply_F = apply_F.matvec
        elif callable(apply_F):
            self.apply_F = apply_F
        else:
            F = apply_F
            self.apply_F = lambda x: F @ x

    def solve(self, emission, tol: float = 1e-10, max_iter: int = 200):
        """GMRES solve of (I - diag(rho) F) B = E; returns (B, num_iters)."""
        n = self.mesh.num_faces
        e = np.asarray(emission, dtype=np.float64).reshape(n)

        def mv(x):
            x = np.asarray(x)
            fx = np.asarray(self.apply_F(x)).reshape(x.shape)
            rho = self.rho if x.ndim == 1 else self.rho[:, None]
            return x - rho * fx

        A = FuncOp((n, n), mv, dtype=np.float64)
        res = solve_gmres(A, e, tol=tol, max_iter=max_iter)
        return np.asarray(res.x).reshape(n), res.num_iter
