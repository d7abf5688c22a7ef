"""fac/partition.py: the multilevel partition compiled to a batched device
apply (near-field batched GEMM + per-class batched distilled butterflies).

Validated the reference way — against the operator's own dense action
(SURVEY §4): the partition plan must reproduce the multilevel fac
(reference: facHelm2MakeMultilevel_rec, src/fac_helm2.c:806-941) at the
distillation's f32 accuracy floor.
"""

import numpy as np
import pytest

from butterfly_tpu.fac import helm2 as fac_helm2
from butterfly_tpu.fac.partition import partition_apply_plan
from butterfly_tpu.geom import Ellipse
from butterfly_tpu.ops.helm2 import Helm2, LayerPot
from butterfly_tpu.trees import Quadtree
from butterfly_tpu.utils.errors import InvalidArgumentsError


@pytest.fixture(scope="module")
def helm_fac():
    nE = 1024
    ell = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, _, Nrm, _ = ell.sample_linspaced(nE)
    helm = Helm2(k=30.0, layer_pot=LayerPot.SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=Nrm)
    return nE, fac_helm2.make_multilevel(helm, tree, tree)


def test_partition_matches_complex_oracle(helm_fac):
    nE, A = helm_fac
    pp = partition_apply_plan(A)
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((nE, 3)) + 1j * rng.standard_normal((nE, 3))
    got = pp.apply_complex(zs)
    want = A.matmat(zs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, f"partition apply rel {rel:.2e}"
    # deterministic across calls
    got2 = pp.apply_complex(zs)
    assert np.allclose(got, got2)


def test_partition_handles_undersized_tile_lists(helm_fac):
    """Tiny tile lists no longer raise: dense classes auto-extend (a
    batched GEMM works at any size) and oversized butterfly blocks take
    the per-block stage-plan path — the plan must still match the fac."""
    nE, A = helm_fac
    pp = partition_apply_plan(A, dense_tiles=(8,), bf_tiles=(8,))
    rng = np.random.default_rng(5)
    zs = rng.standard_normal((nE, 2)) + 1j * rng.standard_normal((nE, 2))
    got = pp.apply_complex(zs)
    want = A.matmat(zs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, f"tiny-tile partition apply rel {rel:.2e}"


def test_partition_blockwise_extraction_matches(helm_fac):
    """The O(block-areas) block-wise extraction of member blocks (host
    chains) reproduces the operator to fp accuracy."""
    nE, A = helm_fac
    pp = partition_apply_plan(A)
    rng = np.random.default_rng(1)
    zs = rng.standard_normal((nE, 3)) + 1j * rng.standard_normal((nE, 3))
    got = pp.apply_complex(zs)
    want = A.matmat(zs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, f"blockwise partition apply rel {rel:.2e}"


def test_partition_oversized_blocks_via_stage_plans():
    """Blocks wider than the largest butterfly tile apply through their own
    packed stage plans (the >=16k-points path, where top partition levels
    are ~N/4 wide); forcing a small tile cap here must still match the
    fac. (The shared 1024-point fixture has no separated blocks at all, so
    this test builds a 2048-point operator that does.)"""
    nE = 2048
    ell = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, _, Nrm, _ = ell.sample_linspaced(nE)
    helm = Helm2(k=40.0, layer_pot=LayerPot.SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=Nrm)
    A = fac_helm2.make_multilevel(helm, tree, tree)
    pp = partition_apply_plan(A, bf_tiles=(256,))
    assert pp._mega, "expected oversized blocks with a 256 tile cap"
    rng = np.random.default_rng(2)
    zs = rng.standard_normal((nE, 3)) + 1j * rng.standard_normal((nE, 3))
    got = pp.apply_complex(zs)
    want = A.matmat(zs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, f"oversized-block partition apply rel {rel:.2e}"
    # the jittable tiled-only path must refuse (it would silently drop
    # the oversized blocks)
    import jax.numpy as jnp
    with pytest.raises(Exception):
        pp.apply_with(pp.params, jnp.zeros((2 * nE, 2), jnp.float32))


def _oversized_fac(nE=2048, k=40.0):
    ell = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, _, Nrm, _ = ell.sample_linspaced(nE)
    helm = Helm2(k=k, layer_pot=LayerPot.SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=Nrm)
    return fac_helm2.make_multilevel(helm, tree, tree)


def test_partition_streamed_megas_match():
    """mega_resident_bytes=0 forces every oversized block's stage-plan
    params to stay HOST-resident and stream H2D per apply (the 65k-point
    configuration, where mega weights cannot co-reside with the cell
    weights in HBM) — the result must be identical-quality to the pinned
    path."""
    nE = 2048
    A = _oversized_fac(nE)
    pp = partition_apply_plan(A, bf_tiles=(256,), mega_resident_bytes=0)
    assert pp._mega and pp.mega_streamed_bytes > 0
    rng = np.random.default_rng(3)
    zs = rng.standard_normal((nE, 2)) + 1j * rng.standard_normal((nE, 2))
    got = pp.apply_complex(zs)
    want = A.matmat(zs)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-5, f"streamed-mega partition apply rel {rel:.2e}"


def test_gmres_plan_on_partition_end_to_end():
    """The device GMRES driver (solve_gmres_plan) against a PartitionPlan
    apply — the large-N Helmholtz solve path (examples/helm2_scale.py) in
    miniature, second-kind system (I/2 + A_w) sigma = b in the interleaved
    real embedding, with oversized blocks streamed."""
    import jax
    import jax.numpy as jnp

    from butterfly_tpu.ops.linalg import solve_gmres_plan

    nE = 2048
    A = _oversized_fac(nE)
    pp = partition_apply_plan(A, bf_tiles=(256,), mega_resident_bytes=0)
    rng = np.random.default_rng(4)
    w = np.full(nE, 2 * np.pi / nE)
    w2 = jnp.asarray(np.repeat(w, 2), jnp.float32)
    rhs = rng.standard_normal(nE) + 1j * rng.standard_normal(nE)
    b2 = np.empty(2 * nE, np.float32)
    b2[0::2], b2[1::2] = rhs.real, rhs.imag

    post = jax.jit(lambda v, y: 0.5 * v + y[:, 0])

    def sys_apply(v):
        return post(v, pp.apply_device((v * w2)[:, None]))

    res = solve_gmres_plan(sys_apply, jnp.asarray(b2), tol=1e-5,
                           restart=40, max_iter=120)
    assert res.converged, f"rel res {res.residuals[-1]:.1e}"
    # check the returned sigma against the system applied once more
    x = np.asarray(res.x)
    r = np.asarray(sys_apply(jnp.asarray(x))) - b2
    rel = np.linalg.norm(r) / np.linalg.norm(b2)
    assert rel < 5e-5, f"recomputed residual {rel:.2e}"
