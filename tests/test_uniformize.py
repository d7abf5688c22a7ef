"""fac -> device bridge: real factorization-engine outputs through the
packed device path, validated against the dense oracle (the reference's own
validation pattern, SURVEY.md §4)."""

import numpy as np
import pytest

from butterfly_tpu.config import FacSpec
from butterfly_tpu.fac.streamer import FacStreamer
from butterfly_tpu.fac.uniformize import (
    choose_block_align,
    fac_block_stats,
    uniformize,
)
from butterfly_tpu.trees import uniform_tree


def _fourier_modes(n, m):
    x = (np.arange(n) + 0.5) / n
    k = np.arange(m)
    return np.cos(np.pi * np.outer(x, k)) * np.sqrt(2.0 / n)


def _streamed_fac(Phi, row_depth=5, col_depth=3, tol=1e-10, init_depth=2):
    n, m = Phi.shape
    spec = FacSpec(
        row_tree=uniform_tree(n, 2, row_depth),
        col_tree=uniform_tree(m, 2, col_depth),
        row_tree_init_depth=init_depth,
        tol=tol,
        min_num_rows=4,
        min_num_cols=4,
    )
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(col_depth):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0 : leaf.i1])
    return streamer.get_fac()


def test_uniformize_streamed_fac(rng):
    """A REAL streamer output through the device path (f64 exact on the CPU
    test backend, f32 within budget)."""
    Phi = _fourier_modes(512, 256)
    fac = _streamed_fac(Phi)
    x = rng.standard_normal((256, 4))

    plan = uniformize(fac, dtype=np.float64, block_align=16)
    got = np.asarray(plan(x))
    rel = np.linalg.norm(got - Phi @ x) / np.linalg.norm(Phi @ x)
    assert rel < 1e-8, f"f64 device path rel err {rel:.3e}"
    assert 0.0 <= plan.stats.padding_waste < 1.0
    assert plan.stats.num_stages == fac.num_w + 1

    plan32 = uniformize(fac, dtype=np.float32, block_align=16)
    got32 = np.asarray(plan32(x))
    rel32 = np.linalg.norm(got32 - Phi @ x) / np.linalg.norm(Phi @ x)
    assert rel32 < 1e-6, f"f32 device path rel err {rel32:.3e}"  # BASELINE accuracy clause


def test_uniformize_auto_align(rng):
    Phi = _fourier_modes(256, 128)
    fac = _streamed_fac(Phi, row_depth=4, col_depth=2, init_depth=1)
    align, ests = choose_block_align(fac)
    assert align in {e.block_align for e in ests}
    for e in ests:
        assert e.padded_flops_per_col >= e.useful_flops_per_col
        assert e.num_buckets <= e.num_gemm_units
    plan = uniformize(fac, dtype=np.float64)  # auto align
    x = rng.standard_normal(128)
    rel = np.linalg.norm(np.asarray(plan(x)) - Phi @ x) / np.linalg.norm(Phi @ x)
    assert rel < 1e-8

    stats = fac_block_stats(fac)
    assert sum(s["num_blocks"] for s in stats.values()) > 0


def test_uniformize_helm2_real_embed(rng):
    """The multilevel Helmholtz factorization through the device path with
    the 2x2 real embedding (the real-only complex route) — rel err vs
    the host oracle must be exact at c128/f64."""
    from butterfly_tpu.fac import helm2 as fac_helm2
    from butterfly_tpu.geom import Ellipse
    from butterfly_tpu.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu.trees import Quadtree

    n = 2048
    e = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3)
    X, T, N, W = e.sample_linspaced(n)
    helm = Helm2(k=50.0, layer_pot=LayerPot.SINGLE)
    tree = Quadtree(X, leaf_size=32, normals=N)
    A = fac_helm2.make_multilevel(helm, tree, tree)

    plan = uniformize(A, dtype=np.complex128, block_align=32, real_embed=True)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = A.matvec(x)
    got = np.asarray(plan(x))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-10, f"real-embed device path rel err {rel:.3e}"
    assert np.iscomplexobj(got)

    # c64-precision route (what the device runs) stays inside the
    # BASELINE 1e-6 rel-err budget.
    plan32 = uniformize(A, dtype=np.complex64, block_align=32, real_embed=True)
    got32 = np.asarray(plan32(x))
    rel32 = np.linalg.norm(got32 - want) / np.linalg.norm(want)
    assert rel32 < 1e-6, f"c64 real-embed rel err {rel32:.3e}"  # BASELINE accuracy clause

    # stacked-real device-resident form agrees with the complex wrapper
    xr = np.concatenate([x.real, x.imag])[:, None]
    yr = np.asarray(plan.apply_stacked(xr))[:, 0]
    y2 = yr[:n] + 1j * yr[n:]
    assert np.allclose(y2, got, rtol=1e-12, atol=1e-12)
