"""fac/distill.py: real operators re-compressed into uniform FFT form.

The distilled UniformButterfly is the bridge that lets REAL factorizations
run through the flagship fused Pallas kernel and the explicit-exchange
sharded apply — VERDICT r2 items 2/3/6. Every test checks against the dense
ground truth, the reference's own strongest validation pattern (SURVEY §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from butterfly_tpu.config import FacSpec
from butterfly_tpu.fac.distill import distill_butterfly
from butterfly_tpu.fac.streamer import FacStreamer
from butterfly_tpu.fac.uniformize import uniformize_fused
from butterfly_tpu.trees import uniform_tree


def _fourier(n, m):
    x = (np.arange(n) + 0.5) / n
    k = np.arange(m)
    return np.cos(np.pi * np.outer(x, k)) * np.sqrt(2.0 / n)


def test_distill_dense_accuracy():
    Phi = _fourier(1024, 1024)
    d = distill_butterfly(Phi, 16, 96, dtype=np.float64)
    x = np.random.default_rng(0).standard_normal((1024, 8))
    y = np.asarray(d.apply(x))
    want = Phi[d.row_perm] @ x
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-6, f"rel {rel:.2e}"
    # canonical order restores the original rows
    yc = np.asarray(d.apply_canonical(x))
    want_c = Phi @ x
    rel_c = np.linalg.norm(yc - want_c) / np.linalg.norm(want_c)
    assert rel_c < 1e-6


def test_distill_adaptive_rank():
    Phi = _fourier(512, 512)
    d = distill_butterfly(Phi, 8, rank=None, tol=1e-7, dtype=np.float64)
    x = np.random.default_rng(1).standard_normal((512, 4))
    y = np.asarray(d.apply(x))
    want = Phi[d.row_perm] @ x
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-6, f"adaptive rank {d.rank} gave rel {rel:.2e}"
    assert d.max_sv_discarded <= 1e-7 * d.sigma_max * 1.01


def _streamed_fac(n=1024, m=512):
    Phi = _fourier(n, m)
    spec = FacSpec(
        row_tree=uniform_tree(n, 2, 5),
        col_tree=uniform_tree(m, 2, 3),
        row_tree_init_depth=2,
        tol=1e-9,
        min_num_rows=8,
        min_num_cols=8,
    )
    st = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            st.feed(Phi[:, leaf.i0:leaf.i1])
    return Phi, st.get_fac()


def test_distill_from_streamed_fac():
    """Distilling a PartialFac's LinOp — the REAL fac->fused bridge — stays
    within the streamer's own accuracy."""
    Phi, fac = _streamed_fac()
    d = distill_butterfly(fac.as_linop(), 16, rank=None, tol=1e-7,
                          dtype=np.float64)
    x = np.random.default_rng(2).standard_normal((Phi.shape[1], 8))
    y = np.asarray(d.apply(x))
    want = Phi[d.row_perm] @ x
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-6, f"rel {rel:.2e}"


def test_uniformize_fused_einsum_apply():
    """A distilled REAL fac applied by its per-level einsums matches the
    dense oracle, in canonical and in butterfly row order."""
    Phi, fac = _streamed_fac()
    fp = uniformize_fused(fac, tol=1e-7, dtype=np.float32)
    x = np.random.default_rng(3).standard_normal(
        (Phi.shape[1], 8)).astype(np.float32)
    y = np.asarray(fp.apply(x))        # canonical row order
    want = Phi @ x
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 2e-4, f"f32 fused real-fac rel {rel:.2e}"
    # butterfly order output is the same rows, permuted
    yb = np.asarray(fp.apply_butterfly_order(x))
    assert np.allclose(yb, y[fp.dist.row_perm], atol=1e-5)


@pytest.mark.slow
def test_distilled_butterfly_sharded_exchange():
    """The SAME distilled real fac applies through ShardedButterfly's
    explicit all-to-all schedule on an 8-device mesh and matches the
    single-device einsum apply — VERDICT r2 item 6 (unify the islands)."""
    from butterfly_tpu.parallel.shmap_butterfly import ShardedButterfly

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(devs[:8]), ("model",))

    Phi, fac = _streamed_fac(n=2048, m=1024)
    d = distill_butterfly(fac.as_linop(), 64, rank=48, dtype=np.float32)
    sb = ShardedButterfly(d.bf, mesh, axis="model")
    x = np.random.default_rng(4).standard_normal(
        (Phi.shape[1], 8)).astype(np.float32)
    y = np.asarray(sb.unpermute_rows(sb.apply(jnp.asarray(x))))
    want = np.asarray(d.bf.apply(x))
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 2e-6, f"sharded distilled fac rel {rel:.2e}"
    assert sb.exchanged
    # and end-to-end against the dense ground truth
    want_dense = Phi[d.row_perm] @ x
    rel2 = np.linalg.norm(y - want_dense) / np.linalg.norm(want_dense)
    assert rel2 < 1e-3, f"end-to-end rel {rel2:.2e}"


def test_distill_device_batched_ops():
    """The device distillation (batched QR/SVD on-chip, no host math)
    matches the dense oracle at its f32 floor."""
    from butterfly_tpu.fac.distill import distill_butterfly_device

    Phi = _fourier(1024, 512).astype(np.float32)
    d = distill_butterfly_device(jnp.asarray(Phi), 16, rank=64)
    x = np.random.default_rng(5).standard_normal((512, 8)).astype(np.float32)
    y = np.asarray(d.apply_canonical(x), dtype=np.float64)
    want = Phi.astype(np.float64) @ x
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-5, f"device distill rel {rel:.2e}"


def test_stacked_to_interleaved_roundtrip():
    from butterfly_tpu.fac.distill import stacked_to_interleaved

    rng = np.random.default_rng(6)
    A = rng.standard_normal((8, 6)) + 1j * rng.standard_normal((8, 6))
    S = np.block([[A.real, -A.imag], [A.imag, A.real]])
    I_ = np.asarray(stacked_to_interleaved(jnp.asarray(S)))
    z = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    xi = np.empty(12)
    xi[0::2], xi[1::2] = z.real, z.imag
    yi = I_ @ xi
    want = A @ z
    assert np.allclose(yi[0::2] + 1j * yi[1::2], want, atol=1e-12)
