"""Aux subsystems: serialization/checkpoint-resume, profiling, native trees."""

import numpy as np
import pytest

from butterfly_tpu.io.serialization import (
    load_butterfly,
    load_linop,
    load_streamer,
    save_butterfly,
    save_linop,
    save_streamer,
)
from butterfly_tpu.utils.profiling import op_cost, roofline_report


def _roundtrip(tmp_path, op, rng):
    p = str(tmp_path / "op.npz")
    save_linop(p, op)
    back = load_linop(p)
    assert back.shape == op.shape
    x = rng.standard_normal(op.shape[1])
    if np.issubdtype(op.dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(op.shape[1])
    np.testing.assert_allclose(back.matvec(x), op.matvec(x), atol=1e-12)


def test_linop_roundtrip_all_types(tmp_path, rng):
    from butterfly_tpu.ops import (
        BlockCoo, BlockDense, BlockDiag, Coo, Dense, Diag, Diff, Identity,
        Perm, Product, Scaled, Sum, Zero,
    )

    d = Dense(rng.standard_normal((6, 4)))
    ops = [
        d,
        Diag(rng.standard_normal(5), (7, 5)),
        Identity(5),
        Zero((3, 4)),
        Perm(rng.permutation(6)),
        Coo((5, 5), [0, 2], [1, 3], rng.standard_normal(2)),
        Scaled(2.0 + 1j, Dense(rng.standard_normal((3, 3)) + 0j)),
        Product([Dense(rng.standard_normal((4, 6))), d]),
        Sum([Dense(rng.standard_normal((3, 3))), Identity(3)]),
        Diff(Dense(rng.standard_normal((3, 3))), Identity(3)),
        BlockDiag([Dense(rng.standard_normal((2, 3))), Identity(2)]),
        BlockDense([[Dense(rng.standard_normal((2, 2))), Zero((2, 3))]]),
        BlockCoo(
            np.array([0, 2, 4]), np.array([0, 3]), [0, 1], [0, 0],
            [Dense(rng.standard_normal((2, 3))), Dense(rng.standard_normal((2, 3)))],
        ),
    ]
    for op in ops:
        _roundtrip(tmp_path, op, rng)


def test_streamed_fac_roundtrip(tmp_path, rng):
    """A full streamed factorization survives save/load."""
    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.trees import uniform_tree

    x = np.sort(rng.random(128))
    y = np.sort(rng.random(32))
    Phi = np.exp(-((x[:, None] - y[None, :]) ** 2) / 0.25**2)
    spec = FacSpec(row_tree=uniform_tree(128, 2, 3), col_tree=uniform_tree(32, 2, 2),
                   tol=1e-12, min_num_rows=4, min_num_cols=4)
    st = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(2):
        st.feed(Phi[:, leaf.i0 : leaf.i1])
    op = st.get_fac().as_linop()
    _roundtrip(tmp_path, op, rng)


def test_streamer_checkpoint_resume(tmp_path, rng):
    """Checkpoint mid-stream, resume, finish — same result as uninterrupted
    (the resumability SURVEY.md §5 designs for)."""
    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.trees import uniform_tree

    x = np.sort(rng.random(128))
    y = np.sort(rng.random(64))
    Phi = np.exp(-((x[:, None] - y[None, :]) ** 2) / 0.3**2)
    spec = FacSpec(row_tree=uniform_tree(128, 2, 3), col_tree=uniform_tree(64, 2, 2),
                   tol=1e-12, min_num_rows=4, min_num_cols=4)
    leaves = spec.col_tree.nodes_at_depth(2)

    st = FacStreamer(spec)
    st.feed(Phi[:, leaves[0].i0 : leaves[0].i1])
    st.feed(Phi[:, leaves[1].i0 : leaves[1].i1])
    ckpt = str(tmp_path / "streamer.npz")
    save_streamer(ckpt, st)

    st2 = load_streamer(ckpt, spec)
    for leaf in leaves[2:]:
        st2.feed(Phi[:, leaf.i0 : leaf.i1])
    assert st2.is_done()
    rel = np.linalg.norm(st2.get_fac().as_linop().materialize() - Phi) / np.linalg.norm(Phi)
    assert rel < 1e-9


def test_butterfly_checkpoint(tmp_path):
    import jax

    from butterfly_tpu.models.retrieval import CompressedTable
    from butterfly_tpu.ops.butterfly import random_butterfly

    bf = random_butterfly(8, 4, key=jax.random.key(1))
    p = str(tmp_path / "bf.npz")
    save_butterfly(p, bf)
    back = load_butterfly(p)
    x = np.ones(bf.shape[1], np.float32)
    np.testing.assert_allclose(np.asarray(back.apply(x)), np.asarray(bf.apply(x)),
                               atol=1e-6)

    ct = CompressedTable(
        jax.random.normal(jax.random.key(2), (4, 8, 3)),
        jax.random.normal(jax.random.key(3), (4, 3, 5)),
    )
    p2 = str(tmp_path / "ct.npz")
    save_butterfly(p2, ct)
    back2 = load_butterfly(p2)
    np.testing.assert_allclose(
        np.asarray(back2.materialize()), np.asarray(ct.materialize()), atol=1e-6
    )


def test_roofline_report():
    import jax

    from butterfly_tpu.ops.butterfly import random_butterfly

    bf = random_butterfly(8, 16, key=jax.random.key(0))
    rep = roofline_report(bf, num_cols=64, measured_seconds=1e-3,
                         peak_tflops=180.0, hbm_gbps=800.0)
    assert 0 < rep["achieved_frac_sol"]
    assert rep["bound"] in ("compute", "bandwidth")
    c = op_cost(bf)
    assert c.flops_per_col == bf.flops_per_col()


def test_native_tree_matches_numpy(rng):
    from butterfly_tpu.trees import PointTree
    from butterfly_tpu.trees.native import native_available

    if not native_available():
        pytest.skip("native treekit not built")
    pts = rng.standard_normal((2000, 2))
    tn = PointTree(pts, leaf_size=8, use_native=True)
    tp = PointTree(pts, leaf_size=8, use_native=False)
    np.testing.assert_array_equal(tn.perm, tp.perm)
    a = [(n.depth, n.i0, n.i1) for l in tn.levels() for n in l]
    b = [(n.depth, n.i0, n.i1) for l in tp.levels() for n in l]
    assert a == b


def test_device_peaks_known_and_unknown():
    from butterfly_tpu.utils.profiling import device_peaks

    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p.bf16_tflops == 989.0 and p.hbm_gbps == 3350.0
    with pytest.raises(KeyError):
        device_peaks("cpu")


@pytest.mark.parametrize("env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed
    directory inside the checkout."""
    import os

    from butterfly_tpu.utils import cache

    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.compile_cache_dir() == os.path.join(root, ".jax_cache")


def test_bench_level_costs():
    """bench.py's per-level bytes and flops for a small chain."""
    import importlib.util
    import pathlib

    import jax.numpy as jnp

    from butterfly_tpu.ops.butterfly import random_butterfly

    spec = importlib.util.spec_from_file_location(
        "_bench", pathlib.Path(__file__).parent.parent / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bf = random_butterfly(8, 4, dtype=jnp.float32)
    costs = bench.level_costs(bf, r=2, act_bytes=4)
    assert [c[0] for c in costs] == ["leaf", "level0", "level1", "level2"]
    assert sum(c[1] for c in costs) == bf.flops_per_col() * 2
    # weights once, plus each factor's input and output activations
    assert costs[1][2] == bf.levels[0].nbytes + 8 * (4 + 4) * 2 * 4
