"""Block-sparse cell apply (ops/cellsp.py) against dense products."""

import numpy as np
import pytest

from butterfly_tpu.ops.cellsp import GK, GM, Cell, CellPlan, \
    cells_from_dense_block


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _dense_from_cells(cells, n_out, n_in):
    A = np.zeros((n_out, n_in))
    for c in cells:
        if c.w is None:
            A[c.dst:c.dst + GM, c.src_blk * GK:(c.src_blk + 1) * GK] += \
                np.eye(GM)
        else:
            A[c.dst:c.dst + GM, c.src_blk * GK:(c.src_blk + 1) * GK] += c.w
    return A


def test_cells_from_dense_block_roundtrip(rng):
    W = rng.standard_normal((70, 150)).astype(np.float32)
    i0, j0 = 34, 202  # arbitrary even offsets (8-shift + col split)
    cells = []
    cells_from_dense_block(W, i0, j0, cells)
    n_out, n_in = 512, 512
    A = _dense_from_cells(cells, n_out, n_in)
    want = np.zeros((n_out, n_in))
    want[i0:i0 + 70, j0:j0 + 150] = W
    assert np.allclose(A, want)


def test_cell_plan_matches_dense(rng):
    n_out, n_in = 640, 512
    cells = []
    for _ in range(6):
        i0 = int(rng.integers(0, (n_out - 200) // 2)) * 2
        j0 = int(rng.integers(0, (n_in - 200) // 2)) * 2
        W = rng.standard_normal(
            (int(rng.integers(16, 180)), int(rng.integers(16, 180)))
        ).astype(np.float32) / 8
        cells_from_dense_block(W, i0, j0, cells)
    A = _dense_from_cells(cells, n_out + GM, n_in)
    plan = CellPlan(n_out, [n_in], cells, precision="highest")
    x = rng.standard_normal((n_in, 36)).astype(np.float32)
    y = np.asarray(plan.apply([x]))
    want = (A @ x)[:n_out]
    rel = np.linalg.norm(y - want) / max(np.linalg.norm(want), 1e-30)
    assert rel < 1e-5, f"cell plan rel {rel:.2e}"


def test_cell_plan_many_cells_one_dst(rng):
    """Many cells from different source blocks land on the same output
    rows: the scatter-add must sum all of them."""
    n_out, n_in = 256, 1024
    cells = []
    for blk in range(n_in // GK):
        W = rng.standard_normal((GM, GK)).astype(np.float32) / 8
        cells.append(Cell(dst=40, src_buf=0, src_blk=blk, w=W))
    plan = CellPlan(n_out, [n_in], cells, precision="highest")
    A = _dense_from_cells(cells, plan.n_out_pad, n_in)
    x = rng.standard_normal((n_in, 8)).astype(np.float32)
    y = np.asarray(plan.apply([x]))
    want = (A @ x)[:n_out]
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-5, f"many cells on one dst rel {rel:.2e}"


def test_cell_plan_empty_output_tiles(rng):
    """Output tiles no cell touches come out exactly zero."""
    n_out, n_in = 2048, 256
    cells = []
    W = rng.standard_normal((100, 100)).astype(np.float32)
    cells_from_dense_block(W, 8, 0, cells)
    cells_from_dense_block(W, 1800, 100, cells)
    plan = CellPlan(n_out, [n_in], cells, precision="highest")
    x = rng.standard_normal((n_in, 4)).astype(np.float32)
    y = np.asarray(plan.apply([x]))
    assert np.all(y[128:1792] == 0.0)
    A = _dense_from_cells(cells, plan.n_out_pad, n_in)
    want = (A @ x)[:n_out]
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.parametrize("r", [1, 36, 130])
def test_cell_plan_any_width(rng, r):
    """r need not be a multiple of 128 (the GMRES matvec has r=1)."""
    n_out, n_in = 512, 384
    cells = []
    W = rng.standard_normal((300, 250)).astype(np.float32) / 8
    cells_from_dense_block(W, 104, 66, cells)
    plan = CellPlan(n_out, [n_in], cells, precision="highest")
    A = _dense_from_cells(cells, plan.n_out_pad, n_in)
    x = rng.standard_normal((n_in, r)).astype(np.float32)
    y = np.asarray(plan.apply([x]))
    assert y.shape == (n_out, r)
    want = (A @ x)[:n_out]
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


def test_cell_plan_add_cells_and_multibuf(rng):
    """kind-1 add cells assemble a second buffer's rows into the output."""
    n_out, n_in, n_t = 512, 256, 256
    cells = []
    W = rng.standard_normal((128, 128)).astype(np.float32) / 8
    cells_from_dense_block(W, 0, 0, cells)
    # add buffer-1 block 1 at dst 128, and block 0 at dst 256+8
    cells.append(Cell(dst=128, src_buf=1, src_blk=1, w=None))
    cells.append(Cell(dst=264, src_buf=1, src_blk=0, w=None))
    plan = CellPlan(n_out, [n_in, n_t], cells, precision="highest")
    x = rng.standard_normal((n_in, 12)).astype(np.float32)
    tbuf = rng.standard_normal((n_t, 12)).astype(np.float32)
    y = np.asarray(plan.apply([x, tbuf]))
    want = np.zeros((n_out, 12), np.float32)
    want[:128] = W @ x[:128]
    want[128:256] += tbuf[128:256]
    want[264:264 + 128] += tbuf[0:128]
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 1e-5


def _mixed_plan(rng):
    """A two-buffer plan with host tiles, device tiles and plain adds."""
    import jax.numpy as jnp

    n_out, n_in, n_t = 1024, 512, 256
    cells = []
    for _ in range(8):
        i0 = int(rng.integers(0, (n_out - 200) // 2)) * 2
        j0 = int(rng.integers(0, (n_in - 200) // 2)) * 2
        W = rng.standard_normal((int(rng.integers(16, 180)),
                                 int(rng.integers(16, 180)))) / 8
        cells_from_dense_block(W.astype(np.float32), i0, j0, cells)
    A = np.zeros((n_out + 2 * GM, n_in + n_t))
    for c in cells:
        A[c.dst:c.dst + GM, c.src_blk * GK:(c.src_blk + 1) * GK] += c.w
    dev = rng.standard_normal((3, GM, GK)).astype(np.float32)
    cells.append(Cell(dst=520, src_buf=1, src_blk=0, w=("dev", 0, 2)))
    A[520:520 + GM, n_in:n_in + GK] += dev[2]
    cells.append(Cell(dst=264, src_buf=1, src_blk=1, w=None))
    A[264:264 + GM, n_in + GK:n_in + 2 * GK] += np.eye(GM)
    plan = CellPlan(n_out, [n_in, n_t], cells, precision="highest",
                    dev_tiles=[jnp.asarray(dev)])
    return plan, A[:n_out], n_in, n_t


@pytest.mark.parametrize("r", [1, 20, 70])
def test_cell_plan_mixed_sources(rng, r):
    """Host tiles, device tiles and plain adds over two input buffers, with
    cells that straddle two 128-row output tiles."""
    plan, A, n_in, n_t = _mixed_plan(rng)
    x = rng.standard_normal((n_in, r)).astype(np.float32)
    t = rng.standard_normal((n_t, r)).astype(np.float32)
    want = A @ np.vstack([x, t])
    y = np.asarray(plan.apply([x, t]))
    assert y.shape == want.shape
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.gpu
def test_cell_plan_on_gpu(gpu, rng):
    """On the card, the cell apply matches the dense product at the GMRES
    width and at a block width."""
    plan, A, n_in, n_t = _mixed_plan(rng)
    for r in (1, 64):
        x = rng.standard_normal((n_in, r)).astype(np.float32)
        t = rng.standard_normal((n_t, r)).astype(np.float32)
        want = A @ np.vstack([x, t])
        y = np.asarray(plan.apply([x, t]), np.float64)
        assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5
