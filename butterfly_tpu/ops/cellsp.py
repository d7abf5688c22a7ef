"""Block-sparse cell matmul: the partition apply's assembly step.

The reference applies a multilevel partition by walking a recursive block
graph, one small zgemv per block (src/mat_block_dense.c:574-630). Here the
whole partition is a flat list of *cells*, each one contribution

    y[dst : dst+GM] += W @ src[blk*GK : (blk+1)*GK]

with a (GM, GK) weight tile W and an arbitrary 8-aligned row offset `dst`
(callers embed the sub-8 row shift into the tile, so no row snapping
inflates the weights). A cell with `w=None` is a plain add (identity tile).

The apply is three plain XLA operations per input buffer:

  1. gather the cells' input tiles  xt[t] = buf[src_blk[t]]     (T, GK, r)
  2. one batched matmul             yt[t] = W[t] @ xt[t]          (T, GM, r)
  3. scatter-add yt into the output rows, 8 rows at a time.

The weight stack is stored in cell order, so it streams once with no gather
of its own; the gathered and scattered activations add 2r/GK of the weight
bytes each, which is small next to the weights at the GMRES matvec width.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = ["CellPlan", "Cell", "GM", "GK", "cells_from_dense_block"]

GM = 128  # output rows per cell
GK = 128  # input rows per cell (= source block granularity)
_SUB = 8  # dst granularity: outputs are scattered in 8-row chunks


@dataclasses.dataclass
class Cell:
    """One contribution to the output.

    dst: output row offset (must be 0 mod 8).
    src_buf: input buffer index.
    src_blk: GK-row block index into that buffer.
    w: (GM, GK) float32 weight tile; None for a plain add (GM == GK); or
       ("dev", stack_id, tile_idx) referencing a tile of one of the
       device-resident stacks passed to CellPlan(dev_tiles=...) — used when
       weights are produced on the device, so they never visit the host.
    """

    dst: int
    src_buf: int
    src_blk: int
    w: "np.ndarray | tuple | None"


def _apply_cells(groups, n_out_pad: int, prec, params, bufs):
    """bufs: list of (buf_rows_pad[i], r) arrays. Returns (n_out_pad, r)."""
    import jax.numpy as jnp

    r = bufs[0].shape[1]
    out = jnp.zeros((n_out_pad // _SUB, _SUB, r), jnp.float32)
    sub = jnp.arange(GM // _SUB, dtype=jnp.int32)
    for i, (W, dst8, src) in zip(groups, params):
        xt = bufs[i].reshape(-1, GK, r).astype(jnp.float32)[src]
        yt = jnp.einsum("tmk,tkr->tmr", W, xt, precision=prec,
                        preferred_element_type=jnp.float32)
        rows = (dst8[:, None] + sub[None, :]).reshape(-1)
        out = out.at[rows].add(yt.reshape(-1, _SUB, r),
                               mode="promise_in_bounds")
    return out.reshape(n_out_pad, r)


class CellPlan:
    """Executable block-sparse cell program.

    buf_rows[i] gives the row count of input buffer i; each is padded up to
    a GK multiple by the caller (`pad_rows`). The output has `n_out` rows
    (padded internally; `apply` slices back).
    """

    def __init__(self, n_out: int, buf_rows, cells, precision=None,
                 dev_tiles=None):
        import jax
        import jax.numpy as jnp

        check(len(cells) > 0, "CellPlan needs at least one cell",
              InvalidArgumentsError)
        self._prec = (jax.lax.Precision(precision) if precision is not None
                      else None)
        dev_tiles = list(dev_tiles or [])

        self.n_out = n_out
        # +GM margin: a dst near the end may write into the pad rows;
        # member windows may also overhang the true output end
        self.n_out_pad = -(-(max([n_out] + [c.dst for c in cells]) + GM)
                           // GM) * GM
        self.buf_rows = list(buf_rows)
        self.buf_rows_pad = [-(-b // GK) * GK for b in buf_rows]
        nb = len(buf_rows)

        # merge matmul cells landing on the same (dst, src) position —
        # adjacent blocks sharing a 128-boundary region produce them
        merged: dict = {}
        out: list = []
        for c in cells:
            if c.w is None:
                c = Cell(c.dst, c.src_buf, c.src_blk,
                         np.eye(GM, GK, dtype=np.float32))
            if isinstance(c.w, tuple):
                out.append(c)
                continue
            key = (c.dst, c.src_buf, c.src_blk)
            if key in merged:
                prev = out[merged[key]]
                out[merged[key]] = Cell(c.dst, c.src_buf, c.src_blk,
                                        prev.w + c.w)
            else:
                merged[key] = len(out)
                out.append(c)
        # one group per input buffer, each in output-row order
        cells = sorted(out, key=lambda c: (c.src_buf, c.dst, c.src_blk))

        T = len(cells)
        dst8 = np.empty(T, np.int32)
        src = np.empty(T, np.int32)
        widx = np.empty(T, np.int64)
        wlist = []
        dev_refs = []  # (t, stack_id, tile_idx), resolved after the host stack
        for t, c in enumerate(cells):
            check(c.dst % _SUB == 0, "cell dst must be 8-aligned",
                  InvalidArgumentsError)
            check(0 <= c.src_buf < nb, "cell src_buf out of range",
                  InvalidArgumentsError)
            check(c.dst + GM <= self.n_out_pad,
                  "cell dst beyond padded output", InvalidArgumentsError)
            check((c.src_blk + 1) * GK <= self.buf_rows_pad[c.src_buf],
                  "cell src_blk beyond padded buffer", InvalidArgumentsError)
            dst8[t] = c.dst // _SUB
            src[t] = c.src_blk
            if isinstance(c.w, tuple):
                check(len(c.w) == 3 and c.w[0] == "dev",
                      "device tile ref must be ('dev', stack, idx)",
                      InvalidArgumentsError)
                dev_refs.append((t, c.w[1], c.w[2]))
            else:
                check(c.w.shape == (GM, GK), "weight tile must be (GM, GK)",
                      InvalidArgumentsError)
                widx[t] = len(wlist)
                wlist.append(np.asarray(c.w, np.float32))
        # the combined stack is [host tiles | dev stack 0 | dev stack 1 ...]
        stack_base = [len(wlist)]
        for sdev in dev_tiles:
            check(sdev.ndim == 3 and sdev.shape[1:] == (GM, GK),
                  "dev_tiles stacks must be (n, GM, GK)",
                  InvalidArgumentsError)
            stack_base.append(stack_base[-1] + sdev.shape[0])
        for t, sid, tidx in dev_refs:
            check(0 <= sid < len(dev_tiles), "dev stack id out of range",
                  InvalidArgumentsError)
            check(0 <= tidx < dev_tiles[sid].shape[0],
                  "dev tile index out of range", InvalidArgumentsError)
            widx[t] = stack_base[sid] + tidx

        stacks = [jnp.asarray(np.stack(wlist))] if wlist else []
        stacks += [s.astype(jnp.float32) for s in dev_tiles]
        dev_tiles.clear()  # the caller's stacks are copied into ours below
        Wall = stacks[0] if len(stacks) == 1 else jnp.concatenate(stacks)
        del stacks

        groups, params = [], []
        bufs_of = np.array([c.src_buf for c in cells])
        for i in range(nb):
            sel = np.nonzero(bufs_of == i)[0]
            if sel.size == 0:
                continue
            groups.append(i)
            params.append((
                jax.block_until_ready(Wall[jnp.asarray(widx[sel])]),
                jnp.asarray(dst8[sel]), jnp.asarray(src[sel])))
        del Wall
        self._groups = tuple(groups)
        self.params = params
        self.num_cells = T
        self._flops = 2 * GM * GK * T
        self._nbytes = T * GM * GK * 4

    # ---- functional apply (safe to close over inside jit) -------------------

    def apply_padded(self, params, bufs, r_pad: int):
        """bufs already padded to (buf_rows_pad[i], r_pad); returns the
        padded output (n_out_pad, r_pad). Jit-friendly."""
        del r_pad  # the XLA form takes any width
        return _apply_cells(self._groups, self.n_out_pad, self._prec,
                            params, bufs)

    def pad_rows(self, i: int, buf):
        import jax.numpy as jnp

        pad = self.buf_rows_pad[i] - buf.shape[0]
        return buf if pad == 0 else jnp.pad(buf, ((0, pad), (0, 0)))

    def round_r(self, r: int) -> int:
        return r

    def apply(self, bufs):
        """Convenience: takes unpadded bufs (n_i, r), returns (n_out, r)."""
        r = bufs[0].shape[1]
        padded = [self.pad_rows(i, b) for i, b in enumerate(bufs)]
        y = self.apply_padded(self.params, padded, r)
        return y[: self.n_out, :r]

    def flops_per_col(self) -> int:
        return self._flops

    def nbytes(self) -> int:
        return self._nbytes


def cells_from_dense_block(W, i0: int, j0: int, out_cells: list) -> None:
    """Decompose one dense block (nr, nc) at row/col offset (i0, j0) into
    GM x GK cells appended to `out_cells`. The sub-8 row shift is embedded
    into the weight tiles, so `dst` stays 8-aligned with at most 7 rows of
    zero padding — no 128-row snapping inflation."""
    W = np.asarray(W, np.float32)
    nr, nc = W.shape
    shift_r = i0 % 8
    dst0 = i0 - shift_r
    c0 = j0 // GK
    shift_c = j0 % GK
    nrch = -(-(shift_r + nr) // GM)
    ncch = -(-(shift_c + nc) // GK)
    P = np.zeros((nrch * GM, ncch * GK), np.float32)
    P[shift_r:shift_r + nr, shift_c:shift_c + nc] = W
    for rch in range(nrch):
        for cch in range(ncch):
            tile = P[rch * GM:(rch + 1) * GM, cch * GK:(cch + 1) * GK]
            if not tile.any():
                continue
            out_cells.append(Cell(dst=dst0 + rch * GM, src_buf=0,
                                  src_blk=c0 + cch, w=tile))
