"""The packed device runtime: LinOp trees -> level-synchronous batched GEMMs.

This is the device replacement for the reference's interpreted apply path, where
every matvec walks a recursive object graph making one tiny BLAS call per
block (reference: bfMatBlockDenseMulVec src/mat_block_dense.c:574-630,
MatProduct apply src/fac.c:133-146 — SURVEY.md §3.2 identifies this stack as
the metric-critical path). Here the graph is flattened ONCE at pack time into
a `StagePlan`:

- every leaf dense block becomes a GEMM *unit* with global gather (input) and
  scatter-add (output) index ranges;
- every Identity/Diag/Perm block becomes a *scale unit* (gather, multiply,
  scatter) with no FLOPs;
- units are scheduled into *stages* (factor k of a Product chain runs at
  stage k; different chains of a multilevel factorization overlap stages);
- within a (stage, output-buffer) group, units are *bucketed* by padded block
  shape: one bucket = one batched (B, m, k) x (B, k, r) einsum;
- the inter-level butterfly re-blocking is carried entirely by the gather /
  scatter index tables — XLA sees static indices and fuses the gathers into
  the GEMMs.

Apply is a single jit-compiled function per plan: ~#levels batched GEMMs,
no Python in the loop, no dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from butterfly_tpu.ops import linop as L
from butterfly_tpu.utils.errors import NotImplementedButterflyError, check

__all__ = ["StagePlan", "pack", "PackedApplyStats"]


# ---------------------------------------------------------------------------
# Flattening: LinOp tree -> chains of single-stage factors of units
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _GemmUnit:
    data: np.ndarray  # (m, k) dense block
    in_off: int  # offset into the chain-stage input vector
    out_off: int  # offset into the chain-stage output vector


@dataclasses.dataclass
class _ScaleUnit:
    weights: np.ndarray  # (L,) elementwise weights; in/out are index ARRAYS
    in_idx: np.ndarray  # (L,) chain-stage-relative input indices
    out_idx: np.ndarray  # (L,) chain-stage-relative output indices


@dataclasses.dataclass
class _Factor:
    in_dim: int
    out_dim: int
    gemms: list[_GemmUnit]
    scales: list[_ScaleUnit]


@dataclasses.dataclass
class _Chain:
    i0: int  # global output row offset
    j0: int  # global input col offset
    factors: list[_Factor]  # applied first-to-last
    src: object = None      # the Product LinOp this chain came from
    src_scale: complex | float = 1.0  # scale folded into the first factor


def _single_stage(op: L.LinOp, scale: complex | float = 1.0) -> _Factor:
    """Flatten `op` into ONE stage of units; raises if impossible."""
    m, n = op.shape
    f = _Factor(in_dim=n, out_dim=m, gemms=[], scales=[])

    def add(sub: L.LinOp, i0: int, j0: int, s) -> None:
        if isinstance(sub, L.Scaled):
            add(sub.op, i0, j0, s * sub.alpha)
        elif isinstance(sub, L.Dense):
            data = sub.data if s == 1.0 else s * sub.data
            f.gemms.append(_GemmUnit(np.asarray(data), j0, i0))
        elif isinstance(sub, L.Identity):
            k = sub.shape[0]
            f.scales.append(
                _ScaleUnit(
                    np.full(k, s), np.arange(j0, j0 + k), np.arange(i0, i0 + k)
                )
            )
        elif isinstance(sub, L.Diag):
            k = sub.diag.size
            f.scales.append(
                _ScaleUnit(
                    s * sub.diag, np.arange(j0, j0 + k), np.arange(i0, i0 + k)
                )
            )
        elif isinstance(sub, L.Perm):
            k = sub.perm.size
            f.scales.append(
                _ScaleUnit(np.full(k, s), j0 + sub.perm, i0 + np.arange(k))
            )
        elif isinstance(sub, L.Zero):
            pass
        elif isinstance(sub, L.BlockDiag):
            for kk, b in enumerate(sub.blocks):
                add(b, i0 + int(sub.row_offsets[kk]), j0 + int(sub.col_offsets[kk]), s)
        elif isinstance(sub, L.BlockCoo):
            for kk, b in enumerate(sub.blocks):
                bi, bj = int(sub.row_inds[kk]), int(sub.col_inds[kk])
                add(b, i0 + int(sub.row_offsets[bi]), j0 + int(sub.col_offsets[bj]), s)
        elif isinstance(sub, L.BlockDense):
            for bi, row in enumerate(sub.grid):
                for bj, b in enumerate(row):
                    add(
                        b,
                        i0 + int(sub.row_offsets[bi]),
                        j0 + int(sub.col_offsets[bj]),
                        s,
                    )
        else:
            raise NotImplementedButterflyError(
                f"cannot pack {type(sub).__name__} as a single stage"
            )

    add(op, 0, 0, scale)
    return f


def _expand_product(op: L.LinOp) -> list[L.LinOp]:
    """Application-order factor list with nested Products inlined."""
    if isinstance(op, L.Product):
        out: list[L.LinOp] = []
        for f in reversed(op.factors):
            out.extend(_expand_product(f))
        return out
    return [op]


def _flatten(op: L.LinOp, i0: int, j0: int, chains: list[_Chain],
             scale: complex | float = 1.0) -> None:
    """Flatten into chains (multi-stage leaf paths positioned at (i0, j0))."""
    if isinstance(op, L.Scaled):
        _flatten(op.op, i0, j0, chains, scale * op.alpha)
    elif isinstance(op, L.Product):
        factors = _expand_product(op)  # application order, nested flattened
        staged = []
        for idx, f in enumerate(factors):
            # fold the scalar into the first factor only
            staged.append(_single_stage(f, scale if idx == 0 else 1.0))
        chains.append(_Chain(i0, j0, staged, src=op, src_scale=scale))
    elif isinstance(op, L.BlockDense):
        for bi, row in enumerate(op.grid):
            for bj, b in enumerate(row):
                _flatten(
                    b,
                    i0 + int(op.row_offsets[bi]),
                    j0 + int(op.col_offsets[bj]),
                    chains,
                    scale,
                )
    elif isinstance(op, L.BlockDiag):
        for kk, b in enumerate(op.blocks):
            _flatten(
                b, i0 + int(op.row_offsets[kk]), j0 + int(op.col_offsets[kk]),
                chains, scale,
            )
    elif isinstance(op, L.BlockCoo):
        for kk, b in enumerate(op.blocks):
            bi, bj = int(op.row_inds[kk]), int(op.col_inds[kk])
            _flatten(
                b, i0 + int(op.row_offsets[bi]), j0 + int(op.col_offsets[bj]),
                chains, scale,
            )
    elif isinstance(op, L.Sum):
        for t in op.terms:
            _flatten(t, i0, j0, chains, scale)
    elif isinstance(op, L.Diff):
        _flatten(op.a, i0, j0, chains, scale)
        _flatten(op.b, i0, j0, chains, -scale)
    else:
        # single-stage leaf (Dense / Identity / Diag / Perm / Zero / nested
        # block-of-dense)
        chains.append(_Chain(i0, j0, [_single_stage(op, scale)]))


# ---------------------------------------------------------------------------
# Bucketing and the executable plan
# ---------------------------------------------------------------------------


def _round_up(x: int, align: int) -> int:
    if x <= align:
        # small dims: next power of two, at least 1
        p = 1
        while p < x:
            p <<= 1
        return p
    return -(-x // align) * align


# ---------------------------------------------------------------------------
# Group tiling: collapse ragged (stage, buffer) groups to 1-2 GEMM buckets
# ---------------------------------------------------------------------------
#
# Shape-bucketing alone leaves real factorizations dispatch-bound: the
# multilevel Helmholtz plan measured 43 buckets over 5 stages and ran at 3%
# of its own speed of light — each bucket is one einsum whose fixed issue
# cost (a few us) dwarfs its tiny matmul work. Tiling instead SPLITS every
# dense block of a (stage, write-buffer) group onto one (or two) uniform tile
# shapes: edge tiles are zero-padded, k-direction splits accumulate through
# the executor's take-sum tables, m-direction splits just read their input
# window twice. One bucket then equals one batched einsum per stage.

# Fixed per-bucket issue cost, expressed in per-column flops at a nominal
# r=256 column count: ~2e6 padded flops per column (a few us of dispatch at
# a large matmul rate). A model constant, not measured on the H100.
_BUCKET_OVERHEAD_FLOPS = 1 << 21


def _eff_dim(x: int, gran: int) -> int:
    """Effective matmul-occupied size of a dim (matmul units pad tiles to
    a hardware granularity)."""
    return max(gran, _round_up(x, gran))


def _tile_cost(dims: "list[tuple[int, int]]", tm: int, tk: int) -> int:
    """Modeled per-column flops of one bucket holding `dims` split on a
    (tm, tk) tile, with matmul granularity applied to the tile itself."""
    tme, tke = _eff_dim(tm, 8), _eff_dim(tk, 128)
    return sum(
        2 * -(-m // tm) * tme * -(-k // tk) * tke for m, k in dims
    )


def _best_single_tile(dims, cand_m, cand_k):
    best = None
    for tm in cand_m:
        for tk in cand_k:
            c = _tile_cost(dims, tm, tk)
            if best is None or c < best[0]:
                best = (c, tm, tk)
    return best


def _plan_group_tiling(dims, block_align, overhead=_BUCKET_OVERHEAD_FLOPS):
    """Choose tile buckets for one (stage, write-buffer) group.

    Returns (cost, [(tm, tk, member_index_list), ...]) with 1 or 2 buckets,
    whichever minimizes modeled flops + per-bucket overhead. Candidates are
    the distinct padded dims present in the group, so a rank-homogeneous
    group keeps its natural shape and pays zero extra padding.
    """
    pm = sorted({_round_up(m, block_align) for m, _ in dims})
    pk = sorted({_round_up(k, block_align) for _, k in dims})
    all_idx = list(range(len(dims)))
    c1, tm1, tk1 = _best_single_tile(dims, pm, pk)
    best = (c1 + overhead, [(tm1, tk1, all_idx)])
    if len(pk) > 1 or len(pm) > 1:
        # 2-bucket partitions: split on a k threshold or an m threshold
        for axis in (0, 1):
            vals = pm if axis == 0 else pk
            for thr in vals[:-1]:
                A = [i for i in all_idx
                     if _round_up(dims[i][axis], block_align) <= thr]
                B = [i for i in all_idx if i not in A]
                if not A or not B:
                    continue
                dA = [dims[i] for i in A]
                dB = [dims[i] for i in B]
                cA, tmA, tkA = _best_single_tile(
                    dA, sorted({_round_up(m, block_align) for m, _ in dA}),
                    sorted({_round_up(k, block_align) for _, k in dA}))
                cB, tmB, tkB = _best_single_tile(
                    dB, sorted({_round_up(m, block_align) for m, _ in dB}),
                    sorted({_round_up(k, block_align) for _, k in dB}))
                cost = cA + cB + 2 * overhead
                if cost < best[0]:
                    best = (cost, [(tmA, tkA, A), (tmB, tkB, B)])
    return best


def _split_into_tiles(data: np.ndarray, jbase: int, ibase: int,
                      tm: int, tk: int):
    """Yield (tile_data, jbase_tile, ibase_tile) unit tiles covering `data`."""
    m, k = data.shape
    for i0 in range(0, m, tm):
        mm = min(tm, m - i0)
        for j0 in range(0, k, tk):
            kk = min(tk, k - j0)
            yield (data[i0:i0 + mm, j0:j0 + kk], jbase + j0, ibase + i0)


@dataclasses.dataclass
class _GemmBucket:
    """Every GEMM unit reads/writes a CONTIGUOUS row range of its buffer in
    the op's LOGICAL coordinates; the executor compiles these into unrolled
    activation layouts + one exchange take per stage (see _apply_plan)."""

    weights: jnp.ndarray  # (B, m_pad, k_pad) padded, pad entries zero
    in_start: np.ndarray  # (B,) int32 logical row starts (read side)
    out_start: np.ndarray  # (B,) int32 logical row starts (write side)
    mms: np.ndarray  # (B,) true (unpadded) output rows per unit
    kks: np.ndarray  # (B,) true (unpadded) input rows per unit
    read_buf: int
    write_buf: int
    flops_real: int  # unpadded useful flops per RHS column (x2 for mul-add)


@dataclasses.dataclass
class _ScaleBucket:
    weights: jnp.ndarray  # (L,)
    in_idx: jnp.ndarray  # (L,) int32
    out_idx: jnp.ndarray  # (L,) int32
    read_buf: int
    write_buf: int


@dataclasses.dataclass
class PackedApplyStats:
    num_stages: int
    num_gemm_buckets: int
    num_scale_buckets: int
    useful_flops_per_col: int  # 2*m*k summed over gemm units
    padded_flops_per_col: int
    weight_bytes: int
    padding_waste: float  # 1 - useful/padded


class StagePlan:
    """Executable packed form of a LinOp: buffers + bucketed stages.

    `real_embed`: map a complex operator onto REAL buffers via the standard
    2x2 embedding — every buffer of size S becomes [Re; Im] of size 2S and a
    complex block Z = A + iB becomes four real GEMM units (A, -B, B, A) wired
    between the halves. Callers that feed real-only consumers (the partition
    apply's interleaved layout, the real GMRES drivers) ask for it; by
    default a complex operator keeps native complex buffers. Flop accounting
    stays exact: 4 real (m, k) units = 8mk flops = one complex madd's cost.
    """

    def __init__(self, op: L.LinOp, dtype=None, block_align: int = 128,
                 real_embed: bool = False,
                 precision: str | None = "highest",
                 tiling: str = "uniform",
                 params_on_host: bool = False):
        # params_on_host: keep weights + index tables as HOST numpy arrays.
        # Each jitted apply then streams them host-to-device per call (they
        # are jit ARGUMENTS, so no retrace) and XLA frees the transfer
        # buffers when the call's consumers finish — resident device memory
        # is ~one plan's weights at a time instead of all plans at once.
        # Used by the partition apply's oversized-block sub-plans when the
        # resident cell weights leave too little device memory.
        self._params_on_host = bool(params_on_host)
        _dev = (np.asarray if params_on_host else jnp.asarray)
        m, n = op.shape
        # Packed plans serve the ACCURACY-critical factorized-operator path
        # and are overhead/bandwidth-bound, so full-f32 products are close
        # to free: default to HIGHEST so the device apply holds the
        # reference's rel-err budget (a default-precision f32 product may
        # run in TF32, ~3 decimal digits).
        self._precision = (
            None if precision is None else jax.lax.Precision(precision)
        )
        self.shape = (m, n)
        op_complex = np.issubdtype(op.dtype, np.complexfloating)
        if dtype is None:
            dtype = jnp.complex64 if op_complex else jnp.float32
        dtype = jnp.dtype(dtype)
        self.real_embed = bool(real_embed) and np.issubdtype(
            dtype, np.complexfloating
        )
        if self.real_embed:
            # compute in the matching real dtype; split/recombine at the edges
            self._io_dtype = dtype
            dtype = jnp.dtype(np.zeros(0, dtype).real.dtype)
        self.dtype = dtype

        chains: list[_Chain] = []
        _flatten(op, 0, 0, chains)
        num_stages = max(len(c.factors) for c in chains)

        # Assign global offsets for each chain's intermediate vectors.
        # Buffer 0 is the input (size n); buffer t in 1..num_stages-1 holds
        # intermediates of chains still in flight; the OUTPUT buffer is
        # addressed separately (write_buf == -1 means output).
        buf_sizes = [n] + [0] * (num_stages - 1)
        chain_offsets: list[list[int]] = []  # per chain: offset of stage-t input
        for c in chains:
            offs = [c.j0]  # stage-0 input is the global input at j0
            for t in range(1, len(c.factors)):
                offs.append(buf_sizes[t])
                buf_sizes[t] += c.factors[t].in_dim
            chain_offsets.append(offs)
        # Collect units with global indices (original, un-embedded buffers).
        raw_gemms: list[tuple] = []  # (t, write_buf, data, in_base, out_base)
        raw_scales: list[tuple] = []  # (t, write_buf, weights, in_idx, out_idx)
        for c, offs in zip(chains, chain_offsets):
            last = len(c.factors) - 1
            for t, f in enumerate(c.factors):
                in_base = offs[t]
                write_buf = -1 if t == last else t + 1
                out_base = c.i0 if t == last else offs[t + 1]
                for u in f.gemms:
                    raw_gemms.append(
                        (t, write_buf, u.data, in_base + u.in_off,
                         out_base + u.out_off)
                    )
                for u in f.scales:
                    raw_scales.append(
                        (t, write_buf, u.weights, in_base + u.in_idx,
                         out_base + u.out_idx)
                    )

        if self.real_embed:
            # Buffer convention: size-S complex buffer -> size-2S real buffer
            # holding [Re; Im]. Complex Z = A + iB becomes the 2x2 real block
            # [[A, -B], [B, A]]: four (m, k) units between the halves (real
            # data keeps just the two diagonal copies).
            def in_half(t):
                return buf_sizes[t]

            def out_half(wb):
                return m if wb == -1 else buf_sizes[wb]

            eg, es = [], []
            for (t, wb, data, jb, ib) in raw_gemms:
                si, so = in_half(t), out_half(wb)
                A = np.ascontiguousarray(data.real)
                eg.append((t, wb, A, jb, ib))
                eg.append((t, wb, A, si + jb, so + ib))
                if np.issubdtype(data.dtype, np.complexfloating):
                    B = np.ascontiguousarray(data.imag)
                    if np.any(B):
                        eg.append((t, wb, -B, si + jb, ib))
                        eg.append((t, wb, B, jb, so + ib))
            for (t, wb, w, iix, oix) in raw_scales:
                si, so = in_half(t), out_half(wb)
                wr = np.ascontiguousarray(np.asarray(w).real)
                es.append((t, wb, wr, iix, oix))
                es.append((t, wb, wr, si + iix, so + oix))
                if np.issubdtype(np.asarray(w).dtype, np.complexfloating):
                    wi = np.ascontiguousarray(np.asarray(w).imag)
                    if np.any(wi):
                        es.append((t, wb, -wi, si + iix, oix))
                        es.append((t, wb, wi, iix, so + oix))
            raw_gemms, raw_scales = eg, es
            buf_sizes = [2 * s for s in buf_sizes]
            m = 2 * m

        self.buf_sizes = buf_sizes
        self.out_size = m

        # Bucket the GEMM units. tiling="uniform" (default) collapses each
        # (stage, write-buffer) group onto 1-2 uniform tile shapes chosen by
        # the cost model above — ragged blocks are SPLIT into tiles, so a
        # real factorization applies as ~#stages batched einsums instead of
        # one einsum per distinct padded shape (43 for the r2 helm2 plan).
        # tiling="shape" keeps the per-padded-shape buckets for comparison.
        check(tiling in ("uniform", "shape"),
              f"unknown tiling mode {tiling!r}")
        gemm_groups: dict[tuple, list] = {}
        scale_groups: dict[tuple, list] = {}
        stage_units: dict[tuple, list] = {}
        for (t, write_buf, data, jbase, ibase) in raw_gemms:
            stage_units.setdefault((t, write_buf), []).append(
                (data, jbase, ibase)
            )
        for (t, write_buf), units in stage_units.items():
            if tiling == "shape":
                for (data, jbase, ibase) in units:
                    mm, kk = data.shape
                    key = (t, write_buf, _round_up(mm, block_align),
                           _round_up(kk, block_align))
                    gemm_groups.setdefault(key, []).append(
                        (data, jbase, ibase))
                continue
            dims = [u[0].shape for u in units]
            _, buckets = _plan_group_tiling(dims, block_align)
            for tm, tk, members in buckets:
                key = (t, write_buf, tm, tk)
                for i in members:
                    data, jbase, ibase = units[i]
                    for tile in _split_into_tiles(data, jbase, ibase, tm, tk):
                        gemm_groups.setdefault(key, []).append(tile)
        for (t, write_buf, w, iix, oix) in raw_scales:
            scale_groups.setdefault((t, write_buf), []).append((w, iix, oix))

        # Materialize buckets. Weights are zero-padded to the bucket tile, so
        # padded input rows multiply zero columns and padded output rows are
        # exact zeros — the executor's index tables exploit both.
        self._gemm_buckets: list[_GemmBucket] = []
        self._scale_buckets: list[_ScaleBucket] = []
        useful = 0
        padded = 0
        weight_bytes = 0
        for (t, wb, mp, kp), units in sorted(gemm_groups.items()):
            B = len(units)
            W = np.zeros((B, mp, kp), dtype=self.dtype)
            in_start = np.zeros(B, dtype=np.int64)
            out_start = np.zeros(B, dtype=np.int64)
            mms = np.zeros(B, dtype=np.int64)
            kks = np.zeros(B, dtype=np.int64)
            fl = 0
            for b, (data, jbase, ibase) in enumerate(units):
                mm, kk = data.shape
                W[b, :mm, :kk] = data
                in_start[b] = jbase
                out_start[b] = ibase
                mms[b] = mm
                kks[b] = kk
                fl += 2 * mm * kk
            useful += fl
            padded += 2 * B * mp * kp
            weight_bytes += W.nbytes
            self._gemm_buckets.append(
                _GemmBucket(_dev(W), in_start, out_start, mms, kks,
                            t, wb, fl)
            )
        for (t, wb), units in sorted(scale_groups.items()):
            wts = np.concatenate([np.asarray(w) for w, _, _ in units])
            iix = np.concatenate([np.asarray(i) for _, i, _ in units])
            oix = np.concatenate([np.asarray(o) for _, _, o in units])
            self._scale_buckets.append(
                _ScaleBucket(
                    _dev(wts.astype(self.dtype)),
                    iix.astype(np.int64), oix.astype(np.int64), t, wb,
                )
            )

        self.stats = PackedApplyStats(
            num_stages=num_stages,
            num_gemm_buckets=len(self._gemm_buckets),
            num_scale_buckets=len(self._scale_buckets),
            useful_flops_per_col=useful,
            padded_flops_per_col=padded,
            weight_bytes=weight_bytes,
            padding_waste=1.0 - useful / max(padded, 1),
        )
        self.num_stages = num_stages

        # -- compile the buckets into the exchange-table executor ----------
        # Per stage, activations live UNROLLED: every unit's (padded) input
        # window is a contiguous region, so reads are static slices and the
        # whole inter-stage re-blocking (the butterfly exchange) is ONE take
        # with a precomputed (rows, c_max) table into the previous stage's
        # concatenated outputs, followed by a length-c_max dense sum for rows
        # with multiple contributors. No scatter anywhere.
        # Weights and index tables are passed as jit ARGUMENTS, never
        # closure constants — XLA can compile embedded
        # constant gathers to a pathological path ~400x slower (measured).

        # read_coords[t]: logical coordinate each unrolled activation row of
        #   stage t wants (-1 = guaranteed zero).
        # write maps[t][target]: per logical coordinate, the y_cat row ids
        #   produced at stage t that accumulate there.
        read_coords: list[np.ndarray] = []
        stage_metas = []
        stage_weights = []
        writer_lists: list[dict[int, tuple[np.ndarray, np.ndarray]]] = []
        for t in range(num_stages):
            coords_list: list[np.ndarray] = []
            gemm_metas: list[_StageGemm] = []
            Ws: list = []
            scale_metas: list[_StageScale] = []
            ws: list = []
            # (target) -> list of (y_row_ids, logical coords) contributions
            wl: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
            in_off = 0
            y_off = 0
            for b in self._gemm_buckets:
                if b.read_buf != t:
                    continue
                B, mp, kp = b.weights.shape
                c = b.in_start[:, None] + np.arange(kp)[None, :]
                c[np.arange(kp)[None, :] >= b.kks[:, None]] = -1
                coords_list.append(c.reshape(-1))
                gemm_metas.append(_StageGemm(in_off, B, mp, kp, b.write_buf))
                in_off += B * kp
                Ws.append(b.weights)
                o = b.out_start[:, None] + np.arange(mp)[None, :]
                valid = np.arange(mp)[None, :] < b.mms[:, None]
                rid = y_off + np.arange(B * mp).reshape(B, mp)
                wl.setdefault(b.write_buf, []).append(
                    (rid[valid], o[valid])
                )
                y_off += B * mp
            for b in self._scale_buckets:
                if b.read_buf != t:
                    continue
                S = int(b.in_idx.shape[0])
                coords_list.append(b.in_idx)
                scale_metas.append(_StageScale(in_off, S, b.write_buf))
                in_off += S
                ws.append(b.weights)
                wl.setdefault(b.write_buf, []).append(
                    (y_off + np.arange(S), b.out_idx)
                )
                y_off += S
            read_coords.append(
                np.concatenate(coords_list)
                if coords_list else np.zeros(0, np.int64)
            )
            writer_lists.append(
                {wb: (np.concatenate([r for r, _ in ps]),
                      np.concatenate([c for _, c in ps]))
                 for wb, ps in wl.items()}
            )
            stage_metas.append(
                _StageMeta(gemms=tuple(gemm_metas), scales=tuple(scale_metas),
                           y_rows=y_off)
            )
            stage_weights.append((Ws, ws))

        def _build_map(rids, coords, size, zero_id):
            """(size, c_max) table of y_cat row ids per logical coordinate."""
            ok = (coords >= 0) & (coords < size)
            rids, coords = rids[ok], coords[ok]
            order = np.argsort(coords, kind="stable")
            rids, coords = rids[order], coords[order]
            counts = np.bincount(coords, minlength=size)
            c_max = max(1, int(counts.max(initial=0)))
            tab = np.full((size, c_max), zero_id, dtype=np.int64)
            slot = np.arange(rids.size) - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
            )
            tab[coords, slot] = rids
            return tab

        stage_params = []
        for t in range(num_stages):
            Ws, ws = stage_weights[t]
            zero_id = stage_metas[t].y_rows
            # out contribution table for this stage
            wmap = writer_lists[t]
            out_tab = None
            if -1 in wmap:
                rids, coords = wmap[-1]
                out_tab = _dev(_build_map(
                    rids, coords, self.out_size, zero_id).astype(np.int32))
            # next stage's unrolled read table (composed through this
            # stage's write map over buffer t+1's logical coordinates)
            next_tab = None
            if t + 1 < num_stages:
                size = self.buf_sizes[t + 1]
                M = _build_map(*wmap.get(t + 1, (np.zeros(0, np.int64),
                                                 np.zeros(0, np.int64))),
                               size=size, zero_id=zero_id)
                rc = read_coords[t + 1]
                ok = (rc >= 0) & (rc < size)
                F = np.full((rc.size, M.shape[1]), zero_id, dtype=np.int64)
                F[ok] = M[rc[ok]]
                next_tab = _dev(F.astype(np.int32))
            stage_params.append((Ws, ws, out_tab, next_tab))

        # stage-0 input table: unrolled read layout straight from x (whose
        # device length is buf_sizes[0] — 2n when real-embedded)
        n_in = self.buf_sizes[0]
        rc0 = read_coords[0] if num_stages else np.zeros(0, np.int64)
        idx0 = np.where((rc0 >= 0) & (rc0 < n_in), rc0, n_in)
        self._params = (_dev(idx0.astype(np.int32)), stage_params)

        meta = _PlanMeta(
            num_stages=num_stages,
            out_size=self.out_size,
            dtype=self.dtype,
            precision=self._precision,
            stages=tuple(stage_metas),
        )
        self._apply_jit = jax.jit(partial(_apply_plan, meta))

    # -- application ----------------------------------------------------

    def pin_params(self):
        """Upload host-resident params to the device in place — the undo of
        params_on_host, for plans the caller's HBM budget can keep resident
        (the partition apply pins the largest sub-plans first to minimize
        per-apply streaming). The host params are kept so unpin_params()
        can release the device copies again (HBM budgets are estimates;
        callers catch RESOURCE_EXHAUSTED here and fall back to streaming).
        On failure self._params is untouched (host arrays throughout)."""
        if not self._params_on_host:
            return
        put = jax.device_put
        idx0, stage_params = self._params
        sp2 = []
        for Ws, ws, out_tab, next_tab in stage_params:
            sp2.append((
                [put(W) for W in Ws], [put(w) for w in ws],
                None if out_tab is None else put(out_tab),
                None if next_tab is None else put(next_tab),
            ))
        self._host_params = self._params
        self._params = (put(idx0), sp2)
        self._params_on_host = False

    def unpin_params(self):
        """Release pinned device params back to host-resident streaming
        (only for plans originally built with params_on_host)."""
        host = getattr(self, "_host_params", None)
        if self._params_on_host or host is None:
            return
        self._params = host
        self._params_on_host = True

    def __call__(self, x):
        """Apply to (n,) or (n, r); jit-compiled, cached per input shape."""
        if self.real_embed:
            # complex in/out lives on the host (the embedded plan has no
            # complex dtypes at all); the device sees stacked [Re; Im].
            x = np.asarray(x)
            was_vec = x.ndim == 1
            if was_vec:
                x = x[:, None]
            xr = np.concatenate([x.real, x.imag], axis=0)
            yr = np.asarray(self.apply_stacked(xr))
            mh = self.shape[0]
            y = (yr[:mh] + 1j * yr[mh:]).astype(self._io_dtype)
            return y[:, 0] if was_vec else y
        x = jnp.asarray(x)
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        y = self._apply_jit(self._params, x)
        return y[:, 0] if was_vec else y

    def apply_stacked(self, xr):
        """Device-resident apply in stacked-real form: (2n, r) -> (2m, r).

        For real_embed plans only — lets iterative solvers (GMRES sketches,
        scoring loops) stay on device across complex applies.
        """
        check(self.real_embed, "apply_stacked requires a real_embed plan")
        xr = jnp.asarray(xr)
        was_vec = xr.ndim == 1
        if was_vec:
            xr = xr[:, None]
        y = self._apply_jit(self._params, xr)
        return y[:, 0] if was_vec else y

    def matmat(self, X):
        """Batched multi-RHS apply (alias of __call__ for solver interop)."""
        return self(X)

    def materialize(self) -> np.ndarray:
        """Dense matrix of the packed op (for oracle tests)."""
        dt = self._io_dtype if self.real_embed else self.dtype
        return np.asarray(self(np.eye(self.shape[1], dtype=dt)))


@dataclasses.dataclass(frozen=True)
class _StageGemm:
    """One GEMM bucket inside a stage program (static part)."""

    in_off: int   # row offset of this bucket's windows inside g_all
    B: int
    mp: int
    kp: int
    target: int   # -1 = output, else the next buffer id


@dataclasses.dataclass(frozen=True)
class _StageScale:
    in_off: int
    count: int
    target: int


@dataclasses.dataclass(frozen=True)
class _StageMeta:
    gemms: tuple    # tuple[_StageGemm, ...]
    scales: tuple   # tuple[_StageScale, ...]
    y_rows: int     # rows of this stage's concatenated output y_cat


@dataclasses.dataclass(frozen=True)
class _PlanMeta:
    """Static plan topology captured by the jit closure (hashable, no arrays)."""

    num_stages: int
    out_size: int
    dtype: object
    precision: object
    stages: tuple  # tuple[_StageMeta, ...]


def _take_sum(y_ext, tab, r):
    """tab: (rows, c_max) ids into y_ext; rows with fewer contributors point
    at the trailing zero row. Returns the (rows, r) accumulation as dense
    take(+sum) — no scatter."""
    c = tab.shape[1]
    if c == 1:
        return jnp.take(y_ext, tab[:, 0], axis=0)
    g = jnp.take(y_ext, tab.reshape(-1), axis=0)
    return g.reshape(tab.shape[0], c, r).sum(axis=1)


def _apply_plan(meta: _PlanMeta, params, x: jnp.ndarray) -> jnp.ndarray:
    """The staged executor; all arrays arrive as traced jit arguments.

    Activations live UNROLLED per stage: every GEMM unit's padded input
    window is a contiguous slice, so bucket reads are free, each bucket is
    one batched einsum, and the entire inter-stage re-blocking (the
    butterfly exchange) is ONE precomputed take (+ a length-c_max dense sum
    where block rows genuinely accumulate, e.g. radix-2 butterfly factors).
    There is no scatter anywhere. The original
    per-bucket vmap(dynamic_slice) + scatter-add executor measured 100x the
    op's speed of light on ragged multilevel chains (43 buckets x 5 stages:
    29.5 ms vs the 0.26 ms roofline); this executor is within a small factor
    of the roofline (gather granularity is the remaining cost)."""
    idx0, stage_params = params
    r = x.shape[1]
    dt = meta.dtype
    x_ext = jnp.concatenate(
        [x.astype(dt), jnp.zeros((1, r), dtype=dt)], axis=0
    )
    g = jnp.take(x_ext, idx0, axis=0)
    out = jnp.zeros((meta.out_size, r), dtype=dt)

    for t, sm in enumerate(meta.stages):
        Ws, ws, out_tab, next_tab = stage_params[t]
        pieces = []
        for gm, W in zip(sm.gemms, Ws):
            gi = g[gm.in_off:gm.in_off + gm.B * gm.kp]
            y = jnp.einsum(
                "bmk,bkr->bmr", W, gi.reshape(gm.B, gm.kp, r),
                preferred_element_type=dt, precision=meta.precision,
            )
            pieces.append(y.reshape(gm.B * gm.mp, r))
        for scm, w in zip(sm.scales, ws):
            pieces.append(g[scm.in_off:scm.in_off + scm.count] * w[:, None])
        y_cat = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, 0)
        y_ext = jnp.concatenate(
            [y_cat, jnp.zeros((1, r), dtype=dt)], axis=0
        )
        if out_tab is not None:
            out = out + _take_sum(y_ext, out_tab, r)
        if next_tab is not None:
            g = _take_sum(y_ext, next_tab, r)
    return out


def pack(op: L.LinOp, dtype=None, block_align: int = 128,
         real_embed: bool = False,
         precision: str | None = "highest",
         tiling: str = "uniform",
         params_on_host: bool = False) -> StagePlan:
    """Compile a LinOp into its packed device plan."""
    return StagePlan(op, dtype=dtype, block_align=block_align,
                     real_embed=real_embed, precision=precision,
                     tiling=tiling, params_on_host=params_on_host)
