"""The fac -> device bridge: factorized operators onto the accelerator.

The reference's entire value is applying a *factorized* operator fast — its
apply path walks the recursive factor graph making one tiny BLAS call per
block (bfFacGetMatProduct apply loop, src/fac.c:133-146;
bfMatBlockDenseMulVec, src/mat_block_dense.c:574-630). This module is the
device replacement for that hot path: it takes the REAL outputs of the
factorization engines —

- a `PartialFac` from the streaming factorizer (fac/streamer.py),
- the multilevel Helmholtz `Product`/`BlockDense` from fac/helm2.py,
- any LinOp expression over them,

— buckets the data-dependent ("ragged") block ranks per stage, pads each
bucket to a matmul-friendly tile, and emits an executable `StagePlan` whose
apply is a handful of batched (B, m, k) x (B, k, r) GEMMs per level. Rank
bucketing/padding is the central perf/accuracy trade SURVEY.md §7 flags;
`choose_block_align` makes the trade measurable by estimating padding waste
and bucket counts for candidate tile sizes before any device memory is
committed, and every plan reports achieved `padding_waste`.

Complex factorizations (the Helmholtz path) can be mapped onto real buffers
via the 2x2 embedding at pack time (ops/packed.py `real_embed`) for the
real-only consumers (interleaved partition layout, real GMRES drivers);
flop accounting stays exact.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from butterfly_tpu.fac.streamer import PartialFac
from butterfly_tpu.ops import packed as packed_mod
from butterfly_tpu.ops.linop import LinOp
from butterfly_tpu.ops.packed import StagePlan, pack
from butterfly_tpu.utils.errors import InvalidArgumentsError, check
from butterfly_tpu.utils.logging import log_info

__all__ = [
    "uniformize",
    "uniformize_fused",
    "FusedFacPlan",
    "choose_block_align",
    "AlignEstimate",
    "fac_block_stats",
]


def _as_linop(obj) -> LinOp:
    if isinstance(obj, PartialFac):
        return obj.as_linop()
    if isinstance(obj, LinOp):
        return obj
    raise InvalidArgumentsError(
        f"expected a PartialFac or LinOp, got {type(obj).__name__}"
    )


@dataclasses.dataclass
class AlignEstimate:
    """Predicted pack statistics for one candidate block_align."""

    block_align: int
    num_gemm_units: int
    num_buckets: int
    useful_flops_per_col: int
    padded_flops_per_col: int
    padding_waste: float
    padded_weight_elems: int


def _unit_shapes(op: LinOp) -> list[tuple[int, int, int]]:
    """(stage, m, k) of every dense GEMM unit, via one flatten pass."""
    chains: list = []
    packed_mod._flatten(op, 0, 0, chains)
    shapes = []
    for c in chains:
        for t, f in enumerate(c.factors):
            for u in f.gemms:
                mm, kk = u.data.shape
                shapes.append((t, mm, kk))
    return shapes


def fac_block_stats(obj) -> dict:
    """Per-stage block-size histogram of a factorized operator — the raw
    rank-raggedness data behind the bucketing decision."""
    shapes = _unit_shapes(_as_linop(obj))
    stages: dict[int, list[tuple[int, int]]] = {}
    for t, m, k in shapes:
        stages.setdefault(t, []).append((m, k))
    out = {}
    for t, blks in sorted(stages.items()):
        ms = np.array([m for m, _ in blks])
        ks = np.array([k for _, k in blks])
        out[t] = {
            "num_blocks": len(blks),
            "m_min": int(ms.min()), "m_max": int(ms.max()),
            "k_min": int(ks.min()), "k_max": int(ks.max()),
            "m_mean": float(ms.mean()), "k_mean": float(ks.mean()),
        }
    return out


def estimate_for_align(shapes: Sequence[tuple[int, int, int]],
                       block_align: int) -> AlignEstimate:
    buckets: dict[tuple, int] = {}
    useful = 0
    padded = 0
    pelems = 0
    for t, m, k in shapes:
        mp = packed_mod._round_up(m, block_align)
        kp = packed_mod._round_up(k, block_align)
        buckets[(t, mp, kp)] = buckets.get((t, mp, kp), 0) + 1
        useful += 2 * m * k
        padded += 2 * mp * kp
        pelems += mp * kp
    return AlignEstimate(
        block_align=block_align,
        num_gemm_units=len(shapes),
        num_buckets=len(buckets),
        useful_flops_per_col=useful,
        padded_flops_per_col=padded,
        padding_waste=1.0 - useful / max(padded, 1),
        padded_weight_elems=pelems,
    )


def choose_block_align(
    obj,
    candidates: Sequence[int] = (16, 32, 64, 128),
    bucket_overhead_flops: int = 1 << 22,
) -> tuple[int, list[AlignEstimate]]:
    """Pick the bucket tile size minimizing estimated apply cost.

    Cost model: padded flops (matmul work incl. waste) + a fixed per-bucket
    dispatch overhead (each bucket is one gather + one batched GEMM + one
    scatter, modelled as ~4 MFLOP of matmul work; not measured on the
    H100). Small aligns waste little padding but explode the bucket count;
    128 matches a large matmul tile but can pad ragged ranks >2x. This makes
    SURVEY.md §7's "central trade" an explicit, recorded decision.
    """
    shapes = _unit_shapes(_as_linop(obj))
    check(shapes, "operator has no dense blocks to pack")
    ests = [estimate_for_align(shapes, a) for a in candidates]
    best = min(
        ests,
        key=lambda e: e.padded_flops_per_col
        + bucket_overhead_flops * e.num_buckets,
    )
    return best.block_align, ests


class FusedFacPlan:
    """A REAL factorized operator re-compressed to uniform FFT form
    (fac/distill.py) and applied as one batched einsum per level
    (`UniformButterfly.apply`), jitted once.

    This is the fast path for the reference's metric-critical product apply
    (src/fac.c:133-146): instead of one batched einsum per ragged stage
    (StagePlan), every level is a single uniform batched GEMM. Rows come out
    in butterfly (bit-reversed-block) order; apply() restores canonical
    order with one device gather, apply_butterfly_order() skips it
    (order-free consumers: norms, top-k after id-mapping, chained scoring).
    """

    def __init__(self, dist):
        import jax
        import jax.numpy as jnp

        from butterfly_tpu.ops.butterfly import UniformButterfly

        self.dist = dist
        self.bf = bf = dist.bf
        self._apply_jit = jax.jit(UniformButterfly.apply)
        inv = np.empty_like(dist.row_perm)
        inv[dist.row_perm] = np.arange(dist.row_perm.size)
        self._inv_perm = jnp.asarray(inv.astype(np.int32))
        self.shape = bf.shape
        self.rank = dist.rank

    def apply_butterfly_order(self, x):
        return self._apply_jit(self.bf, x)

    def apply(self, x):
        import jax.numpy as jnp

        return jnp.take(self.apply_butterfly_order(x), self._inv_perm, axis=0)

    def __call__(self, x):
        return self.apply(x)

    def matmat(self, X):
        return self.apply(X)

    def flops_per_col(self) -> int:
        return self.bf.flops_per_col()

    def nbytes(self) -> int:
        return self.bf.nbytes()


def uniformize_fused(
    obj,
    num_blocks: int | None = None,
    rank: int | None = None,
    tol: float = 1e-6,
    dtype=np.float32,
) -> FusedFacPlan:
    """Re-compress a real factorized operator into uniform FFT form
    (fac/distill.py) and compile its per-level einsum apply.

    The ragged->uniform trade: `uniformize` (the packed path) keeps the
    fac's exact ragged ranks and pays per-stage dispatch; this path pays a
    one-time re-compression (setup, host f64) and applies as one uniform
    batched GEMM per level. num_blocks=None picks the largest power of two
    keeping >=32 columns per leaf block.
    """
    from butterfly_tpu.fac.distill import distill_butterfly

    op = _as_linop(obj)
    n, m = op.shape
    check(not np.issubdtype(op.dtype, np.complexfloating),
          "uniformize_fused is real-only; use uniformize(real_embed=True) "
          "for complex operators", InvalidArgumentsError)
    if num_blocks is None:
        nb = 1
        while (nb * 2 <= min(n, m) // 32
               and n % (nb * 2) == 0 and m % (nb * 2) == 0):
            nb *= 2
        num_blocks = nb
    check(num_blocks >= 2, "operator too small to butterfly",
          InvalidArgumentsError)
    dist = distill_butterfly(op, num_blocks, rank, dtype=dtype, tol=tol)
    log_info(
        "uniformize_fused: NB=%d rank=%d dropped=%.2e nbytes=%.1f MB",
        num_blocks, dist.rank, dist.max_sv_discarded, dist.nbytes() / 1e6,
    )
    return FusedFacPlan(dist)


def uniformize(
    obj,
    dtype=None,
    block_align: int | None = None,
    real_embed: bool = False,
    precision: str | None = "highest",
    tiling: str = "uniform",
) -> StagePlan:
    """Compile a factorization-engine output into its device apply plan.

    obj: a `PartialFac` (streamer output), a LinOp (e.g. the multilevel
    Helmholtz `BlockDense` from fac/helm2.py), or any expression over them.
    block_align: bucket tile size; None picks one via `choose_block_align`.

    Returns a StagePlan; `plan.stats.padding_waste` records the uniformization
    cost (reference analogue: none — the reference pays per-block dispatch on
    every matvec instead, src/mat_block_dense.c:574-630).
    """
    op = _as_linop(obj)
    if block_align is None:
        block_align, ests = choose_block_align(op)
        log_info(
            "uniformize: chose block_align=%d (waste %.1f%%, %d buckets)",
            block_align,
            100 * [e for e in ests if e.block_align == block_align][0].padding_waste,
            [e for e in ests if e.block_align == block_align][0].num_buckets,
        )
    plan = pack(op, dtype=dtype, block_align=block_align,
                real_embed=real_embed, precision=precision, tiling=tiling)
    log_info(
        "uniformize: %d stages, %d gemm buckets, padding waste %.1f%%, "
        "%.1f MB weights",
        plan.stats.num_stages,
        plan.stats.num_gemm_buckets,
        100 * plan.stats.padding_waste,
        plan.stats.weight_bytes / 1e6,
    )
    return plan
