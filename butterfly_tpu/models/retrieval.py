"""Butterfly-compressed embedding retrieval.

The flagship application (BASELINE.json configs[1,2]): an n x d embedding
table stored as structured factors instead of dense rows —

    T  ~=  Psi @ V                      (one-level block-diagonal row basis;
                                         `CompressedTable`, tall tables)
    T  ~=  Psi . W0 . ... . W_{numW-1}  (multilevel streamed butterfly;
                                         `DeepTable`, wide structured tables)

For the one-level format Psi is a uniform block-diagonal (NB, s, rank) factor
from per-row-block truncated SVDs and V stacks the right factors; rows are
first permuted into tree order (`tree_order_rows`) so blocks compress. The
deep format runs the full streaming factorizer + fac->device bridge. Which
one wins is a measured property of the table's aspect/structure — see
DeepTable's docstring. The reference's analogue is the algebraic fac engine
compressing row blocks by truncated SVD (getPsiAndW, src/fac.c:717-777);
here one-level blocks are uniform so every operation is ONE batched
einsum:

- `score(queries)`: scores = Psi @ (V @ q) — batched block GEMMs.
- `lookup(ids)`: row gather INTO the factors + fused block matvec
  (one (rank, d) gemv per id instead of materializing the table).
- `topk(queries, k)`: scoring + on-chip jax.lax.top_k.
- `train_step`: factors are differentiable; distillation against the exact
  table refines them (used to deepen with a butterfly).

Accuracy gate (BASELINE): recall@100 vs exact dense scoring at parity —
tested in tests/test_retrieval.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = [
    "CompressedTable",
    "DeepTable",
    "compress_table",
    "compress_table_deep",
    "tree_order_rows",
    "exact_topk",
]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CompressedTable:
    """Uniform blocked low-rank table: T[i] ~= Psi[blk(i), pos(i)] @ V[blk(i)].

    Psi: (NB, s, rank)  — per-block row basis (left factors, U*S from SVD)
    V:   (NB, rank, d)  — per-block right factors (V^T)
    """

    Psi: jnp.ndarray
    V: jnp.ndarray

    def __post_init__(self):
        check(self.Psi.ndim == 3 and self.V.ndim == 3, "bad factor ranks",
              InvalidArgumentsError)
        check(self.Psi.shape[0] == self.V.shape[0]
              and self.Psi.shape[2] == self.V.shape[1],
              "Psi/V shapes incompatible", InvalidArgumentsError)

    # pytree protocol -----------------------------------------------------
    def tree_flatten(self):
        return (self.Psi, self.V), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # properties ----------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self.Psi.shape[0] * self.Psi.shape[1]

    @property
    def dim(self) -> int:
        return self.V.shape[2]

    @property
    def rank(self) -> int:
        return self.Psi.shape[2]

    def nbytes(self) -> int:
        return self.Psi.nbytes + self.V.nbytes

    # ops -----------------------------------------------------------------
    def score(self, queries: jnp.ndarray) -> jnp.ndarray:
        """Scores of every row against every query: (n, q).

        queries: (q, d). Two batched einsums.
        """
        mid = jnp.einsum("brd,qd->brq", self.V, queries.astype(self.V.dtype),
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("bsr,brq->bsq", self.Psi, mid.astype(self.Psi.dtype),
                         preferred_element_type=jnp.float32)
        NB, s, q = out.shape
        return out.reshape(NB * s, q)

    def lookup(self, ids: jnp.ndarray) -> jnp.ndarray:
        """Reconstruct embedding rows for `ids`: gather into the factors and
        apply the per-id fused block matvec (BASELINE: 'lookup is a gather
        into butterfly factors followed by fused block-matvec')."""
        s = self.Psi.shape[1]
        blk = ids // s
        pos = ids % s
        u = self.Psi[blk, pos]  # (m, rank) — coarse per-id gather
        v = self.V[blk]  # (m, rank, d)
        return jnp.einsum("mr,mrd->md", u, v, preferred_element_type=jnp.float32)

    def topk(self, queries: jnp.ndarray, k: int, approx: bool = False):
        """(values, indices) of the top-k rows per query: (q, k) each.
        approx=True uses lax.approx_max_k (recall ~0.95 per the XLA
        contract); strict recall reported by callers measures the
        end-to-end effect."""
        scores = self.score(queries)  # (n, q)
        if approx:
            return jax.lax.approx_max_k(scores.T, k)
        return jax.lax.top_k(scores.T, k)

    def materialize(self) -> jnp.ndarray:
        """Dense (n, d) table (oracle for tests)."""
        out = jnp.einsum("bsr,brd->bsd", self.Psi, self.V,
                         preferred_element_type=jnp.float32)
        return out.reshape(self.num_rows, self.dim)


def compress_table(
    table: np.ndarray,
    rank: int,
    block_rows: int = 128,
    dtype=jnp.float32,
    svd_dtype=np.float64,
) -> CompressedTable:
    """Compress a dense (n, d) table by per-row-block truncated SVD with a
    UNIFORM rank (the batched-GEMM-friendly analogue of the reference's tol-adaptive
    getPsiAndW truncation, src/fac.c:680-714; uniformity is the
    padding/bucketing decision SURVEY.md §7 calls the central trade).

    svd_dtype=np.float32 halves setup time at configs[1] scale (1M x 128)
    with negligible factor error for f32 output."""
    table = np.asarray(table)
    n, d = table.shape
    check(n % block_rows == 0, "n must be divisible by block_rows",
          InvalidArgumentsError)
    check(rank <= min(block_rows, d), "rank too large", InvalidArgumentsError)
    NB = n // block_rows
    blocks = table.reshape(NB, block_rows, d)
    # batched SVD on host (setup time)
    U, S, Vt = np.linalg.svd(blocks.astype(svd_dtype), full_matrices=False)
    Psi = (U[:, :, :rank] * S[:, None, :rank]).astype(np.float32)
    V = Vt[:, :rank, :].astype(np.float32)
    return CompressedTable(jnp.asarray(Psi, dtype=dtype), jnp.asarray(V, dtype=dtype))


def tree_order_rows(
    table: np.ndarray,
    leaf_size: int = 256,
    max_depth: int = 24,
    seed: int = 0,
) -> np.ndarray:
    """Row permutation from recursive PCA bisection — the retrieval analogue
    of the reference's row-tree point permutation (the quadtree perm sift,
    src/quadtree_node.c:123-199): rows that are close in embedding space
    become close in tree order, so per-block truncated SVDs compress harder.

    Returns `perm` with table[perm] in tree order. O(n d log(n/leaf)) via
    power-iteration PCA per node; fine at 1M x 128 on the host.
    """
    table = np.asarray(table, dtype=np.float32)
    rng = np.random.default_rng(seed)
    n = table.shape[0]
    out: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int]] = [(np.arange(n), 0)]
    while stack:
        idx, depth = stack.pop()
        if depth >= max_depth or idx.size <= leaf_size:
            out.append(idx)
            continue
        # PCA direction from a row subsample (the split only needs the
        # dominant direction, not per-row precision)
        sub = idx if idx.size <= 8192 else rng.choice(idx, 8192, replace=False)
        Xs = table[sub]
        mu = Xs.mean(axis=0)
        Xc = Xs - mu
        v = rng.standard_normal(table.shape[1]).astype(np.float32)
        for _ in range(4):  # power iteration on the covariance
            v = Xc.T @ (Xc @ v)
            nv = np.linalg.norm(v)
            if nv == 0:
                break
            v /= nv
        s = (table[idx] - mu) @ v
        med = np.median(s)
        left, right = idx[s <= med], idx[s > med]
        if left.size == 0 or right.size == 0:  # degenerate: split by count
            half = idx.size // 2
            left, right = idx[:half], idx[half:]
        # LIFO stack: push right first so left comes out first
        stack.append((right, depth + 1))
        stack.append((left, depth + 1))
    return np.concatenate(out)


class DeepTable:
    """A table compressed into a genuine multilevel butterfly by the
    streaming factorizer, applied through the fac->device bridge.

    T ~= Psi . W0 . ... . W_{numW-1} (reference: the streamed row-tree
    compression, src/fac.c:717-777) — scoring T @ q^T is one packed
    device apply per query batch.

    HONEST SCOPE (measured, pinned by tests/test_retrieval.py): this wins
    over the one-level `CompressedTable` for WIDE structured tables (d
    comparable to n — LBO eigenvector / DCT / kernel-eigenbasis tables, the
    reference's own workload), and for tables with highly VARIABLE per-block
    ranks (its cuts adapt; the uniform-rank format pays the max rank
    everywhere). For tall SMOOTH tables (1M x 128 with low uniform block
    rank) the hierarchy's transfer matrices cost more than they save — there
    `compress_table` + `tree_order_rows` is the right path.
    """

    def __init__(self, fac, plan, shape: tuple[int, int]):
        self.fac = fac  # PartialFac (host oracle)
        self.plan = plan  # StagePlan (device apply)
        self.shape = shape

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def dim(self) -> int:
        return self.shape[1]

    def nbytes(self) -> int:
        """Device-resident compressed size (padded plan weights)."""
        return self.plan.stats.weight_bytes

    def nbytes_logical(self) -> int:
        """Unpadded factor size (reference: bfFacGetNumBytes, src/fac.c:77)."""
        return self.fac.nbytes()

    def score(self, queries) -> jnp.ndarray:
        """(q, d) queries -> (n, q) scores, on device."""
        q = jnp.asarray(queries)
        return self.plan(q.T)

    def topk(self, queries, k: int, approx: bool = False):
        scores = self.score(queries)
        if approx:
            return jax.lax.approx_max_k(scores.T, k)
        return jax.lax.top_k(scores.T, k)

    def materialize(self) -> np.ndarray:
        """Host oracle reconstruction."""
        return self.fac.as_linop().materialize()


def compress_table_deep(
    table: np.ndarray,
    tol: float = 1e-4,
    col_depth: int = 2,
    row_leaf: int = 128,
    min_block: int = 8,
    dtype=np.float32,
    block_align: int | None = None,
) -> DeepTable:
    """Stream a table through the algebraic butterfly factorizer and compile
    the result for device scoring (the full reference pipeline:
    bfFacStreamerFeed src/fac_streamer.c:386 -> merge/split src/fac.c:1080 ->
    device apply, here via fac/uniformize.py instead of per-block zgemv)."""
    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.fac.uniformize import uniformize
    from butterfly_tpu.trees import uniform_tree

    table = np.asarray(table, dtype=np.float64)
    n, d = table.shape
    row_depth = max(1, int(np.ceil(np.log2(max(n // row_leaf, 2)))))
    col_depth = max(1, min(col_depth, int(np.log2(max(d // min_block, 2)))))
    spec = FacSpec(
        row_tree=uniform_tree(n, 2, row_depth),
        col_tree=uniform_tree(d, 2, col_depth),
        row_tree_init_depth=min(4, row_depth),
        tol=tol,
        min_num_rows=min_block,
        min_num_cols=min_block,
    )
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(col_depth):
        if leaf.num_points:
            streamer.feed(table[:, leaf.i0 : leaf.i1])
    fac = streamer.get_fac()
    plan = uniformize(fac, dtype=dtype, block_align=block_align)
    return DeepTable(fac, plan, (n, d))


def exact_topk(table: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Host oracle: exact dense top-k indices (q, k)."""
    scores = queries @ table.T  # (q, n)
    return np.argsort(-scores, axis=1)[:, :k]


def recall_at_k(pred_idx: np.ndarray, true_idx: np.ndarray) -> float:
    """Mean fraction of true top-k recovered (strict set recall)."""
    hits = 0
    for p, t in zip(pred_idx, true_idx):
        hits += len(set(p.tolist()) & set(t.tolist()))
    return hits / true_idx.size


def recall_with_tolerance(
    pred_idx: np.ndarray,
    true_scores: np.ndarray,
    k: int,
    tol: float = 1e-3,
) -> float:
    """Tolerance recall@k: a predicted id counts as a hit if its TRUE score is
    within `tol * score_range` of the k-th best true score. This is the
    standard ANN-benchmark treatment of near-ties: strict set recall is
    ill-posed when many rows score within numerical noise of the cutoff.

    true_scores: (q, n) exact scores; pred_idx: (q, k) predicted ids.
    """
    q = true_scores.shape[0]
    hits = 0
    for i in range(q):
        s = true_scores[i]
        cutoff = np.partition(s, -k)[-k]
        eps = tol * (s.max() - s.min())
        hits += int(np.sum(s[pred_idx[i]] >= cutoff - eps))
    return hits / (q * k)


@partial(jax.jit, static_argnames=("lr",))
def train_step(ct: CompressedTable, rows: jnp.ndarray, ids: jnp.ndarray,
               lr: float = 1e-2):
    """One distillation step: fit the compressed factors to exact table rows
    (refines compression / supports downstream fine-tuning). Returns
    (new_table, loss)."""

    def loss_fn(ct):
        rec = ct.lookup(ids)
        return jnp.mean((rec - rows) ** 2)

    loss, g = jax.value_and_grad(loss_fn)(ct)
    new = jax.tree_util.tree_map(lambda p, gg: p - lr * gg, ct, g)
    return new, loss
