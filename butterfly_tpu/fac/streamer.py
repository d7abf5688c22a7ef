"""Streaming algebraic butterfly factorizer (merge-and-split).

JAX redesign of the reference's algebraic engine
(src/fac.c:509-1294, src/fac_streamer.c:35-556): compresses ANY matrix fed
to it column-block by column-block into a butterfly-like product

    Phi_block  ~=  Psi . W0 . W1 . ... . W_{numW-1}

via truncated SVDs over a row tree. The construction logic follows the
reference exactly — leaf feeds find an adaptive row cut, post-order column
traversal merges children facs at their parent by computing a merge cut
through the row tree and re-splitting each merged Psi* block at an
epsilon-rank cut — but the data representation is the LinOp algebra
(BlockDiag / BlockDense / Identity), the SVDs are batched NumPy f64
(setup-time host math), and the finished factorization compiles through
`ops/packed.py` / uniformization into batched GEMMs for apply.

This engine is what compresses Laplace-Beltrami eigenvector matrices
("frequency-domain butterflies"), covariance operators, and the randomized
middle factors of the fast direct solver (SURVEY.md §2.8b-d).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from butterfly_tpu.config import FacSpec
from butterfly_tpu.ops.linop import (
    BlockDense,
    BlockDiag,
    Dense,
    Identity,
    LinOp,
    Product,
    Zero,
    hpad,
    row_slice,
)
from butterfly_tpu.ops.svd import truncated_svd
from butterfly_tpu.trees.tree import Tree, TreeNode
from butterfly_tpu.utils.debug import debug_enabled, deep_check_fac
from butterfly_tpu.utils.errors import RuntimeButterflyError, check
from butterfly_tpu.utils.logging import log_debug, log_info
from butterfly_tpu.utils.prng import host_rng

__all__ = ["PartialFac", "FacStreamer", "merge_and_split"]


@dataclasses.dataclass
class PartialFac:
    """A partial butterfly factorization of one column-tree block
    (reference: BfFac, include/bf/fac.h:33-42)."""

    col_node: TreeNode
    row_nodes: list[TreeNode]  # the row cut, in order
    Psi: LinOp  # block-diagonal over row_nodes
    W: list[LinOp]

    def as_linop(self) -> Product:
        """(reference: bfFacGetMatProduct, src/fac.c:53-75)"""
        return Product([self.Psi] + list(self.W))

    def nbytes(self) -> int:
        """(reference: bfFacGetNumBytes, src/fac.c:77-82)"""
        return self.Psi.nbytes() + sum(w.nbytes() for w in self.W)

    @property
    def num_w(self) -> int:
        return len(self.W)


# ---------------------------------------------------------------------------
# Leaf feed: adaptive row cut + per-node truncated SVD
# ---------------------------------------------------------------------------


def _get_psi_and_w(
    spec: FacSpec, mat: np.ndarray, row_node: TreeNode
) -> tuple[LinOp, LinOp, bool]:
    """Per row node: truncated SVD of its row block; Psi := U, W := S V^T.
    Skinny/short blocks pass through with identities
    (reference: getPsiAndW, src/fac.c:717-777)."""
    i0, i1 = row_node.i0, row_node.i1
    block = mat[i0:i1]
    m, n = block.shape
    if n < spec.min_num_cols:
        # too few columns: pass the block through, W := I
        return Dense(block.copy()), Identity(n), True
    if m < spec.min_num_rows:
        # too few rows: Psi := I, pass the block through as W
        return Identity(m), Dense(block.copy()), True
    U, s, Vt, truncated = truncated_svd(block, spec.tol)
    if not truncated:
        return Dense(block.copy()), Identity(n), False
    return Dense(U), Dense(s[:, None] * Vt), True


def _leaf_fac(spec: FacSpec, col_node: TreeNode, Phi: np.ndarray) -> PartialFac:
    """Feed one column-tree leaf: find an adaptive row cut starting from
    `row_tree_init_depth`, splitting nodes whose SVD fails to truncate
    (reference: bfFacStreamerFeed, src/fac_streamer.c:386-518)."""
    row_tree: Tree = spec.row_tree
    check(
        Phi.shape[0] == row_tree.num_points,
        "fed block must span all rows",
    )
    start_nodes = row_tree.nodes_at_depth(
        min(spec.row_tree_init_depth, row_tree.max_depth)
    )
    row_nodes: list[TreeNode] = []
    psi_blocks: list[LinOp] = []
    w_blocks: list[LinOp] = []
    stack = list(reversed(start_nodes))
    while stack:
        node = stack.pop()
        psi, w, ok = _get_psi_and_w(spec, Phi, node)
        if not ok and not node.is_leaf:
            # descend: retry on the children
            stack.extend(reversed(node.children))
            continue
        row_nodes.append(node)
        psi_blocks.append(psi)
        w_blocks.append(w)
    fac = PartialFac(
        col_node=col_node,
        row_nodes=row_nodes,
        Psi=BlockDiag(psi_blocks),
        W=[BlockDense.from_col(w_blocks)],
    )
    if debug_enabled():  # BF_DEBUG analogue (src/fac_helm2.c:926-936)
        deep_check_fac(fac, where=f"leaf[{col_node.i0},{col_node.i1})")
    return fac


# ---------------------------------------------------------------------------
# Merge-and-split
# ---------------------------------------------------------------------------


def _get_merge_cut(facs: Sequence[PartialFac]) -> list[TreeNode]:
    """The coarsest common row cut of the facs
    (reference: getMergeCut, src/fac.c:509-573). Well-defined because all row
    nodes come from one tree, so ranges nest or are disjoint."""
    check(len(facs) > 0, "empty merge")
    i_start = facs[0].row_nodes[0].i0
    i_end = facs[0].row_nodes[-1].i1
    for f in facs:
        check(
            f.row_nodes[0].i0 == i_start and f.row_nodes[-1].i1 == i_end,
            "facs must share a row span to merge",
        )
    by_first = [
        {n.i0: n for n in f.row_nodes} for f in facs
    ]
    cut: list[TreeNode] = []
    i = i_start
    while i < i_end:
        nodes = []
        for d in by_first:
            if i not in d:
                raise RuntimeButterflyError(
                    "row cuts are not alignable (non-tree row nodes?)"
                )
            nodes.append(d[i])
        best = max(nodes, key=lambda n: n.i1)
        cut.append(best)
        i = best.i1
    return cut


def _psi_star_and_w_slice(
    fac: PartialFac, row_node: TreeNode
) -> tuple[np.ndarray, LinOp]:
    """For one fac: the dense horizontal Psi* slice covering `row_node`'s
    rows, and the matching row slice of the fac's W[0]
    (reference: getPsiAndW0BlocksByRowNodeForPartialFac, src/fac.c:227-371).

    Because the merge cut is coarser than (or equal to) each fac's row cut,
    the slice consists of whole Psi diagonal blocks.
    """
    psi = fac.Psi
    check(isinstance(psi, BlockDiag), "fac Psi must be block-diagonal")
    sel = [
        k
        for k, n in enumerate(fac.row_nodes)
        if row_node.i0 <= n.i0 and n.i1 <= row_node.i1
    ]
    check(sel, "merge cut node covers no Psi blocks")
    # dense Psi* slice: block-diagonal of the selected blocks
    sub = BlockDiag([psi.blocks[k] for k in sel])
    j0 = int(psi.col_offsets[sel[0]])
    j1 = int(psi.col_offsets[sel[-1] + 1])
    W_slice = row_slice(fac.W[0], j0, j1)
    return sub.materialize(), W_slice


def _find_eps_rank_cut(
    spec: FacSpec, root_row_node: TreeNode, psi_star: np.ndarray
):
    """Descend the row tree until truncated SVDs both succeed and compress;
    emit the new Psi (block-diagonal) and W0 (vertical concat) blocks
    (reference: findEpsilonRankCutAndGetNewBlocks, src/fac.c:867-1049)."""
    i0 = root_row_node.i0
    eps_cut: list[TreeNode] = []
    psi_sub: list[LinOp] = []
    w0_sub: list[LinOp] = []
    stack = [root_row_node]
    while stack:
        node = stack.pop()
        a, b = node.i0 - i0, node.i1 - i0
        sub = psi_star[a:b]
        m, n = sub.shape
        # Exploit W sparsity: deep in the descent, most columns of the Psi*
        # row slice are structurally zero (they belong to other diagonal Psi
        # blocks). SVD and store only the nonzero column range
        # (reference: nonzeroColumnRanges in getLowRankApproximation,
        # src/fac.c:805-851).
        nz = np.flatnonzero(np.any(sub != 0.0, axis=0))
        if nz.size == 0:
            eps_cut.append(node)
            psi_sub.append(Identity(m))
            w0_sub.append(Zero((m, n)))
            continue
        c0, c1 = int(nz[0]), int(nz[-1]) + 1
        core = sub[:, c0:c1]
        nc = c1 - c0
        if m < spec.min_num_rows:
            psi_blk: LinOp = Identity(m)
            w0_blk: LinOp = hpad(Dense(core.copy()), c0, n - c1)
        elif nc < spec.min_num_cols:
            psi_blk = Dense(core.copy())
            w0_blk = hpad(Identity(nc), c0, n - c1)
        else:
            U, s, Vt, truncated = truncated_svd(core, spec.tol)
            w0 = s[:, None] * Vt
            compressed = w0.nbytes < core.nbytes
            if not (truncated and compressed):
                if not node.is_leaf:
                    stack.extend(reversed(node.children))
                    continue
                # leaf that refuses to compress: pass through
                psi_blk = Dense(core.copy())
                w0_blk = hpad(Identity(nc), c0, n - c1)
            else:
                psi_blk = Dense(U)
                w0_blk = hpad(Dense(w0), c0, n - c1)
        eps_cut.append(node)
        psi_sub.append(psi_blk)
        w0_sub.append(w0_blk)
    return eps_cut, BlockDiag(psi_sub), BlockDense.from_col(w0_sub)


def merge_and_split(facs: Sequence[PartialFac], spec: FacSpec) -> PartialFac:
    """Merge sibling facs at their column-tree parent
    (reference: mergeAndSplit, src/fac.c:1080-1294)."""
    facs = list(facs)
    parent = facs[0].col_node.parent
    for f in facs:
        check(f.col_node.parent is parent, "facs must share a column parent")
    num_w = facs[0].num_w
    for f in facs:
        check(f.num_w == num_w, "facs must have equal W depth to merge")

    merge_cut = _get_merge_cut(facs)

    row_nodes: list[TreeNode] = []
    psi_blocks: list[LinOp] = []
    w0_blocks: list[LinOp] = []
    w1_blocks: list[LinOp] = []
    for row_node in merge_cut:
        slices = [_psi_star_and_w_slice(f, row_node) for f in facs]
        psi_star = np.concatenate([s[0] for s in slices], axis=1)
        w1_blocks.append(BlockDiag([s[1] for s in slices]))
        eps_cut, psi_blk, w0_blk = _find_eps_rank_cut(spec, row_node, psi_star)
        row_nodes.extend(eps_cut)
        psi_blocks.append(psi_blk)
        w0_blocks.append(w0_blk)

    # assemble factors (reference: src/fac.c:1197-1252)
    Psi = BlockDiag([b for pb in psi_blocks for b in pb.blocks])
    W0 = BlockDiag(w0_blocks)
    W1 = BlockDense.from_col(w1_blocks)
    W = [W0, W1]
    for k in range(1, num_w):
        W.append(BlockDiag([f.W[k] for f in facs]))
    out = PartialFac(parent, row_nodes, Psi, W)
    if debug_enabled():  # BF_DEBUG analogue: per-merge consistency
        deep_check_fac(out, where=f"merge[{parent.i0},{parent.i1})")
    return out


# ---------------------------------------------------------------------------
# The streaming driver
# ---------------------------------------------------------------------------


class FacStreamer:
    """Post-order streaming driver (reference: BfFacStreamer,
    src/fac_streamer.c:35-556).

    Feed the matrix column-block by column-block, one call per column-tree
    leaf (in post-order = left-to-right leaf order); merges happen
    automatically whenever all children of an internal column node are done.
    """

    def __init__(self, spec: FacSpec, auto_skip_empty_leaves: bool = True):
        """auto_skip_empty_leaves=False supports DEFERRED column trees (the
        LBO interval tree, whose leaf point counts only materialize as
        eigenbands are attached): every leaf must then be fed explicitly, an
        empty band as a 0-column block."""
        self.spec = spec
        self.auto_skip_empty = auto_skip_empty_leaves
        self._order = [n for n in spec.col_tree.post_order()]
        self._pos = 0
        self._stack: list[PartialFac] = []
        self._dense_blocks: list[np.ndarray] = []  # for rel-err checks
        self._advance_past_internal()

    def _advance_past_internal(self) -> None:
        """Merge at every internal node whose children are complete
        (reference: continueFactorizing, src/fac_streamer.c:303-363)."""
        while self._pos < len(self._order):
            node = self._order[self._pos]
            if node.is_leaf and (node.num_points > 0 or not self.auto_skip_empty):
                return  # wait for the next feed
            if node.is_leaf:
                self._pos += 1
                continue
            c = sum(1 for ch in node.children if ch.num_points > 0)
            if c == 0:
                self._pos += 1
                continue
            children_facs = self._stack[-c:]
            del self._stack[-c:]
            if len(children_facs) == 1:
                merged = children_facs[0]
                merged = PartialFac(node, merged.row_nodes, merged.Psi, merged.W)
            else:
                merged = merge_and_split(children_facs, self.spec)
            self._stack.append(merged)
            log_debug(
                "merged %d facs at col node depth %d", c, node.depth
            )
            if self.spec.compare_relative_errors:
                self._check_rel_error(merged)
            self._pos += 1

    def _check_rel_error(self, fac: PartialFac) -> None:
        """Random-matvec check vs the stored dense columns
        (reference: checkRelError, src/fac_streamer.c:286-301)."""
        dense = np.concatenate(self._dense_blocks, axis=1)
        j0, j1 = fac.col_node.i0, fac.col_node.i1
        block = dense[:, j0:j1]
        x = host_rng().standard_normal(block.shape[1])
        y_fac = fac.as_linop().matvec(x)
        y_true = block @ x
        rel = np.abs(y_fac - y_true).max() / max(np.abs(y_true).max(), 1e-300)
        log_info("streamer rel max error after merge: %.3e", rel)

    @property
    def current_col_node(self) -> TreeNode:
        check(not self.is_done(), "streamer is done")
        return self._order[self._pos]

    def feed(self, Phi: np.ndarray) -> None:
        """Feed the column block for the CURRENT column-tree leaf
        (reference: bfFacStreamerFeed, src/fac_streamer.c:386-518)."""
        check(not self.is_done(), "streamer already done")
        node = self._order[self._pos]
        check(node.is_leaf, "internal node reached without merge")
        Phi = np.asarray(Phi)
        check(
            Phi.shape[1] == node.num_points,
            f"fed block has {Phi.shape[1]} cols, leaf expects {node.num_points}",
        )
        if self.spec.compare_relative_errors:
            self._dense_blocks.append(Phi.copy())
        if Phi.shape[1] > 0:
            self._stack.append(_leaf_fac(self.spec, node, Phi))
        self._pos += 1
        self._advance_past_internal()

    def is_done(self) -> bool:
        """(reference: bfFacStreamerIsDone, src/fac_streamer.c:520)"""
        return self._pos >= len(self._order)

    def get_fac(self) -> PartialFac:
        """The single root factorization
        (reference: bfFacStreamerGetFac, src/fac_streamer.c:524)."""
        check(self.is_done(), "streamer not finished")
        check(len(self._stack) == 1, "stream did not reduce to a single fac")
        return self._stack[0]

    def get_fac_span(self) -> LinOp:
        """Horizontal concatenation of the remaining partial facs
        (reference: bfFacStreamerGetFacSpan + bfFacSpanGetMat,
        src/fac_span.c)."""
        check(len(self._stack) >= 1, "nothing streamed")
        if len(self._stack) == 1:
            return self._stack[0].as_linop()
        return BlockDense.from_row([f.as_linop() for f in self._stack])
