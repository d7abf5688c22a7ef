"""UniformButterfly: the flagship butterfly apply format.

The reference applies butterflies by walking a recursive object graph of
block matrices, one small zgemv per block (src/mat_block_dense.c:574-630,
src/fac.c:133-146). This redesign stores each level in "FFT form" and
applies it as ONE multi-batch-dimension `dot_general` with NO gathers,
scatters, or transposes:

    level l weights:  W_l of shape (hi, c, d, lo, m, k),  hi = NB / (R^{l+1}),
                      lo = R^l, c,d in [R] (the radix),
    activations:      x of shape (NB, k, r) viewed as (hi, d, lo, k, r),
    apply:            y[h,c,l] = sum_d W[h,c,d,l] @ x[h,d,l]
                      == einsum('hcdlmk,hdlkr->hclmr', W, x).

Block i mixes with blocks differing in base-R digit l of the block index —
exactly the butterfly sparsity pattern of the reference's MatBlockCoo factors
(src/fac_helm2.c:309-312), but the inter-level "re-blocking" permutation is
absorbed into einsum batch dimensions, so XLA emits one batched GEMM per
level and nothing else.

The structure is a registered pytree: factors are differentiable leaves, so a
butterfly can be fine-tuned end-to-end with jax.grad (used by the retrieval
model's distillation training step).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from butterfly_tpu.ops import linop as L
from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = ["UniformButterfly", "apply_factor", "random_butterfly",
           "reference_apply"]


def apply_factor(W, x, radix: int = 2, precision=None, act_dtype=None):
    """One butterfly factor on x (n, r) -> (n_out, r): the block-diagonal
    leaf (W of shape (NB, m, k)) or one FFT-form level (W of shape
    (hi, R, R, lo, m, k)), as one einsum. Both shapes are read off W, so
    the same call serves a shard's local blocks. bf16/f16 products
    accumulate in f32, wider types in their own; `act_dtype` (None: keep
    the product's type) is the dtype the result is stored in."""
    r = x.shape[1]
    acc = jnp.promote_types(W.dtype, jnp.float32)
    if W.ndim == 3:
        NB, m, k = W.shape
        y = jnp.einsum("bmk,bkr->bmr", W,
                       x.reshape(NB, k, r).astype(W.dtype),
                       preferred_element_type=acc, precision=precision)
    else:
        hi, _, _, lo, m, k = W.shape
        y = jnp.einsum("hcdlmk,hdlkr->hclmr", W,
                       x.reshape(hi, radix, lo, k, r).astype(W.dtype),
                       preferred_element_type=acc, precision=precision)
    if act_dtype is not None:
        y = y.astype(act_dtype)
    return y.reshape(-1, r)


@jax.tree_util.register_pytree_node_class
class UniformButterfly:
    """A uniform-rank butterfly operator: optional block-diagonal leaf factor
    followed by `L` FFT-form mixing levels.

    Attributes:
      leaf: (NB, m0, k0) block-diagonal leaf factor or None (identity).
      levels: list of (hi, R, R, lo, m, k) arrays, level l has hi = NB/R^{l+1},
        lo = R^l; level l's k must equal level l-1's m (or leaf m0).
    """

    def __init__(self, leaf, levels: Sequence, radix: int = 2,
                 precision=None, act_dtype=None):
        # precision: lax dot precision for apply ("highest"/"high"/None).
        # A default-precision f32 product may run in TF32 (~1e-3 rel err);
        # accuracy-gated f32 operators (e.g. distilled real facs meeting
        # the BASELINE <=1e-6 clause) must carry "highest".
        # act_dtype: dtype the activations are stored in between levels
        # (None: the product's own f32/f64/complex type). bfloat16 halves
        # the activation traffic of a bandwidth-bound chain; every level
        # still accumulates in f32.
        self.leaf = leaf
        self.levels = list(levels)
        self.radix = radix
        self.precision = precision
        self.act_dtype = None if act_dtype is None else jnp.dtype(act_dtype)
        if leaf is not None:
            self.NB = leaf.shape[0]
            k_in = leaf.shape[2]
            m_prev = leaf.shape[1]
        else:
            check(len(self.levels) > 0, "butterfly needs at least one factor")
            W0 = self.levels[0]
            self.NB = W0.shape[0] * W0.shape[1] * W0.shape[3]
            k_in = W0.shape[5]
            m_prev = k_in
        for l, W in enumerate(self.levels):
            hi, c, d, lo, m, k = W.shape
            check(c == radix and d == radix, "level radix mismatch")
            check(hi * radix * lo == self.NB, f"level {l} shape inconsistent")
            check(lo == radix**l, f"level {l} lo must be radix^l")
            check(k == m_prev, f"level {l} input rank {k} != previous output {m_prev}")
            m_prev = m
        self.m_out = m_prev
        self.k_in = k_in
        self.shape = (self.NB * self.m_out, self.NB * self.k_in)

    # -- pytree protocol (factors are differentiable leaves) -------------

    def tree_flatten(self):
        return (self.leaf, self.levels), (self.radix, self.precision,
                                          self.act_dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        leaf, levels = children
        return cls(leaf, levels, radix=aux[0], precision=aux[1],
                   act_dtype=aux[2])

    # -- apply -----------------------------------------------------------

    def apply(self, x):
        """Apply to x of shape (n,) or (n, r); jit-friendly."""
        x = jnp.asarray(x)
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        factors = ([] if self.leaf is None else [self.leaf]) + self.levels
        for W in factors:
            x = apply_factor(W, x, self.radix, self.precision, self.act_dtype)
        return x[:, 0] if was_vec else x

    def __call__(self, x):
        return self.apply(x)

    def matmat(self, X):
        """Batched multi-RHS apply (alias for solver interop)."""
        return self.apply(X)

    # -- introspection ---------------------------------------------------

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def nbytes(self) -> int:
        total = self.leaf.nbytes if self.leaf is not None else 0
        return total + sum(W.nbytes for W in self.levels)

    def flops_per_col(self) -> int:
        """Useful multiply-add flops (x2) per RHS column."""
        total = 0
        if self.leaf is not None:
            NB, m, k = self.leaf.shape
            total += 2 * NB * m * k
        for W in self.levels:
            hi, c, d, lo, m, k = W.shape
            total += 2 * hi * c * d * lo * m * k
        return total

    def astype(self, dtype) -> "UniformButterfly":
        leaf = None if self.leaf is None else self.leaf.astype(dtype)
        return UniformButterfly(
            leaf, [W.astype(dtype) for W in self.levels], self.radix,
            precision=self.precision, act_dtype=self.act_dtype,
        )

    # -- oracle conversion ----------------------------------------------

    def to_linop(self) -> L.LinOp:
        """Equivalent host LinOp (BlockDiag/BlockCoo chain) for testing."""
        R = self.radix
        factors: list[L.LinOp] = []
        if self.leaf is not None:
            leaf = np.asarray(self.leaf, dtype=np.float64)
            factors.append(L.BlockDiag([L.Dense(leaf[i]) for i in range(self.NB)]))
        for W in self.levels:
            Wn = np.asarray(W, dtype=np.float64)
            hi, _, _, lo, m, k = Wn.shape
            row_offsets = np.arange(self.NB + 1) * m
            col_offsets = np.arange(self.NB + 1) * k
            row_inds, col_inds, blocks = [], [], []
            for h in range(hi):
                for c in range(R):
                    for ll in range(lo):
                        i = (h * R + c) * lo + ll
                        for d in range(R):
                            j = (h * R + d) * lo + ll
                            row_inds.append(i)
                            col_inds.append(j)
                            blocks.append(L.Dense(Wn[h, c, d, ll]))
            factors.append(
                L.BlockCoo(row_offsets, col_offsets, row_inds, col_inds, blocks)
            )
        return L.Product(list(reversed(factors)))


def random_butterfly(
    num_blocks: int,
    block: int,
    num_levels: int | None = None,
    radix: int = 2,
    dtype=jnp.float32,
    key=None,
    with_leaf: bool = True,
) -> UniformButterfly:
    """A random orthonormal-ish uniform butterfly (scaled so products neither
    explode nor vanish): NB=num_blocks leaf blocks of size `block`."""
    check(num_blocks >= radix, "need at least radix blocks", InvalidArgumentsError)
    max_levels = int(round(math.log(num_blocks, radix)))
    check(radix**max_levels == num_blocks, "num_blocks must be a power of radix",
          InvalidArgumentsError)
    if num_levels is None:
        num_levels = max_levels
    check(num_levels <= max_levels, "too many levels", InvalidArgumentsError)
    if key is None:
        key = jax.random.key(0)

    keys = jax.random.split(key, num_levels + 1)
    leaf = None
    if with_leaf:
        leaf = jax.random.normal(
            keys[0], (num_blocks, block, block), dtype=jnp.float32
        ) / np.sqrt(block)
        leaf = leaf.astype(dtype)
    levels = []
    for l in range(num_levels):
        hi, lo = num_blocks // radix ** (l + 1), radix**l
        W = jax.random.normal(
            keys[l + 1], (hi, radix, radix, lo, block, block), dtype=jnp.float32
        ) / np.sqrt(radix * block)
        levels.append(W.astype(dtype))
    return UniformButterfly(leaf, levels, radix)


def reference_apply(bf: UniformButterfly, X) -> np.ndarray:
    """Plain float64 (complex128 for complex weights) NumPy level-by-level
    apply of `bf` to X (n, r): the oracle for the device apply at sizes
    where the dense operator does not fit."""
    R = bf.radix
    r = X.shape[1]
    dt = np.result_type(np.asarray(X).dtype, np.float64,
                        *[np.dtype(W.dtype) if W.dtype != jnp.bfloat16
                          else np.float32 for W in bf.levels])
    cur = np.asarray(X, dt).reshape(bf.NB, bf.k_in, r)
    if bf.leaf is not None:
        cur = np.matmul(np.asarray(bf.leaf).astype(dt), cur)
    for W in bf.levels:
        W = np.asarray(W).astype(dt)
        hi, _, _, lo, m, k = W.shape
        # y[h,c,l] = sum_d W[h,c,d,l] @ x[h,d,l] as one batched matmul
        Wb = W.transpose(0, 3, 1, 4, 2, 5).reshape(hi * lo, R * m, R * k)
        xb = cur.reshape(hi, R, lo, k, r).transpose(0, 2, 1, 3, 4)
        y = np.matmul(Wb, xb.reshape(hi * lo, R * k, r))
        cur = y.reshape(hi, lo, R, m, r).transpose(0, 2, 1, 3, 4)
        cur = cur.reshape(bf.NB, m, r)
    return cur.reshape(-1, r)
