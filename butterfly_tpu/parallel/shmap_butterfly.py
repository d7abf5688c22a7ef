"""Explicit per-level butterfly exchange: shard_map + ONE all-to-all.

SURVEY.md §2.10's central parallel design is "per-level all-to-all of
leaf-block activations over the device interconnect". The GSPMD path (parallel/sharding.py)
leaves the exchange to the compiler; this module is the EXPLICIT schedule —
the distributed-FFT transpose applied to the butterfly:

  1. shard the NB leaf blocks contiguously over the model axis (top digits
     of the block index = shard id); all levels whose mixing stride stays
     inside a shard run LOCALLY (one einsum per level per shard);
  2. ONE tiled `lax.all_to_all` re-blocks activations so each shard owns
     the blocks with fixed LOW digits (the block transpose);
  3. the remaining log_R(D) levels — whose partners differ in TOP digits —
     are now local too (their lo-axis weight slices are mod-D strided; they
     are pre-permuted contiguous at setup and sharded on the lo axis).

Exchange volume is exactly one pass of the activation tensor:
NB*m*r*(D-1)/D elements — the minimum any butterfly schedule can move.
The output lands in low-digit block order; `unpermute_rows` restores the
canonical order (a pure reshape/transpose on the global view).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from butterfly_tpu.ops.butterfly import UniformButterfly, apply_factor
from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = ["ShardedButterfly"]


def _body(axis, D, NB, R, prec, x_local, leaf, w1s, w2s):
    """Per-shard apply: local levels, one all-to-all, top levels."""
    NBl = NB // D
    r = x_local.shape[-1]
    cur = x_local
    for W in ([] if leaf is None else [leaf]) + list(w1s):
        cur = apply_factor(W, cur, R, prec)

    if w2s:
        cur = cur.reshape(NBl, -1, r)
        m_ = cur.shape[1]
        # block transpose: local block q = u*D + t -> make chunk t contiguous
        cur = cur.reshape(NBl // D, D, m_, r).swapaxes(0, 1).reshape(NBl, m_, r)
        # one tiled all-to-all over the model axis: shard t sends chunk t'
        # to shard t'; result index u' = s*NBl/D + u == global_block // D
        cur = jax.lax.all_to_all(cur, axis, split_axis=0, concat_axis=0,
                                 tiled=True).reshape(-1, r)
        for W in w2s:  # lo-axis pre-permuted local slices
            cur = apply_factor(W, cur, R, prec)
    return cur


class ShardedButterfly:
    """A UniformButterfly applied with the explicit exchange schedule.

    apply(x) expects x of shape (NB*k_in, r) with rows sharded P(axis); the
    result rows are in LOW-DIGIT block order when an exchange happened —
    call `unpermute_rows` for canonical order (or keep the permuted layout
    through subsequent elementwise/top-k work, which is order-free after an
    argmax id-map).
    """

    def __init__(self, bf: UniformButterfly, mesh: Mesh, axis: str = "model"):
        self.mesh = mesh
        self.axis = axis
        self.R = R = bf.radix
        self.NB = NB = bf.NB
        D = mesh.shape[axis]
        self.D = D
        check(D == 1 or R ** int(round(math.log(D, R))) == D,
              "model axis size must be a power of the radix",
              InvalidArgumentsError)
        check(NB % (D * D) == 0 or D == 1,
              "need NB >= D^2 blocks for the exchange reshape",
              InvalidArgumentsError)

        L = bf.num_levels
        # levels with mixing stride inside a shard: R^(l+1) <= NB/D
        n_local = min(L, max(0, int(round(math.log(max(NB // D, 1), R)))))
        self.n_local = n_local
        self.shape = bf.shape
        self.k_in = bf.k_in
        self.m_out = bf.m_out

        ns = lambda spec: NamedSharding(mesh, spec)
        self.leaf = (
            None if bf.leaf is None
            else jax.device_put(bf.leaf, ns(P(axis, None, None)))
        )
        self.w1 = [
            jax.device_put(W, ns(P(axis, None, None, None, None, None)))
            for W in bf.levels[:n_local]
        ]
        # top levels: group the lo axis by (lo % D) so each shard's slice is
        # contiguous; within a group keep lo//D order
        self.w2 = []
        for W in bf.levels[n_local:]:
            lo = W.shape[3]
            check(lo % D == 0, "top-level lo must divide the axis")
            perm = np.argsort(np.arange(lo) % D, kind="stable")
            Wp = jnp.asarray(W)[:, :, :, perm]
            self.w2.append(
                jax.device_put(Wp, ns(P(None, None, None, axis, None, None)))
            )

        body = functools.partial(_body, axis, D, NB, R, bf.precision)
        w1_specs = [P(axis, None, None, None, None, None) for _ in self.w1]
        leaf_spec = None if self.leaf is None else P(axis, None, None)
        w2_specs = [P(None, None, None, axis, None, None) for _ in self.w2]
        self._apply = jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(P(axis, None), leaf_spec, w1_specs, w2_specs),
            out_specs=P(axis, None),
        ))

    # -- apply -------------------------------------------------------------

    def apply(self, x):
        """x: (NB*k_in, r) rows sharded over the model axis."""
        return self._apply(x, self.leaf, self.w1, self.w2)

    def __call__(self, x):
        return self.apply(x)

    @property
    def exchanged(self) -> bool:
        return len(self.w2) > 0

    def expected_exchange_elems(self, r: int) -> int:
        """Elements moved by the single all-to-all (excluding the local
        chunk each shard keeps)."""
        if not self.exchanged:
            return 0
        m_mid = self.w2[0].shape[5]
        return self.NB * m_mid * r * (self.D - 1) // self.D

    def unpermute_rows(self, y):
        """Restore canonical block order after the exchange (global view)."""
        if not self.exchanged:
            return y
        r = y.shape[-1]
        m = self.m_out
        Dv = self.D
        yb = y.reshape(Dv, self.NB // Dv, m, r)
        return jnp.transpose(yb, (1, 0, 2, 3)).reshape(self.NB * m, r)
