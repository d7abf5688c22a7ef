"""Pipeline parallelism: butterfly level groups as pipeline stages.

The reference has no parallelism of any kind (SURVEY.md §0/§2.10); this is
the new design SURVEY §2.10 plans for PP: "stage = butterfly level group;
microbatch queries through stages".

The obstacle to pipelining a butterfly is that every level has a DIFFERENT
weight shape (hi, R, R, lo, m, k) with hi = NB/R^(l+1), lo = R^l — an SPMD
pipeline needs every stage to run the same program on same-shape operands.
This module first converts the butterfly to **slot form** (a Pease-style
constant-geometry factorization): activations live in a per-level slot
order where the R blocks mixed by the current level are always ADJACENT, so
every level becomes

    weights  Wc_l : (NB/R, R, R, blk, blk)     (same shape for all l)
    perm_l   : (NB,) int32                      (slot reordering to the next
                                                 level's pair order)
    z <- take(einsum('pcdmk,pdkr->pcmr', Wc_l, z.reshape(NB/R, R, blk, r)),
              perm_l, axis=0)

The block-diagonal leaf factor folds into level 0's weights for free
(slot (p, d) of level 0 reads natural block p*R+d, so
Wc0'[p,c,d] = Wc0[p,c,d] @ leaf[p*R+d]).

With every level now shape-uniform, levels stack along a leading axis and
split into S equal stage groups sharded over a ("stage",) mesh axis. The
pipeline itself is the classic GPipe rotation written with shard_map +
lax.ppermute: T = M + S - 1 steps, stage 0 injects microbatch t, every
device applies its local level group, activations rotate one stage per step
over the interconnect, the last stage banks finished microbatches (bubble fraction
(S-1)/T, amortized away as M grows).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from butterfly_tpu.ops.butterfly import UniformButterfly
from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = ["SlotButterfly", "PipelinedButterfly", "make_stage_mesh"]


def _slot_order(NB: int, R: int, level: int) -> np.ndarray:
    """order[j] = natural block index held in slot j when entering `level`
    (digit `level` moved to the least-significant position, so the R blocks
    a level mixes sit in adjacent slots)."""
    j = np.arange(NB)
    d = j % R
    rest = j // R
    lo = R**level
    h, v = rest // lo, rest % lo
    return (h * R + d) * lo + v


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SlotButterfly:
    """Constant-geometry (slot-form) butterfly: stacked uniform levels.

    weights: (L, NB/R, R, R, blk, blk); perms: (L, NB) int32 slot
    reorderings applied AFTER each level's mixing.
    """

    weights: jnp.ndarray
    perms: jnp.ndarray
    radix: int

    def tree_flatten(self):
        return (self.weights, self.perms), (self.radix,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])

    @property
    def NB(self) -> int:
        return self.weights.shape[1] * self.radix

    @property
    def blk(self) -> int:
        return self.weights.shape[4]

    @classmethod
    def from_butterfly(cls, bf: UniformButterfly) -> "SlotButterfly":
        R, NB = bf.radix, bf.NB
        blk = bf.k_in
        check(bf.m_out == blk and all(
            W.shape[4] == blk and W.shape[5] == blk for W in bf.levels
        ), "slot form requires uniform ranks", InvalidArgumentsError)
        L = bf.num_levels
        ws, perms = [], []
        for l, W in enumerate(bf.levels):
            hi, _, _, lo = W.shape[:4]
            # Wc[p, c, d] with p = h*lo + v  (natural input block of slot
            # (p, d) at level l is insert_digit(p, l, d))
            Wc = jnp.transpose(jnp.asarray(W), (0, 3, 1, 2, 4, 5)).reshape(
                NB // R, R, R, blk, blk
            )
            if l == 0 and bf.leaf is not None:
                # fold leaf: slot (p, d) reads natural block p*R + d
                leaf = jnp.asarray(bf.leaf).reshape(NB // R, R, blk, blk)
                Wc = jnp.einsum("pcdmn,pdnk->pcdmk", Wc, leaf)
            ws.append(Wc)
            # after mixing, slot j holds natural block order_l[j]; reorder
            # into the next level's pair order (natural at the end)
            order_now = _slot_order(NB, R, l)
            order_next = (
                _slot_order(NB, R, l + 1) if l + 1 < L else np.arange(NB)
            )
            pos = np.empty(NB, dtype=np.int64)
            pos[order_now] = np.arange(NB)
            perms.append(pos[order_next].astype(np.int32))
        return cls(jnp.stack(ws), jnp.asarray(np.stack(perms)), R)

    # -- apply ------------------------------------------------------------

    def level_apply(self, Wc, perm, z):
        """One slot-form level: z (NB, blk, r) -> (NB, blk, r)."""
        NB, blk, r = z.shape
        R = self.radix
        zp = z.reshape(NB // R, R, blk, r)
        y = jnp.einsum(
            "pcdmk,pdkr->pcmr", Wc, zp, preferred_element_type=jnp.float32
        ).astype(z.dtype)
        return jnp.take(y.reshape(NB, blk, r), perm, axis=0)

    def apply(self, x):
        """Sequential (single-device) slot-form apply; oracle for the
        pipelined schedule. x: (n,) or (n, r)."""
        x = jnp.asarray(x)
        was_vec = x.ndim == 1
        if was_vec:
            x = x[:, None]
        n, r = x.shape
        NB, blk = self.NB, self.blk
        z = x.reshape(NB, blk, r)

        def body(z, wp):
            Wc, perm = wp
            return self.level_apply(Wc, perm, z), 0.0

        # levels have uniform shapes -> one scanned program for all levels
        z, _ = jax.lax.scan(body, z, (self.weights, self.perms))
        out = z.reshape(n, r)
        return out[:, 0] if was_vec else out


def make_stage_mesh(num_stages: int) -> Mesh:
    devs = jax.devices()
    check(num_stages <= len(devs), "not enough devices",
          InvalidArgumentsError)
    return Mesh(np.array(devs[:num_stages]), ("stage",))


class PipelinedButterfly:
    """GPipe-style pipelined butterfly apply over a ("stage",) mesh.

    Levels split into `num_stages` equal groups; group s's weights are
    placed on stage device s (weight memory per chip drops by S); the RHS
    columns split into `num_micro` microbatches that rotate through the
    stages with lax.ppermute.
    """

    def __init__(self, bf: UniformButterfly, mesh: Mesh,
                 num_micro: int = 4):
        check("stage" in mesh.axis_names, "mesh needs a 'stage' axis",
              InvalidArgumentsError)
        self.mesh = mesh
        self.S = mesh.shape["stage"]
        self.num_micro = num_micro
        sb = SlotButterfly.from_butterfly(bf)
        L = sb.weights.shape[0]
        check(L % self.S == 0,
              f"num levels {L} must divide into {self.S} stages",
              InvalidArgumentsError)
        self.g = L // self.S
        self.radix = sb.radix
        self.NB, self.blk = sb.NB, sb.blk
        self.shape = bf.shape
        # stack per stage and shard the leading stage axis
        wsh = NamedSharding(mesh, P("stage"))
        self.weights = jax.device_put(
            sb.weights.reshape((self.S, self.g) + sb.weights.shape[1:]), wsh
        )
        self.perms = jax.device_put(
            sb.perms.reshape(self.S, self.g, -1), wsh
        )
        self._sb = sb
        self._apply_jit = jax.jit(functools.partial(
            _pipeline_apply, self.mesh, self.S, self.g, self.num_micro,
            self.radix,
        ))

    def apply(self, x):
        """x: (n, r) with num_micro dividing r."""
        x = jnp.asarray(x)
        check(x.ndim == 2 and x.shape[1] % self.num_micro == 0,
              "r must divide into microbatches", InvalidArgumentsError)
        return self._apply_jit(self.weights, self.perms, x)

    def __call__(self, x):
        return self.apply(x)


def _slot_level_apply(R, Wc, perm, z):
    NB, blk, r = z.shape
    zp = z.reshape(NB // R, R, blk, r)
    y = jnp.einsum(
        "pcdmk,pdkr->pcmr", Wc, zp, preferred_element_type=jnp.float32
    ).astype(z.dtype)
    return jnp.take(y.reshape(NB, blk, r), perm, axis=0)


def _pipeline_apply(mesh, S, g, M, R, weights, perms, x):
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    n, r = x.shape
    rm = r // M
    NB = perms.shape[-1]
    blk = n // NB
    micro = x.reshape(NB, blk, M, rm).transpose(2, 0, 1, 3)  # (M, NB, blk, rm)

    def kernel(w_local, p_local, micro):
        # w_local: (1, g, NB/R, R, R, blk, blk); micro: (M, NB, blk, rm)
        s = jax.lax.axis_index("stage")
        # carries vary per stage device -> mark as varying over the axis
        state = jax.lax.pcast(jnp.zeros_like(micro[0]), ("stage",), to="varying")
        outs = jax.lax.pcast(jnp.zeros_like(micro), ("stage",), to="varying")
        T = M + S - 1

        def step(t, carry):
            state, outs = carry
            inject = micro[jnp.minimum(t, M - 1)]
            state = jnp.where((s == 0) & (t < M), inject, state)
            for i in range(g):
                state = _slot_level_apply(
                    R, w_local[0, i], p_local[0, i], state
                )
            m_out = jnp.clip(t - (S - 1), 0, M - 1)
            write = (s == S - 1) & (t >= S - 1)
            outs = jax.lax.dynamic_update_index_in_dim(
                outs,
                jnp.where(write, state, outs[m_out]),
                m_out,
                axis=0,
            )
            state = jax.lax.ppermute(
                state, "stage", [(i, (i + 1) % S) for i in range(S)]
            )
            return state, outs

        state, outs = jax.lax.fori_loop(0, T, step, (state, outs))
        # only the last stage holds real outputs; replicate via psum
        outs = jnp.where(s == S - 1, outs, jnp.zeros_like(outs))
        return jax.lax.psum(outs, "stage")

    outs = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P("stage"), P("stage"), P()),
        out_specs=P(),
    )(weights, perms, micro)
    return outs.transpose(1, 2, 0, 3).reshape(n, r)
