"""Partition-aware device apply for multilevel (HODLR-butterfly) operators.

The reference's multilevel Helmholtz factorization is a recursive partition
(facHelm2MakeMultilevel_rec, src/fac_helm2.c:806-941): dense blocks where
target and source overlap, single butterflies where they are separated.
Its apply walks that recursive graph one tiny zgemv at a time
(src/mat_block_dense.c:574-630).

Here the partition compiles into TWO chained block-sparse cell passes
(ops/cellsp.py), each a batched matmul over (128, 128) weight tiles:

  pass 1  t = V-cells(x)      compress: every separated block's rank-rho
                              row space
  pass 2  y = U-cells(t) + dense-cells(x)
                              expand + near-field + assembly, multi-buffer

Separated (admissible) blocks are factored as LOW-RANK Z ~= U V, not as
per-block butterflies: admissibility bounds their rank (that is exactly why
the reference's partition distinguishes them, src/fac_helm2.c:860-941), and
a flat rank-rho GEMM pair is both fewer flops than a depth-L butterfly at
these tile sizes (rho tracks the butterfly's own level rank) and exact to
f32. The factorization runs ON DEVICE: randomized sketch Y = Z Omega, QR,
then V solved by LEAST SQUARES  V = (Q^T Q)^{-1} Q^T Z  — the LS solve
makes the reconstruction a true oblique projection of Z, so the f32 QR's
orthogonality error cancels instead of accumulating, and the achieved
per-block residual (measured by random probe, adaptively rank-escalated)
lands at the f32 floor ~1e-7.

Blocks too large to batch (top partition levels, ~N/4 wide) keep their
native butterfly chain and apply through their own packed stage plans.

Complex operators ride the interleaved 2x2 real embedding throughout
(row/col 2i = Re_i, 2i+1 = Im_i), so a complex chain block at complex
offset (i0, j0) occupies real rows [2*i0, 2*i0+2nr) — contiguity survives.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from butterfly_tpu.ops import packed as packed_mod
from butterfly_tpu.ops.cellsp import GK, GM, Cell, CellPlan, \
    cells_from_dense_block
from butterfly_tpu.ops.linop import LinOp
from butterfly_tpu.utils.errors import InvalidArgumentsError, check
from butterfly_tpu.utils.logging import log_info

__all__ = ["PartitionPlan", "partition_apply_plan"]


def _interleave_embed(Z: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(2m, 2k) interleaved real embedding of a complex (m, k) block."""
    m, k = Z.shape
    R = np.empty((2 * m, 2 * k), dtype)
    R[0::2, 0::2] = Z.real
    R[0::2, 1::2] = -Z.imag
    R[1::2, 0::2] = Z.imag
    R[1::2, 1::2] = Z.real
    return R


def _materialize_chain(chain) -> np.ndarray:
    """Dense (nr, nc) matrix of one positioned chain, multiplied out
    UNIT-WISE on the host: each factor's blocks hit only their own row/col
    ranges of the accumulator, so the cost is the chain's true block flops.
    (The first version densified every factor and ran full (out, in) GEMMs
    — NB x the flops; at 65k that made one 16-member class chunk cost ~8
    CPU-minutes instead of ~30 s.)"""
    cur = None
    for f in chain.factors:
        dts = [u.data.dtype for u in f.gemms] + [
            u.weights.dtype for u in f.scales]
        dt = np.result_type(*dts) if dts else np.float64
        if cur is None:
            out = np.zeros((f.out_dim, f.in_dim), dt)
            for u in f.gemms:
                d = np.asarray(u.data)
                out[u.out_off:u.out_off + d.shape[0],
                    u.in_off:u.in_off + d.shape[1]] += d
            for u in f.scales:
                # ScaleUnits (Identity/Diag/Perm): scatter-scaled entries
                out[u.out_idx, u.in_idx] += u.weights
        else:
            out = np.zeros((f.out_dim, cur.shape[1]),
                           np.result_type(dt, cur.dtype))
            for u in f.gemms:
                d = np.asarray(u.data)
                out[u.out_off:u.out_off + d.shape[0]] += (
                    d @ cur[u.in_off:u.in_off + d.shape[1]])
            for u in f.scales:
                out[u.out_idx] += u.weights[:, None] * cur[u.in_idx]
        cur = out
    return cur


@dataclasses.dataclass
class _Blk:
    i0: int      # real row offset
    j0: int      # real col offset
    nr: int      # real rows (true)
    nc: int      # real cols (true)
    rmax: int = 0  # max unit rank of the source chain (pre-embedding)
    chain: object = None  # the positioned factor chain (for materialization)

    # the member window is placed so its row start is 8-aligned (sublane)
    # and its col start is 128-aligned (cell grid); the residual shifts are
    # embedded as leading zero rows/cols of the member matrix
    @property
    def shift_r(self) -> int:
        return self.i0 % 8

    @property
    def shift_c(self) -> int:
        return self.j0 % GK

    @property
    def span(self) -> int:
        return max(self.nr + self.shift_r, self.nc + self.shift_c)


def _size_classes(sizes, tiles):
    """Map each size to the smallest tile >= size (closed list: oversized
    blocks take the per-block stage-plan path instead)."""
    out = []
    for s in sizes:
        for t in tiles:
            if s <= t:
                out.append(t)
                break
        else:
            raise InvalidArgumentsError(
                f"block size {s} exceeds largest tile {tiles[-1]}")
    return out


def _bytes_limit() -> "int | None":
    """Device memory the allocator may use (`memory_stats()["bytes_limit"]`),
    or None on the CPU backend, which reports no limit. On an accelerator
    a missing limit is an error: the plan build sizes its buffers by it."""
    import jax

    dev = jax.devices()[0]
    ms = dev.memory_stats() or {}
    if "bytes_limit" in ms:
        return int(ms["bytes_limit"])
    check(dev.platform == "cpu",
          f"{dev.device_kind}: memory_stats() reports no bytes_limit",
          InvalidArgumentsError)
    return None


class PartitionPlan:
    """Executable partition apply. `params` is a pytree (pass it to the
    jitted `apply_with`); `apply(x)` is the convenience wrapper."""

    def __init__(self, op: LinOp, rank=None, rank_margin: int = 32,
                 bf_tiles=(256, 512, 1024, 2048, 4096),
                 lr_tol: float = 3e-7,
                 batch_budget_bytes: int = 1 << 30,
                 workers: int = 2,
                 mega_resident_bytes: int | None = None,
                 # accepted for backward compatibility with older callers
                 distill_tol=None, dense_tiles=None,
                 materialize_chunk=None):
        import jax
        import jax.numpy as jnp

        self._complex = bool(np.issubdtype(op.dtype, np.complexfloating))
        mul = 2 if self._complex else 1
        n_c, m_c = op.shape
        self.shape = (n_c, m_c)
        self.n2, self.m2 = n_c * mul, m_c * mul

        chains: list = []
        packed_mod._flatten(op, 0, 0, chains)
        dense_blks: list[tuple[_Blk, np.ndarray]] = []
        lr_blks: list[_Blk] = []
        for c in chains:
            nr_c = c.factors[-1].out_dim
            nc_c = c.factors[0].in_dim
            blk = _Blk(mul * c.i0, mul * c.j0, mul * nr_c, mul * nc_c)
            f0 = c.factors[0]
            if (len(c.factors) == 1 and len(f0.gemms) == 1 and not f0.scales
                    and f0.gemms[0].in_off == 0 and f0.gemms[0].out_off == 0):
                Z = f0.gemms[0].data
                W = (_interleave_embed(Z) if self._complex
                     else np.asarray(Z, np.float32))
                dense_blks.append((blk, W))
            else:
                # unit rank proxy: min dim for GEMMs, entry count for scale
                # units (a ScaleUnit is a scaled sub-permutation, rank = L)
                blk.rmax = max(
                    [min(u.data.shape) for f in c.factors for u in f.gemms]
                    + [u.weights.size for f in c.factors
                       for u in f.scales]
                )
                blk.chain = c
                lr_blks.append(blk)

        # oversized blocks (top partition levels are ~N/4 wide, with ranks
        # that grow with k*diam) keep their native butterfly chains and
        # apply through their OWN packed stage plans
        mega_blks = [b for b in lr_blks if b.span > bf_tiles[-1]]
        lr_blks = [b for b in lr_blks if b.span <= bf_tiles[-1]]
        if mega_blks:
            log_info("partition: %d oversized butterfly blocks apply via "
                     "their own stage plans", len(mega_blks))
        log_info("partition: %d dense blocks, %d low-rank blocks, %d mega",
                 len(dense_blks), len(lr_blks), len(mega_blks))

        pool = ThreadPoolExecutor(max_workers=workers)
        self._flops = 0
        self._nbytes = 0
        cells1: list[Cell] = []   # pass 1: x -> t  (V cells)
        cells2: list[Cell] = []   # pass 2: [x, t] -> y  (dense + U cells)

        # ---- dense cells ------------------------------------------------
        for blk, Wb in dense_blks:
            cells_from_dense_block(Wb, blk.i0, blk.j0, cells2)
        n_dense_cells = len(cells2)

        # ---- low-rank classes: device sketch factorization --------------
        self._lr_meta = []
        t_off = 0          # running row offset into the t buffer
        max_win_end = self.n2
        dev_tiles1: list = []   # V tile stacks (device)
        dev_tiles2: list = []   # U tile stacks (device)
        if lr_blks:
            keys = _size_classes([b.span for b in lr_blks], bf_tiles)
            groups = []
            for cls in sorted(set(keys)):
                members = [b for b, k in zip(lr_blks, keys) if k == cls]
                gmax = max(1, batch_budget_bytes // (cls * cls * 4))
                for g0 in range(0, len(members), gmax):
                    groups.append((cls, members[g0:g0 + gmax]))

            hp = jax.lax.Precision.HIGHEST

            def _factor_batch(Z, rho, key):
                """Z: (B, npad, npad) device f32. Returns (U, V, rel):
                U (B, npad, rho), V (B, rho, npad), rel = max over members
                of probe-residual / max member norm. V is the least-squares
                fit against Q, so f32 QR orthogonality error cancels."""
                kO, kP = jax.random.split(jax.random.key(key))
                npad_ = Z.shape[2]
                Om = jax.random.normal(kO, (npad_, rho), jnp.float32)
                Y = jnp.einsum("bnm,mr->bnr", Z, Om, precision=hp)
                Q, _ = jnp.linalg.qr(Y)
                G = jnp.einsum("bnr,bns->brs", Q, Q, precision=hp)
                C = jnp.einsum("bnr,bnm->brm", Q, Z, precision=hp)
                V = jnp.linalg.solve(G, C)
                w = jax.random.normal(kP, (npad_, 8), jnp.float32)
                Zw = jnp.einsum("bnm,mq->bnq", Z, w, precision=hp)
                Rw = Zw - jnp.einsum(
                    "bnr,brq->bnq", Q,
                    jnp.einsum("brm,mq->brq", V, w, precision=hp),
                    precision=hp)
                nrm = jnp.sqrt(jnp.sum(Zw * Zw, axis=(1, 2)))
                res = jnp.sqrt(jnp.sum(Rw * Rw, axis=(1, 2)))
                rel = jnp.max(res) / jnp.maximum(jnp.max(nrm), 1e-30)
                return Q, V, rel

            factor_jit = jax.jit(_factor_batch,
                                 static_argnames=("rho", "key"))

            cls_state: dict = {}  # cls -> (rho_star, rel_floor) memo so
            # later chunks of a class skip the escalation dance (the f32
            # floor is a property of the class size, not the chunk)
            for cls, members in groups:
                B = len(members)
                npad = cls

                # member blocks are multiplied out on the host in float64
                # and cast to f32 once: an f32 device materialization left
                # full-rank rounding noise in every block (measured on an
                # H100 host at n=16384: 8.5e-7 apply rel err, against
                # 3.8e-7 from host chains, which also built faster)
                def embed_member(b):
                    Z = _materialize_chain(b.chain)
                    Zr = (_interleave_embed(Z) if self._complex
                          else np.asarray(Z, np.float32))
                    Mz = np.zeros((npad, npad), np.float32)
                    Mz[b.shift_r:b.shift_r + b.nr,
                       b.shift_c:b.shift_c + b.nc] = Zr
                    return Mz

                Mb = np.stack(list(pool.map(embed_member, members)))
                Zd = jax.block_until_ready(jnp.asarray(Mb))

                tol_eff = lr_tol
                if rank is not None:
                    rho = int(rank)
                else:
                    rmax = max(b.rmax for b in members)
                    rho = min(mul * rmax + rank_margin, npad // 2)
                    rho = max(16, (rho + 15) // 16 * 16)
                    if cls in cls_state:
                        rho = max(rho, cls_state[cls][0])
                        tol_eff = max(lr_tol, 1.5 * cls_state[cls][1])
                prev = None
                while True:
                    U, V, rel = factor_jit(Zd, rho=rho, key=7)
                    rel = float(rel)
                    if (rank is not None or rel <= tol_eff
                            or rho >= npad // 2):
                        break
                    if prev is not None and rel > 0.5 * prev[2]:
                        # rank escalation stopped helping: the residual is
                        # the f32 factorization floor (~4e-7 at npad=4096),
                        # not truncation — keep the SMALLER rank
                        U, V, rel, rho = prev[0], prev[1], prev[2], prev[3]
                        log_info("partition: class %d rel %.1e is the f32 "
                                 "floor; keeping rho %d", cls, rel, rho)
                        break
                    prev = (U, V, rel, rho)
                    rho_new = min(npad // 2, max(rho * 2, rho + 32))
                    log_info("partition: class %d rho %d rel %.1e > %.0e; "
                             "retrying at rho %d", cls, rho, rel, tol_eff,
                             rho_new)
                    rho = rho_new
                if rank is None:
                    st_ = cls_state.get(cls, (0, 0.0))
                    cls_state[cls] = (max(st_[0], rho), max(st_[1], rel))
                del Zd

                # U/V stay on the device: pad + retile them into
                # (ntiles, GM, GK) stacks that CellPlan gathers into its
                # cell-ordered weight array
                rho_pad = -(-rho // GK) * GK
                rp, npc = rho_pad // GM, npad // GK

                @jax.jit
                def _tiles(U, V):
                    B_ = U.shape[0]
                    Vp = jnp.pad(V, ((0, 0), (0, rho_pad - rho), (0, 0)))
                    Vt = Vp.reshape(B_, rp, GM, npc, GK).transpose(
                        0, 1, 3, 2, 4).reshape(-1, GM, GK)
                    Up = jnp.pad(U, ((0, 0), (0, 0), (0, rho_pad - rho)))
                    Ut = Up.reshape(B_, npc, GM, rp, GK).transpose(
                        0, 1, 3, 2, 4).reshape(-1, GM, GK)
                    return Vt, Ut

                Vt, Ut = _tiles(U, V)
                del U, V
                sid1, sid2 = len(dev_tiles1), len(dev_tiles2)
                dev_tiles1.append(jax.block_until_ready(Vt))
                dev_tiles2.append(jax.block_until_ready(Ut))

                for bi, b in enumerate(members):
                    i0a = b.i0 - b.shift_r
                    j0a = b.j0 - b.shift_c
                    max_win_end = max(max_win_end, j0a + npad)
                    # V cells: t[t_off : +rho] += V_b @ x[j0a : +npad]
                    for rr in range(rp):
                        for ccx in range(npc):
                            cells1.append(Cell(
                                dst=t_off + rr * GM, src_buf=0,
                                src_blk=j0a // GK + ccx,
                                w=("dev", sid1,
                                   (bi * rp + rr) * npc + ccx)))
                    # U cells: y[i0a : +npad] += U_b @ t[t_off : +rho]
                    for rr in range(npc):
                        for cct in range(rp):
                            cells2.append(Cell(
                                dst=i0a + rr * GM, src_buf=1,
                                src_blk=t_off // GK + cct,
                                w=("dev", sid2,
                                   (bi * npc + rr) * rp + cct)))
                    t_off += rho_pad
                self._lr_meta.append(
                    {"cls": cls, "B": B, "rho": rho, "rel": rel})
                log_info("partition: lr class %d x%d rho=%d rel=%.2e",
                         cls, B, rho, rel)
        pool.shutdown()
        self.t_rows = max(t_off, GK)

        # ---- the two cell passes ----------------------------------------
        buf0_rows = max(self.n2, max_win_end)
        self._cells1 = None
        if cells1:
            self._cells1 = CellPlan(self.t_rows, [buf0_rows], cells1,
                                    precision="highest",
                                    dev_tiles=dev_tiles1)
            self._flops += self._cells1.flops_per_col()
            self._nbytes += self._cells1.nbytes()
        if not cells2:
            cells2.append(Cell(dst=0, src_buf=0, src_blk=0,
                               w=np.zeros((GM, GK), np.float32)))
        self._cells2 = CellPlan(self.n2, [buf0_rows, self.t_rows], cells2,
                                precision="highest",
                                dev_tiles=dev_tiles2)
        self._flops += self._cells2.flops_per_col()
        self._nbytes += self._cells2.nbytes()
        log_info("partition: pass1 %d cells, pass2 %d cells (%d dense), "
                 "t rows %d, weights %.0f MB",
                 len(cells1), len(cells2), n_dense_cells, self.t_rows,
                 self._nbytes / 1e6)

        # ---- oversized butterfly blocks: one packed stage plan each ------
        # Mega weights compete with the resident cell weights for device
        # memory. Plans are built with HOST-resident params and then the
        # LARGEST are pinned to the device until `mega_resident_bytes` is
        # spent; the rest stream host-to-device per apply.
        if mega_resident_bytes is None:
            lim = _bytes_limit()
            if lim is None:
                mega_resident_bytes = 1 << 62  # cpu/host: pin everything
            else:
                # leave 8% + 3.5 GB of transient headroom (gather copies,
                # stage buffers, the cell passes' activations)
                mega_resident_bytes = max(
                    0, int(0.92 * lim) - self._nbytes - (3500 << 20))
        self.mega_streamed_bytes = 0
        self._mega = []
        if mega_blks:
            from butterfly_tpu.ops.linop import Scaled as _Scaled
            from butterfly_tpu.ops.packed import pack

            for b in mega_blks:
                c = b.chain
                check(c is not None and c.src is not None,
                      "oversized block lost its source operator")
                sub = (c.src if c.src_scale == 1.0
                       else _Scaled(c.src_scale, c.src))
                # block_align 32: mega chains have ragged ranks ~20-80,
                # and 128-padding inflates their stage buffers several-fold
                sp = pack(sub, real_embed=self._complex,
                          precision="highest", block_align=32,
                          params_on_host=True)
                nr_c, nc_c = sub.shape
                if self._complex:
                    # interleaved global index <-> the sub-plan's stacked
                    # [Re; Im] layout
                    in_idx = np.concatenate([
                        b.j0 + 2 * np.arange(nc_c),
                        b.j0 + 2 * np.arange(nc_c) + 1])
                    out_idx = np.concatenate([
                        b.i0 + 2 * np.arange(nr_c),
                        b.i0 + 2 * np.arange(nr_c) + 1])
                else:
                    in_idx = b.j0 + np.arange(nc_c)
                    out_idx = b.i0 + np.arange(nr_c)
                self._mega.append((sp, jnp.asarray(in_idx, jnp.int32),
                                   jnp.asarray(out_idx, jnp.int32)))
                self._flops += 2 * sp.stats.padded_flops_per_col
                self._nbytes += sp.stats.weight_bytes

            # pin the largest sub-plans until the resident budget is spent.
            # The budget is an ESTIMATE (the allocator fragments after the
            # class factorizations), so an upload that runs out of memory
            # is not fatal: that plan stays host-streamed and pinning
            # continues with the smaller ones.
            resident = 0
            for sp, _, _ in sorted(
                    self._mega, key=lambda m: m[0].stats.weight_bytes,
                    reverse=True):
                wb = sp.stats.weight_bytes
                if resident + wb <= mega_resident_bytes:
                    try:
                        sp.pin_params()
                        resident += wb
                        continue
                    except jax.errors.JaxRuntimeError as e:
                        if "RESOURCE_EXHAUSTED" not in str(e):
                            raise
                        log_info("partition: pin failed (%s); streaming "
                                 "this and shrinking the budget",
                                 str(e).splitlines()[0][:60])
                        mega_resident_bytes = resident + wb // 2
                self.mega_streamed_bytes += wb
            if self.mega_streamed_bytes:
                log_info("partition: mega weights %.0f MB resident, "
                         "%.0f MB streamed per apply (budget %.1f GB)",
                         resident / 1e6, self.mega_streamed_bytes / 1e6,
                         mega_resident_bytes / 1e9)

        self.params = {
            "p1": self._cells1.params if self._cells1 is not None else None,
            "p2": self._cells2.params,
        }
        n2 = self.n2
        has_mega = bool(self._mega)
        cp1, cp2 = self._cells1, self._cells2

        def tiled_with(params, x):
            r = x.shape[1]
            r_pad = cp2.round_r(r)
            if r_pad != r:
                x = jnp.pad(x, ((0, 0), (0, r_pad - r)))
            xp = cp2.pad_rows(0, x)
            if cp1 is not None:
                t = cp1.apply_padded(params["p1"], [xp], r_pad)
                t = t[:cp2.buf_rows_pad[1]]
            else:
                t = jnp.zeros((cp2.buf_rows_pad[1], r_pad), jnp.float32)
            y = cp2.apply_padded(params["p2"], [xp, t], r_pad)
            return y[:n2, :r]

        def apply_with(params, x):
            """x: (n2, r) interleaved real, TREE index order. Covers the
            tiled cells only — plans with oversized blocks must go through
            apply()/apply_device, which composes their sub-plans."""
            check(not has_mega,
                  "this plan has oversized blocks; use apply()/"
                  "apply_device(), not the jittable apply_with")
            return tiled_with(params, x)

        self.apply_with = apply_with
        self._apply_jit = jax.jit(tiled_with)
        self._gather = jax.jit(
            lambda x, idx: jnp.take(x, idx, axis=0))
        self._scatter_add = jax.jit(
            lambda y, idx, v: y.at[idx].add(v.astype(y.dtype)))

    # -- conveniences ----------------------------------------------------

    def apply_device(self, x):
        """Full apply as device arrays: the tiled-cell jit plus each
        oversized block's own stage plan (composed at the Python level —
        dispatches pipeline; only the final consumer synchronizes).

        Dispatch is THROTTLED: PJRT allocates every enqueued computation's
        output buffers immediately, so dispatching all mega sub-applies at
        once allocates every gather copy + stage buffer up front. A
        block_until_ready every ~1 GB of estimated in-flight buffers bounds
        the peak at a few sync round trips per apply."""
        import jax
        import jax.numpy as jnp

        x = jnp.asarray(x)
        y = self._apply_jit(self.params, x)
        inflight = 0
        for sp, in_idx, out_idx in self._mega:
            ys = sp._apply_jit(sp._params, self._gather(x, in_idx))
            y = self._scatter_add(y, out_idx, ys)
            inflight += 6 * in_idx.size * x.shape[1] * 4
            if sp._params_on_host:
                # streamed weights + index tables transfer per call
                inflight += 2 * sp.stats.weight_bytes
            if inflight > (1 << 30):
                y = jax.block_until_ready(y)
                inflight = 0
        return y

    def apply(self, x):
        return self.apply_device(x)

    def unpin_megas(self):
        """Demote every pinned oversized-block sub-plan back to host
        streaming — the recovery path when the APPLY's transient buffers
        OOM next to the pinned weights (callers catch RESOURCE_EXHAUSTED
        from the first apply and retry after this)."""
        for sp, _, _ in self._mega:
            if not sp._params_on_host:
                self.mega_streamed_bytes += sp.stats.weight_bytes
            sp.unpin_params()

    def apply_complex(self, Z):
        """Complex (n, r) in, complex (n, r) out (host convenience)."""
        import numpy as _np

        Z = _np.asarray(Z)
        x = _np.empty((2 * Z.shape[0], Z.shape[1]), _np.float32)
        x[0::2], x[1::2] = Z.real, Z.imag
        y = _np.asarray(self.apply(x), dtype=_np.float64)
        return y[0::2] + 1j * y[1::2]

    def flops_per_col(self) -> int:
        """Executed (padded) flops per RHS column of the device program."""
        return self._flops

    def nbytes(self) -> int:
        return self._nbytes


def partition_apply_plan(op: LinOp, rank=None, **kw) -> PartitionPlan:
    """Compile a multilevel partition operator (e.g. fac/helm2.py
    make_multilevel output) into its batched device apply."""
    return PartitionPlan(op, rank=rank, **kw)
