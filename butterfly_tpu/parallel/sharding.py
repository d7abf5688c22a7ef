"""Multi-chip sharding of butterfly factors and retrieval scoring.

The reference is single-threaded with zero distribution (SURVEY.md §0, §2.10);
this module is the new design it calls for: a `jax.sharding.Mesh` with axes

    ("data", "model")

- data  (DP): query/batch axis of scoring and training.
- model (TP/SP): the leaf-block axis of butterfly factors and the row axis of
  activations/scores.

Butterfly tensor parallelism: level l of a UniformButterfly has weights
(hi, R, R, lo, m, k) with hi = NB/R^(l+1), lo = R^l. We shard axis 0 (hi)
while hi divides the model-axis size, else axis 3 (lo) — one of the two is
always shardable for NB >= R * n_model. Every level's GEMMs are then LOCAL;
what moves between chips is the re-blocking of activations between levels —
GSPMD lowers that resharding to all-to-all/collective-permute over the interconnect,
which is exactly the "per-level exchange of leaf-block activations" design
in SURVEY.md §2.10. No hand-written communication.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from butterfly_tpu.ops.butterfly import UniformButterfly
from butterfly_tpu.models.retrieval import CompressedTable
from butterfly_tpu.utils.errors import InvalidArgumentsError, check

__all__ = [
    "make_mesh",
    "shard_butterfly",
    "shard_table",
    "data_sharding",
    "replicated",
]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None) -> Mesh:
    """Build a ("data", "model") mesh over the first n_devices devices.

    Default factorization: model gets the largest power of two <= sqrt(n),
    data gets the rest — both axes >1 whenever n >= 4.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    check(n_devices <= len(devs), "not enough devices", InvalidArgumentsError)
    if data is None or model is None:
        model = 1
        while model * 2 * model * 2 <= n_devices:
            model *= 2
        while n_devices % model:
            model //= 2
        data = n_devices // model
    check(data * model == n_devices, "data*model must equal n_devices",
          InvalidArgumentsError)
    arr = np.array(devs[:n_devices]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, axis: int = 0) -> NamedSharding:
    """Shard a batch tensor's `axis` over the data axis."""
    spec = [None] * (axis + 1)
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def _level_spec(shape: tuple, n_model: int) -> P:
    """PartitionSpec for one butterfly level (hi, R, R, lo, m, k)."""
    hi, _, _, lo = shape[0], shape[1], shape[2], shape[3]
    if hi % n_model == 0 and hi >= n_model:
        return P("model", None, None, None, None, None)
    if lo % n_model == 0 and lo >= n_model:
        return P(None, None, None, "model", None, None)
    return P()  # replicate tiny levels


def shard_butterfly(bf: UniformButterfly, mesh: Mesh) -> UniformButterfly:
    """Place butterfly factors with per-level tensor-parallel shardings."""
    n_model = mesh.shape["model"]
    leaf = bf.leaf
    if leaf is not None:
        spec = P("model", None, None) if leaf.shape[0] % n_model == 0 else P()
        leaf = jax.device_put(leaf, NamedSharding(mesh, spec))
    levels = [
        jax.device_put(W, NamedSharding(mesh, _level_spec(W.shape, n_model)))
        for W in bf.levels
    ]
    return UniformButterfly(leaf, levels, bf.radix)


def shard_table(ct: CompressedTable, mesh: Mesh) -> CompressedTable:
    """Shard the compressed table's block axis over the model axis."""
    n_model = mesh.shape["model"]
    spec = (
        P("model", None, None) if ct.Psi.shape[0] % n_model == 0 else P()
    )
    sh = NamedSharding(mesh, spec)
    return CompressedTable(jax.device_put(ct.Psi, sh), jax.device_put(ct.V, sh))
