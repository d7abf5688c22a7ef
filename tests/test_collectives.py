"""The per-level butterfly exchange is REAL: HLO-inspection tests.

SURVEY.md §2.10's design — "per-level all-to-all of leaf-block activations
over the interconnect" — is verified here, not hoped-for: the explicit shard_map schedule
must compile to exactly the predicted all-to-all volume, and the GSPMD path
must emit collectives for the inter-level resharding."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from butterfly_tpu.ops.butterfly import random_butterfly
from butterfly_tpu.parallel.shmap_butterfly import ShardedButterfly


def _mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("model",))


def _hlo_all_to_all_shapes(txt: str) -> list[tuple[int, ...]]:
    """Result shapes of all-to-all op DEFINITIONS in compiled HLO text
    (tuple-shaped variants contribute one shape per element)."""
    shapes = []
    for line in txt.splitlines():
        if "all-to-all(" not in line or "=" not in line:
            continue
        result_ty = line.split("=", 1)[1].split("all-to-all(", 1)[0]
        for m in re.finditer(r"[a-z0-9]+\[([0-9,]*)\]", result_ty):
            dims = m.group(1)
            shapes.append(tuple(int(d) for d in dims.split(",") if d))
    return shapes


@pytest.mark.slow
def test_shmap_butterfly_matches_dense():
    mesh = _mesh8()
    NB, blk, r = 64, 16, 8
    bf = random_butterfly(NB, blk, dtype=jnp.float32, key=jax.random.key(0))
    sb = ShardedButterfly(bf, mesh, axis="model")
    x = jax.random.normal(jax.random.key(1), (NB * blk, r), jnp.float32)
    y = np.asarray(sb.unpermute_rows(sb.apply(x)))
    want = np.asarray(bf.apply(x))
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert rel < 2e-6, f"shmap butterfly rel err {rel:.2e}"
    assert sb.exchanged


@pytest.mark.parametrize("D,leaf", [(4, True), (8, False)])
def test_shmap_butterfly_matches_single_device(D, leaf):
    """The explicit-exchange apply on a D-wide model axis matches the
    single-device apply of the same weights (chip_smoke.py --multi runs
    this comparison on four cards at full width)."""
    mesh = Mesh(np.array(jax.devices()[:D]), ("model",))
    NB, blk, r = 64, 8, 4
    bf = random_butterfly(NB, blk, dtype=jnp.float32, key=jax.random.key(2),
                          with_leaf=leaf)
    sb = ShardedButterfly(bf, mesh, axis="model")
    x = jax.random.normal(jax.random.key(3), (NB * blk, r), jnp.float32)
    y = np.asarray(sb.unpermute_rows(sb.apply(x)))
    want = np.asarray(bf.apply(x))
    rel = np.linalg.norm(y - want) / np.linalg.norm(want)
    assert sb.exchanged
    assert rel < 2e-6, f"sharded vs single-device rel err {rel:.2e}"


def test_shmap_hlo_exact_exchange_volume():
    """The compiled HLO contains the ONE all-to-all, and its operand is
    exactly one pass of the activation tensor — the minimum exchange any
    butterfly schedule can do."""
    mesh = _mesh8()
    NB, blk, r = 64, 16, 8
    bf = random_butterfly(NB, blk, dtype=jnp.float32, key=jax.random.key(0))
    sb = ShardedButterfly(bf, mesh, axis="model")
    x = jax.random.normal(jax.random.key(1), (NB * blk, r), jnp.float32)
    txt = sb._apply.lower(x, sb.leaf, sb.w1, sb.w2).compile().as_text()
    shapes = _hlo_all_to_all_shapes(txt)
    assert shapes, "no all-to-all in compiled HLO"
    # per-device operand: (NB/D, blk, r); HLO may split it into several
    # same-total ops or report start/done pairs — total unique-op volume per
    # "pass" must equal the local activation tensor
    D = 8
    local_elems = (NB // D) * blk * r
    vols = [int(np.prod(s)) for s in shapes]
    assert max(vols) <= local_elems
    assert sum(vols) % local_elems == 0, (vols, local_elems)
    # and the exchange happens exactly once (allowing start/done double
    # counting): at most 2 local-tensor passes appear in the text
    assert sum(vols) <= 2 * local_elems, (vols, local_elems)


def test_gspmd_butterfly_emits_collectives():
    """The GSPMD path (parallel/sharding.py) really lowers the inter-level
    re-blocking to collectives."""
    from butterfly_tpu.parallel.sharding import make_mesh, shard_butterfly

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, data=1, model=8)
    NB, blk, r = 64, 16, 8
    bf = random_butterfly(NB, blk, dtype=jnp.float32, key=jax.random.key(0))
    with mesh:
        bfs = shard_butterfly(bf, mesh)
        x = jax.device_put(
            jax.random.normal(jax.random.key(1), (NB * blk, r), jnp.float32),
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("model")),
        )
        txt = jax.jit(lambda b, v: b.apply(v)).lower(bfs, x).compile().as_text()
    assert re.search(r"all-to-all|collective-permute|all-gather|all-reduce",
                     txt), "GSPMD emitted no collectives for the sharded apply"
