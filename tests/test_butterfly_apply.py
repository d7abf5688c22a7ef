"""UniformButterfly's per-level einsum apply against a float64 NumPy
level-by-level oracle (the same reference chip_smoke.py uses at full size),
across the cases the apply has to cover."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from butterfly_tpu.ops.butterfly import (
    UniformButterfly,
    random_butterfly,
    reference_apply,
)


def _np_apply(bf, X):
    return reference_apply(bf, X)


def _case(name):
    key = jax.random.key(1)
    if name == "leaf":
        return random_butterfly(16, 8, key=key), 16, 1e-5
    if name == "no_leaf":
        return random_butterfly(16, 8, key=key, with_leaf=False), 16, 1e-5
    if name == "partial_depth":
        return random_butterfly(64, 8, num_levels=5, key=key), 8, 1e-5
    if name == "bf16_weights":
        # each level rounds its input to bf16 (~3 digits)
        return random_butterfly(16, 8, dtype=jnp.bfloat16, key=key), 4, 2e-2
    if name == "bf16_activations":
        b = random_butterfly(16, 8, dtype=jnp.bfloat16, key=key)
        return (UniformButterfly(b.leaf, b.levels, 2,
                                 act_dtype=jnp.bfloat16), 4, 2e-2)
    if name == "complex_weights":
        b = random_butterfly(16, 8, key=key)
        b2 = random_butterfly(16, 8, key=jax.random.key(2))
        leaf = (b.leaf + 1j * b2.leaf).astype(jnp.complex64)
        lv = [(W + 1j * V).astype(jnp.complex64)
              for W, V in zip(b.levels, b2.levels)]
        return UniformButterfly(leaf, lv, 2, precision="highest"), 4, 1e-5
    raise ValueError(name)


@pytest.mark.parametrize("name", ["leaf", "no_leaf", "partial_depth",
                                  "bf16_weights", "bf16_activations",
                                  "complex_weights"])
def test_einsum_apply_matches_f64_oracle(name):
    bf, r, tol = _case(name)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((bf.shape[1], r))
    if np.issubdtype(bf.levels[0].dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(x.shape)
        xd = jnp.asarray(x, jnp.complex64)
    else:
        xd = jnp.asarray(x, jnp.float32)
    got = np.asarray(jax.jit(UniformButterfly.apply)(bf, xd))
    want = _np_apply(bf, np.asarray(xd))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert got.shape == want.shape
    assert rel < tol, f"{name}: rel {rel:.2e}"


def test_einsum_apply_vector_input():
    bf = random_butterfly(16, 8, key=jax.random.key(3), with_leaf=False)
    x = jax.random.normal(jax.random.key(4), (bf.shape[1],), jnp.float32)
    got = np.asarray(bf.apply(x))
    want = _np_apply(bf, np.asarray(x, np.float64)[:, None])[:, 0]
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_act_dtype_survives_pytree_and_astype():
    b = random_butterfly(8, 8, dtype=jnp.bfloat16, key=jax.random.key(5))
    bf = UniformButterfly(b.leaf, b.levels, 2, act_dtype=jnp.bfloat16)
    leaves, tree = jax.tree_util.tree_flatten(bf)
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert back.act_dtype == jnp.bfloat16
    assert bf.astype(jnp.float32).act_dtype == jnp.bfloat16
    x = jnp.ones((bf.shape[1], 4), jnp.bfloat16)
    assert jax.jit(UniformButterfly.apply)(bf, x).dtype == jnp.bfloat16


@pytest.mark.gpu
def test_f32_highest_chain_on_gpu(gpu):
    """On the card, an f32 chain at HIGHEST precision holds the device-f32
    budget against the f64 oracle (TF32 would not)."""
    b = random_butterfly(256, 128, key=jax.random.key(6))
    bf = UniformButterfly(b.leaf, b.levels, 2, precision="highest")
    x = jax.random.normal(jax.random.key(7), (bf.shape[1], 16), jnp.float32)
    got = np.asarray(jax.jit(UniformButterfly.apply)(bf, x), np.float64)
    want = _np_apply(bf, np.asarray(x, np.float64))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
