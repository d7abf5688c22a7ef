"""Benchmark: butterfly-compressed operator applies on one NVIDIA GPU.

    python bench.py

Prints one line per measurement on stderr and, as the last line of stdout,
one JSON object with every section's numbers, the device (platform, kind,
count), the card's name and power limit as nvidia-smi reports them, and
the published peaks the rates are compared with (utils/profiling.py
PEAKS, keyed by device_kind; an unknown device is an error). A device that
is not a GPU is an error too: nothing here falls back to the CPU.

Every time is the median of several calls that each end in
block_until_ready, after warm-up calls that compile. A failed section fails
the run.

Sections:
  R  reference rates of this card: a large bf16 matmul and a device copy
  B  bf16 deep chain: NB=1024 blocks of 128, 10 levels, r=2048, bf16
     weights and activations (reference hot path analogue: the product
     apply of src/fac.c:133-146 on a depth-10 butterfly)
  C  bf16 compute-bound chain: NB=64, r=2048
  A  f32 deep chain at HIGHEST precision, r=256
  D  REAL streamed factorization (fac/streamer.py) distilled to FFT form
     (fac/distill.py) and applied at r=1024, with its rel err vs Phi @ x
  E  multilevel Helmholtz operator (fac/helm2.py) through the partition
     apply at r=1024, rel err vs the complex host oracle
B, A and D also time each level's einsum alone, with its FLOP/s and
bytes/s against the peaks.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def level_costs(bf, r: int, act_bytes: int):
    """(name, flops, bytes) of each level of `bf` at width r: weights read
    once, activations read and written once."""
    out = []
    if bf.leaf is not None:
        NB, m, k = bf.leaf.shape
        out.append(("leaf", 2 * NB * m * k * r,
                    bf.leaf.nbytes + NB * (m + k) * r * act_bytes))
    for l, W in enumerate(bf.levels):
        hi, R, _, lo, m, k = W.shape
        out.append((f"level{l}", 2 * hi * R * R * lo * m * k * r,
                    W.nbytes + hi * R * lo * (m + k) * r * act_bytes))
    return out


def time_levels(jax, jnp, bf, x, peaks, res: dict, tag: str):
    """Time each factor's einsum of `bf` alone on its real input shape
    (weights passed as arguments, as in the chain)."""
    from butterfly_tpu.ops.butterfly import apply_factor as _factor
    from butterfly_tpu.utils.profiling import time_call

    r = x.shape[1]
    act = bf.act_dtype or jnp.float32
    costs = level_costs(bf, r, jnp.dtype(act).itemsize)
    factors = ([] if bf.leaf is None else [bf.leaf]) + list(bf.levels)
    fn = jax.jit(functools.partial(_factor, radix=bf.radix,
                                   precision=bf.precision, act_dtype=act))
    cur = x
    rows = []
    for (name, flops, nbytes), W in zip(costs, factors):
        t = time_call(fn, W, cur, reps=5)
        cur = fn(W, cur)
        rows.append({"factor": name, "ms": t * 1e3,
                     "tflops": flops / t / 1e12,
                     "gbps": nbytes / t / 1e9,
                     "frac_hbm_peak": nbytes / t / 1e9 / peaks.hbm_gbps})
        log(f"{tag} {name}: {t * 1e3:.3f} ms, {flops / t / 1e12:.1f} TFLOP/s,"
            f" {nbytes / t / 1e9:.0f} GB/s "
            f"({nbytes / t / 1e9 / peaks.hbm_gbps:.2f} of HBM peak)")
    res[tag + "_levels"] = rows


def main() -> None:
    from butterfly_tpu.utils.cache import enable_persistent_compile_cache

    cache = enable_persistent_compile_cache()

    import jax
    import jax.numpy as jnp

    from butterfly_tpu.ops.butterfly import UniformButterfly, random_butterfly
    from butterfly_tpu.utils.profiling import device_peaks, time_call

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX reports {dev.platform}")
    peaks = device_peaks(dev.device_kind)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log(f"device: {dev.device_kind} ({smi}); compile cache {cache}")
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "nvidia_smi": smi, "peaks": peaks.__dict__}
    apply = jax.jit(UniformButterfly.apply)

    def chain(tag, bf, x, peak_tflops):
        r = x.shape[1]
        t = time_call(apply, bf, x, reps=5)
        flops = bf.flops_per_col() * r
        act = jnp.dtype(bf.act_dtype or jnp.float32).itemsize
        # every level reads its weights and its input and writes its output
        nbytes = sum(b for _, _, b in level_costs(bf, r, act))
        res[tag] = {"ms": t * 1e3, "tflops": flops / t / 1e12,
                    "frac_matmul_peak": flops / t / 1e12 / peak_tflops,
                    "gbps": nbytes / t / 1e9,
                    "frac_hbm_peak": nbytes / t / 1e9 / peaks.hbm_gbps}
        log(f"{tag}: n={bf.shape[1]} r={r} {t * 1e3:.3f} ms, "
            f"{flops / t / 1e12:.1f} TFLOP/s, {nbytes / t / 1e9:.0f} GB/s")

    # ---- R: reference rates of this card --------------------------------
    M = 8192
    a = jax.random.normal(jax.random.key(0), (M, M), jnp.bfloat16)
    mm = jax.jit(lambda a: jnp.dot(a, a, preferred_element_type=jnp.float32))
    t = time_call(mm, a)
    big = jax.random.normal(jax.random.key(1), (1 << 28,), jnp.float32)
    cp = jax.jit(lambda v: v * 2.0)
    tc = time_call(cp, big)
    res["R"] = {"bf16_matmul_tflops": 2 * M ** 3 / t / 1e12,
                "copy_gbps": 2 * big.nbytes / tc / 1e9}
    log(f"R: bf16 matmul {res['R']['bf16_matmul_tflops']:.1f} TFLOP/s, "
        f"copy {res['R']['copy_gbps']:.0f} GB/s")
    del a, big

    # ---- B / C / A: butterfly chains -------------------------------------
    b16 = random_butterfly(1024, 128, dtype=jnp.bfloat16,
                           key=jax.random.key(7))
    bfB = UniformButterfly(b16.leaf, b16.levels, 2, act_dtype=jnp.bfloat16)
    xB = jax.random.normal(jax.random.key(2), (bfB.shape[1], 2048),
                           jnp.float32).astype(jnp.bfloat16)
    chain("B", bfB, xB, peaks.bf16_tflops)
    time_levels(jax, jnp, bfB, xB, peaks, res, "B")
    del xB

    c16 = random_butterfly(64, 128, dtype=jnp.bfloat16,
                           key=jax.random.key(11))
    bfC = UniformButterfly(c16.leaf, c16.levels, 2, act_dtype=jnp.bfloat16)
    xC = jax.random.normal(jax.random.key(3), (bfC.shape[1], 2048),
                           jnp.float32).astype(jnp.bfloat16)
    chain("C", bfC, xC, peaks.bf16_tflops)

    bfA = UniformButterfly(b16.leaf.astype(jnp.float32),
                           [W.astype(jnp.float32) for W in b16.levels], 2,
                           precision="highest")
    xA = jax.random.normal(jax.random.key(4), (bfA.shape[1], 256),
                           jnp.float32)
    chain("A", bfA, xA, peaks.f32_tflops)
    time_levels(jax, jnp, bfA, xA, peaks, res, "A")

    # ---- D: real streamed factorization ---------------------------------
    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.fac.uniformize import uniformize_fused
    from butterfly_tpu.trees import uniform_tree

    nD, mD = 4096, 1024
    xg = (np.arange(nD) + 0.5) / nD
    Phi = np.cos(np.pi * np.outer(xg, np.arange(mD))) * np.sqrt(2.0 / nD)
    spec = FacSpec(row_tree=uniform_tree(nD, 2, 6),
                   col_tree=uniform_tree(mD, 2, 3),
                   row_tree_init_depth=2, tol=1e-7,
                   min_num_rows=8, min_num_cols=8)
    ts = time.perf_counter()
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fp = uniformize_fused(streamer.get_fac(), tol=1e-7, dtype=np.float32)
    setup_D = time.perf_counter() - ts
    xD = jax.random.normal(jax.random.key(5), (mD, 1024), jnp.float32)
    chain("D", fp.bf, xD, peaks.f32_tflops)
    time_levels(jax, jnp, fp.bf, xD, peaks, res, "D")
    xs = np.random.default_rng(0).standard_normal((mD, 4)).astype(np.float32)
    got = np.asarray(fp.apply(jnp.asarray(xs)), np.float64)
    want = Phi @ xs.astype(np.float64)
    res["D"].update(setup_s=setup_D, rank=fp.rank,
                    rel_err=float(np.linalg.norm(got - want)
                                  / np.linalg.norm(want)))
    log(f"D: set-up {setup_D:.2f} s, rel err {res['D']['rel_err']:.3e}")

    # ---- E: multilevel Helmholtz partition apply ------------------------
    from butterfly_tpu.fac import helm2 as fac_helm2
    from butterfly_tpu.fac.partition import partition_apply_plan
    from butterfly_tpu.geom import Ellipse
    from butterfly_tpu.ops.helm2 import Helm2, LayerPot
    from butterfly_tpu.trees import Quadtree

    nE = 4096
    ts = time.perf_counter()
    X, _, Nrm, _ = Ellipse(1.0, 0.7, (0.0, 0.0), 0.3).sample_linspaced(nE)
    tree = Quadtree(X, leaf_size=32, normals=Nrm)
    A = fac_helm2.make_multilevel(Helm2(k=60.0, layer_pot=LayerPot.SINGLE),
                                  tree, tree)
    pp = partition_apply_plan(A)
    setup_E = time.perf_counter() - ts
    xE = jax.random.normal(jax.random.key(6), (2 * nE, 1024), jnp.float32)
    t = time_call(pp.apply_device, xE, reps=5)
    rng = np.random.default_rng(0)
    zs = rng.standard_normal((nE, 2)) + 1j * rng.standard_normal((nE, 2))
    want = A.matmat(zs)
    relE = float(np.linalg.norm(pp.apply_complex(zs) - want)
                 / np.linalg.norm(want))
    res["E"] = {"ms": t * 1e3,
                "tflops": pp.flops_per_col() * 1024 / t / 1e12,
                "gbps": (pp.nbytes() + 2 * xE.nbytes) / t / 1e9,
                "setup_s": setup_E, "rel_err": relE}
    log(f"E: {t * 1e3:.3f} ms, set-up {setup_E:.2f} s, rel err {relE:.3e}")

    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
