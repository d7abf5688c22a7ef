"""REAL streamed factorization at scale: 16384 x 4096 stream -> distill ->
per-level einsum apply, with the f32 accuracy clause checked against dense.

The same pipeline as bench.py section D at 16x the operator area; it is a
standalone script because the host-side streaming and distillation take
minutes at this size.

Reference workload analogue: the frequency-domain butterfly compression of
LBO eigenvector matrices (src/lbo.c:70-150; examples/lbo/bf_lbo.c:343-348).

Usage:  python examples/real_fac_scale.py --out real_fac.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--r", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.fac.uniformize import uniformize_fused
    from butterfly_tpu.trees import uniform_tree
    from butterfly_tpu.utils.cache import enable_persistent_compile_cache
    from butterfly_tpu.utils.profiling import time_call

    enable_persistent_compile_cache()

    nD, mD, r = args.n, args.m, args.r
    xg = (np.arange(nD) + 0.5) / nD
    Phi = (np.cos(np.pi * np.outer(xg, np.arange(mD)))
           * np.sqrt(2.0 / nD))
    rec = {"n": nD, "m": mD}

    t0 = time.perf_counter()
    spec = FacSpec(
        row_tree=uniform_tree(nD, 2, 7),
        col_tree=uniform_tree(mD, 2, 3),
        row_tree_init_depth=2, tol=1e-7,
        min_num_rows=8, min_num_cols=8,
    )
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fac = streamer.get_fac()
    rec["stream_s"] = round(time.perf_counter() - t0, 1)
    log(f"stream: {rec['stream_s']} s")

    t0 = time.perf_counter()
    fp = uniformize_fused(fac, tol=1e-7, dtype=np.float32)
    rec["distill_s"] = round(time.perf_counter() - t0, 1)
    rec["rank"] = fp.rank
    rec["weights_mb"] = round(fp.nbytes() / 1e6, 1)
    rec["dense_mb"] = round(nD * mD * 8 / 1e6, 1)
    rec["compression_ratio"] = round(fp.nbytes() / (nD * mD * 4), 3)
    log(f"distill: {rec['distill_s']} s, rank {fp.rank}, "
        f"{rec['weights_mb']} MB")

    # ---- apply throughput ----------------------------------------------
    xD = jax.block_until_ready(jax.random.normal(
        jax.random.key(1), (mD, r), jnp.float32))
    per = time_call(fp.apply_butterfly_order, xD)
    flops = fp.flops_per_col() * r
    rec["apply_ms"] = per * 1e3
    rec["apply_tflops"] = flops / per / 1e12
    log(f"apply r={r}: {rec['apply_ms']} ms -> {rec['apply_tflops']} TFLOP/s")

    # ---- accuracy vs dense ----------------------------------------------
    xs = np.random.default_rng(0).standard_normal((mD, 4)).astype(np.float32)
    got = np.asarray(fp.apply(xs), dtype=np.float64)
    want = Phi @ xs.astype(np.float64)
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    rec["rel_err_vs_dense"] = float(f"{rel:.2e}")
    rec["device"] = str(jax.devices()[0])
    log(f"rel err vs dense: {rel:.2e}")

    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([rec], f, indent=1)


if __name__ == "__main__":
    main()
