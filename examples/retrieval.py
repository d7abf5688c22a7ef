"""Butterfly-compressed embedding retrieval on the device.

The flagship workload (BASELINE configs[1,2]): compress an embedding
table, score query batches against it on the device, take top-k there, and
report recall@100 vs exact dense scoring plus throughput.

Two formats (see butterfly_tpu/models/retrieval.py for the measured scope):
- one-level `CompressedTable` (tall tables; default): rows are PCA
  tree-ordered, then per-block truncated SVD at uniform rank.
- `--deep`: the streamed multilevel butterfly (`DeepTable`) on a wide
  structured table (the LBO-eigenvector analogue), scored through the
  fac->device bridge; reports its storage vs the one-level format at the
  same accuracy.

Usage:
  python examples/retrieval.py --n 1048576 --d 128 --rank 32   # configs[1]
  python examples/retrieval.py --deep --n 8192                 # wide/deep
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_tall_table(n: int, d: int, rng) -> np.ndarray:
    """Clustered + smooth-latent + popularity-skewed rows (ANN-benchmark
    style)."""
    z = np.sort(rng.random(n))
    comps = np.stack([np.cos(2 * np.pi * (j + 1) * z + rng.random() * 6)
                      for j in range(16)])
    table = comps.T @ rng.standard_normal((16, d))
    table += 0.001 * rng.standard_normal((n, d))
    table *= (1.0 + rng.pareto(2.0, n)).clip(None, 50.0)[:, None]
    return table


def run_one_level(args, rng) -> None:
    import jax
    import jax.numpy as jnp

    from butterfly_tpu.models.retrieval import (
        compress_table, exact_topk, recall_at_k, recall_with_tolerance,
        tree_order_rows,
    )

    n, d = args.n, args.d
    table = make_tall_table(n, d, rng)
    t0 = time.time()
    perm = tree_order_rows(table)
    table = table[perm]
    print(f"tree-ordered rows [{time.time()-t0:.1f}s]")

    t0 = time.time()
    ct = compress_table(table, rank=args.rank, block_rows=128,
                        svd_dtype=np.float32 if n > 262144 else np.float64)
    print(f"compressed {n}x{d} table: "
          f"{table.astype(np.float32).nbytes/1e6:.0f} MB -> "
          f"{ct.nbytes()/1e6:.1f} MB "
          f"(ratio {ct.nbytes()/table.astype(np.float32).nbytes:.3f}) "
          f"[{time.time()-t0:.1f}s]")

    q = rng.standard_normal((args.queries, d)).astype(np.float32)
    topk = jax.jit(lambda c, q: c.topk(q, 100))
    vals, idx = topk(ct, jnp.asarray(q))
    jax.block_until_ready(vals)
    t0 = time.time()
    vals, idx = topk(ct, jnp.asarray(q))
    jax.block_until_ready(vals)
    dt = time.time() - t0
    print(f"scoring+top-100 for {args.queries} queries: {dt*1e3:.1f} ms "
          f"({args.queries/dt:.0f} queries/s)")

    true_scores = q @ table.T
    strict = recall_at_k(np.asarray(idx), exact_topk(table, q, 100))
    tolr = recall_with_tolerance(np.asarray(idx), true_scores, 100, tol=1e-3)
    print(f"recall@100: strict {strict:.4f}, tolerance {tolr:.4f}")
    return {
        "format": "one_level", "n": n, "d": d, "rank": args.rank,
        "compression_ratio": round(
            ct.nbytes() / table.astype(np.float32).nbytes, 4),
        "queries_per_s": round(args.queries / dt),
        "recall_at_100_strict": round(float(strict), 4),
        "recall_at_100_tol1e3": round(float(tolr), 4),
        "device": str(jax.devices()[0]),
    }


def run_deep(args, rng) -> None:
    import jax

    from butterfly_tpu.models.retrieval import (
        compress_table_deep, exact_topk, recall_at_k,
    )

    n = args.n
    x = (np.arange(n) + 0.5) / n
    table = np.cos(np.pi * np.outer(x, np.arange(n))) * np.sqrt(2.0 / n)
    print(f"wide structured table {n}x{n} "
          f"({table.astype(np.float32).nbytes/1e6:.0f} MB dense f32)")

    t0 = time.time()
    dt_table = compress_table_deep(table, tol=args.tol,
                                   col_depth=max(2, int(np.log2(n)) - 7))
    print(f"deep (streamed butterfly): logical "
          f"{dt_table.nbytes_logical()/1e6:.1f} MB, device "
          f"{dt_table.nbytes()/1e6:.1f} MB "
          f"(numW={dt_table.fac.num_w}) [{time.time()-t0:.1f}s]")

    # one-level storage at the same accuracy (uniform rank = max tol-rank)
    blocks = table.reshape(n // 128, 128, n)
    S = np.linalg.svd(blocks, compute_uv=False)
    r = int((S >= args.tol * S[:, :1]).sum(1).max())
    one_bytes = (n * r + (n // 128) * r * n) * 4
    print(f"one-level at same tol: rank {r} -> {one_bytes/1e6:.1f} MB; "
          f"deep/one-level ratio "
          f"{dt_table.nbytes()/one_bytes:.2f}")

    q = rng.standard_normal((args.queries, n)).astype(np.float32)
    vals, idx = dt_table.topk(q, 100)
    jax.block_until_ready(vals)
    t0 = time.time()
    vals, idx = dt_table.topk(q, 100)
    jax.block_until_ready(vals)
    dtm = time.time() - t0
    print(f"deep scoring+top-100 for {args.queries} queries: "
          f"{dtm*1e3:.1f} ms ({args.queries/dtm:.0f} queries/s)")
    rec = recall_at_k(np.asarray(idx), exact_topk(table, q, 100))
    print(f"deep recall@100: {rec:.4f}")
    return {
        "format": "deep_butterfly", "n": n, "tol": args.tol,
        "device_mb": round(dt_table.nbytes() / 1e6, 1),
        "one_level_mb_same_tol": round(one_bytes / 1e6, 1),
        "deep_over_one_level": round(dt_table.nbytes() / one_bytes, 3),
        "queries_per_s": round(args.queries / dtm),
        "recall_at_100_strict": round(float(rec), 4),
        "device": str(jax.devices()[0]),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--deep", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--json", type=str, default=None,
                    help="append the run's metrics to this JSON file")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    if args.deep:
        if args.n > 65536:
            args.n = 8192  # wide table is n x n; keep the dense oracle sane
        rec = run_deep(args, rng)
    else:
        rec = run_one_level(args, rng)
    if args.json:
        records = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                records = json.load(f)
        records.append(rec)
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
