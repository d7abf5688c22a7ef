"""Smoke test of the library's main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: the phases below, in order
    python chip_smoke.py --multi   # four cards: the sharded butterfly only

One card, one process:
  1. device: JAX must report a GPU (no CPU fallback); prints the card's name
     and power limit as nvidia-smi reports them;
  2. butterfly chains at bench.py's section B shape (NB=1024 blocks of 128,
     10 levels, r=2048, bf16 weights and activations) and section A shape
     (f32, r=256, HIGHEST), each checked against a float64 NumPy
     level-by-level apply of the same weights on 8 sampled columns;
  3. a real streamed factorization (4096 x 1024 cosine basis, tol 1e-7)
     distilled to FFT form and applied on the device, against Phi @ x;
  4. the Helmholtz combined-field solve at n=16384 (64 points per
     wavelength): factorization, partition plan, device apply, 128-row
     dense oracle, GMRES to 3e-7;
  5. the tests marked `gpu`, in this process.

With --multi: a random NB=1024, blk=128 butterfly sharded over a 4-wide
"model" axis (parallel/shmap_butterfly.py), against the single-card apply
of the same weights.

Any failed gate exits non-zero. The last line of stdout is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BF16_TOL = 1e-2   # bf16 activations: ~3 digits per level over 10 levels
F32_TOL = 1e-5    # device f32 at HIGHEST precision
FAC_TOL = 1e-6    # the BASELINE accuracy clause
HELM_TOL = 1e-6
GMRES_TOL = 3e-7
MULTI_TOL = 2e-5  # sharded vs single-card apply, both at HIGHEST


def log(*a):
    print(*a, flush=True)


class GateError(RuntimeError):
    pass


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_device(jax):
    dev = jax.devices()[0]
    gate(dev.platform == "gpu",
         f"JAX reports platform {dev.platform!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
        f"devices {len(jax.devices())}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    return dev


def phase_chains(jax, jnp, nb: int = 1024):
    from butterfly_tpu.ops.butterfly import (
        UniformButterfly,
        random_butterfly,
        reference_apply,
    )
    from butterfly_tpu.utils.profiling import time_call

    apply = jax.jit(UniformButterfly.apply)
    rng = np.random.default_rng(0)
    b = random_butterfly(nb, 128, dtype=jnp.bfloat16, key=jax.random.key(7))
    for name, bf, r, dt, tol in (
        ("B bf16", UniformButterfly(b.leaf, b.levels, b.radix,
                                    act_dtype=jnp.bfloat16),
         2048, jnp.bfloat16, BF16_TOL),
        ("A f32-highest", UniformButterfly(
            b.leaf.astype(jnp.float32),
            [W.astype(jnp.float32) for W in b.levels], b.radix,
            precision="highest"), 256, jnp.float32, F32_TOL),
    ):
        x = jax.random.normal(jax.random.key(1), (bf.shape[1], r),
                              jnp.float32).astype(dt)
        t = time_call(apply, bf, x, reps=5)
        y = apply(bf, x)
        cols = np.sort(rng.choice(r, 8, replace=False))
        want = reference_apply(bf, np.asarray(x[:, cols], np.float64))
        err = rel_err(np.asarray(y[:, cols].astype(jnp.float32)), want)
        tflops = bf.flops_per_col() * r / t / 1e12
        log(f"chain {name}: n={bf.shape[1]} r={r} levels={bf.num_levels} "
            f"{t * 1e3:.3f} ms ({tflops:.1f} TFLOP/s), rel err vs f64 "
            f"{err:.3e} (gate {tol:g})")
        gate(np.isfinite(err) and err <= tol,
             f"chain {name} rel err {err:.3e} > {tol:g}")


def phase_streamed_fac(jax, jnp):
    from butterfly_tpu.config import FacSpec
    from butterfly_tpu.fac.streamer import FacStreamer
    from butterfly_tpu.fac.uniformize import uniformize_fused
    from butterfly_tpu.trees import uniform_tree
    from butterfly_tpu.utils.profiling import time_call

    n, m = 4096, 1024
    xg = (np.arange(n) + 0.5) / n
    Phi = np.cos(np.pi * np.outer(xg, np.arange(m))) * np.sqrt(2.0 / n)
    spec = FacSpec(row_tree=uniform_tree(n, 2, 6),
                   col_tree=uniform_tree(m, 2, 3),
                   row_tree_init_depth=2, tol=1e-7,
                   min_num_rows=8, min_num_cols=8)
    t0 = time.perf_counter()
    streamer = FacStreamer(spec)
    for leaf in spec.col_tree.nodes_at_depth(3):
        if leaf.num_points:
            streamer.feed(Phi[:, leaf.i0:leaf.i1])
    fp = uniformize_fused(streamer.get_fac(), tol=1e-7, dtype=np.float32)
    setup = time.perf_counter() - t0
    xs = np.random.default_rng(0).standard_normal((m, 4)).astype(np.float32)
    err = rel_err(fp.apply(jnp.asarray(xs)), Phi @ xs.astype(np.float64))
    xw = jax.random.normal(jax.random.key(2), (m, 1024), jnp.float32)
    t = time_call(fp.apply_butterfly_order, xw, reps=5)
    log(f"streamed fac: set-up {setup:.2f} s, rank {fp.rank}, "
        f"{fp.nbytes() / 1e6:.2f} MB, apply r=1024 {t * 1e3:.3f} ms, "
        f"rel err vs Phi@x {err:.3e} (gate {FAC_TOL:g})")
    gate(np.isfinite(err) and err <= FAC_TOL,
         f"streamed fac rel err {err:.3e} > {FAC_TOL:g}")


def phase_helmholtz(n: int = 16384):
    from examples.helm2_scale import run_one

    rec = run_one(n, ppw=64.0, leaf=64, queries=64)
    log("helmholtz: " + json.dumps(rec))
    log(f"helmholtz n={n}: fac set-up {rec['setup_fac_s']:.2f} s, plan "
        f"build {rec['setup_plan_s']:.2f} s (host chains, device low-rank "
        f"factorization), "
        f"apply r=64 {rec['apply_ms']:.3f} ms, GMRES "
        f"{rec['gmres_iters']} iters in {rec['gmres_s']:.3f} s, weights "
        f"{rec['weight_bytes']} B, peak {rec['peak_bytes_in_use']} B")
    gate(rec["rel_err_vs_dense"] <= HELM_TOL,
         f"helmholtz rel err {rec['rel_err_vs_dense']:.3e} > {HELM_TOL:g}")
    gate(rec["gmres_converged"] and rec["gmres_rel_res"] <= GMRES_TOL,
         f"GMRES not converged (rel res {rec['gmres_rel_res']:.3e})")


def phase_gpu_tests():
    import pytest

    os.environ["BUTTERFLY_TEST_PLATFORM"] = ""  # keep the GPU backend
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(here, "tests")])
    gate(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


def phase_multi(jax, jnp, nb: int = 1024):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from butterfly_tpu.ops.butterfly import UniformButterfly, random_butterfly
    from butterfly_tpu.parallel.shmap_butterfly import ShardedButterfly
    from butterfly_tpu.utils.profiling import time_call

    devs = jax.devices()
    gate(len(devs) == 4, f"--multi needs 4 GPUs, JAX reports {len(devs)}")
    b = random_butterfly(nb, 128, dtype=jnp.float32, key=jax.random.key(3))
    bf = UniformButterfly(b.leaf, b.levels, b.radix, precision="highest")
    r = 256
    x = jax.random.normal(jax.random.key(4), (bf.shape[1], r), jnp.float32)
    single = jax.jit(UniformButterfly.apply)
    t1 = time_call(single, bf, x, reps=5)
    want = np.asarray(single(bf, x), np.float64)

    mesh = Mesh(np.array(devs), ("model",))
    sb = ShardedButterfly(bf, mesh, axis="model")
    xs = jax.device_put(x, NamedSharding(mesh, P("model", None)))
    t4 = time_call(sb.apply, xs, reps=5)
    got = sb.unpermute_rows(sb.apply(xs))
    err = rel_err(got, want)
    log(f"multi: NB={bf.NB} blk=128 r={r} on {len(devs)} cards "
        f"(exchanged={sb.exchanged}, {sb.expected_exchange_elems(r)} elems "
        f"all-to-all): sharded {t4 * 1e3:.3f} ms, single card "
        f"{t1 * 1e3:.3f} ms, rel vs single card {err:.3e} "
        f"(gate {MULTI_TOL:g})")
    gate(sb.exchanged, "the sharded apply did not exchange")
    gate(np.isfinite(err) and err <= MULTI_TOL,
         f"sharded rel err {err:.3e} > {MULTI_TOL:g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded butterfly on four cards")
    args = ap.parse_args()
    try:
        from butterfly_tpu.utils.cache import enable_persistent_compile_cache
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    cache = enable_persistent_compile_cache()

    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    try:
        dev = phase_device(jax)
        log(f"compile cache: {cache}")
        if args.multi:
            phase_multi(jax, jnp)
        else:
            for name, fn in (("chains", lambda: phase_chains(jax, jnp)),
                             ("streamed fac",
                              lambda: phase_streamed_fac(jax, jnp)),
                             ("helmholtz", phase_helmholtz),
                             ("gpu tests", phase_gpu_tests)):
                ts = time.perf_counter()
                fn()
                log(f"phase {name}: {time.perf_counter() - ts:.1f} s")
    except GateError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 2
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
