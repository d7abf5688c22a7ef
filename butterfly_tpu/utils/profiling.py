"""Per-kernel roofline accounting and profiler hooks.

Replacement (and upgrade) for the reference's wall-clock-only instrumentation
(bfToc sprinkled through examples, src/timer.c): every hot operator exposes
flops/bytes, and `roofline_report` turns a measured apply time into
achieved-vs-speed-of-light fractions against measured chip ceilings — the
"kernels profiled against speed-of-light per chip" requirement of the
BASELINE north star. `device_trace` wraps jax.profiler tracing.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = ["OpCost", "op_cost", "roofline_report", "device_trace",
           "DevicePeaks", "device_peaks", "time_call"]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published dense peak rates of one device."""

    bf16_tflops: float
    tf32_tflops: float
    f32_tflops: float  # outside the tensor cores
    hbm_gbps: float
    source: str


_H100_SXM = DevicePeaks(
    bf16_tflops=989.0, tf32_tflops=495.0, f32_tflops=67.0, hbm_gbps=3350.0,
    source="NVIDIA H100 SXM data sheet, dense (no sparsity), 700 W")

# keyed by jax's Device.device_kind
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
    "NVIDIA H100 SXM5 80GB": _H100_SXM,
}


def device_peaks(device_kind: str) -> DevicePeaks:
    """The published peaks of `device_kind`; an unknown device is an error,
    not a default."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def time_call(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Median seconds of `fn(*args)`, each call ended by block_until_ready
    (JAX returns before the device finishes). Warm-up calls compile."""
    import time

    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class OpCost:
    flops_per_col: int  # useful multiply-add flops (x2) per RHS column
    weight_bytes: int  # parameter bytes streamed per apply
    io_bytes_per_col: int  # input+output bytes per RHS column


def op_cost(op, dtype_bytes: int = 4) -> OpCost:
    """Cost model for UniformButterfly, StagePlan, CompressedTable, LinOp."""
    from butterfly_tpu.models.retrieval import CompressedTable
    from butterfly_tpu.ops.butterfly import UniformButterfly
    from butterfly_tpu.ops.linop import LinOp
    from butterfly_tpu.ops.packed import StagePlan

    if isinstance(op, UniformButterfly):
        m, n = op.shape
        return OpCost(op.flops_per_col(), op.nbytes(), (m + n) * dtype_bytes)
    if isinstance(op, StagePlan):
        m, n = op.shape
        return OpCost(
            op.stats.useful_flops_per_col, op.stats.weight_bytes,
            (m + n) * dtype_bytes,
        )
    if isinstance(op, CompressedTable):
        NB, s, r = op.Psi.shape
        d = op.dim
        fl = 2 * NB * (s * r + r * d)
        return OpCost(fl, op.nbytes(), (op.num_rows + d) * dtype_bytes)
    if isinstance(op, LinOp):
        m, n = op.shape
        # conservative: count stored bytes as streamed, dense-equivalent flops
        return OpCost(2 * m * n, op.nbytes(), (m + n) * dtype_bytes)
    raise TypeError(f"no cost model for {type(op).__name__}")


def roofline_report(
    op,
    num_cols: int,
    measured_seconds: float,
    peak_tflops: float,
    hbm_gbps: float,
    dtype_bytes: int = 4,
) -> dict:
    """Achieved throughput vs the op's per-device speed of light.

    Speed-of-light time = max(compute-limit, minimum-traffic-limit) where the
    minimum traffic reads every weight byte once and the input/output once.
    """
    c = op_cost(op, dtype_bytes)
    flops = c.flops_per_col * num_cols
    bytes_min = c.weight_bytes + c.io_bytes_per_col * num_cols
    t_compute = flops / (peak_tflops * 1e12)
    t_bw = bytes_min / (hbm_gbps * 1e9)
    t_sol = max(t_compute, t_bw)
    return {
        "useful_tflops": flops / measured_seconds / 1e12,
        "achieved_frac_sol": t_sol / measured_seconds,
        "bound": "compute" if t_compute >= t_bw else "bandwidth",
        "t_compute_limit_ms": t_compute * 1e3,
        "t_bandwidth_limit_ms": t_bw * 1e3,
        "measured_ms": measured_seconds * 1e3,
        "arithmetic_intensity": flops / max(bytes_min, 1),
    }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context; no-op if the backend can't trace."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
