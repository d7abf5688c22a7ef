"""Configuration dataclasses.

Replacement for the reference's per-algorithm config structs and compile-time
flags (reference: BfFacSpec include/bf/fac.h:6-29; meson flags BF_DEBUG /
BF_DOUBLE meson.build:12-25). Runtime dtype policy replaces the compile-time
BF_DOUBLE switch: float64 for host factorization math, configurable
float32/bfloat16 for the device apply path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class FacSpec:
    """Streaming-factorizer configuration (reference: BfFacSpec,
    include/bf/fac.h:6-29).

    Attributes:
      row_tree / col_tree: the row (index) tree and column (e.g. frequency)
        tree driving the factorization.
      row_tree_init_depth: depth of the initial row cut when feeding a new
        column-tree leaf (reference: rowTreeInitDepth).
      tol: relative truncation tolerance for the blockwise SVDs.
      min_num_rows / min_num_cols: blocks thinner than this pass through
        uncompressed (reference: minNumRows/minNumCols).
      compare_relative_errors: if True, after every merge check the merged
        factorization against the stored dense block with a random matvec
        (reference: compareRelativeErrors, src/fac_streamer.c:286-301).
    """

    row_tree: Any
    col_tree: Any
    row_tree_init_depth: int = 1
    tol: float = 1e-15
    min_num_rows: int = 20
    min_num_cols: int = 20
    compare_relative_errors: bool = False


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Device apply-path configuration.

    dtype: dtype for packed factors on device. float32 keeps rel-err vs dense
      near 1e-7 per level; float64 (requires jax_enable_x64) matches the
      reference's BF_DOUBLE accuracy at a fraction of the matmul rate.
    block_pad: pad block dims up to a multiple of this (small problems use
      smaller pads to avoid pathological padding waste).
    """

    dtype: Any = np.float32
    block_pad: int = 128
