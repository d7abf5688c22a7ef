"""butterfly_tpu — a structured-matrix / butterfly-factorization
framework with the capabilities of the reference C library sampotter/butterfly
(see SURVEY.md), redesigned for JAX/XLA/Pallas:

- `butterfly_tpu.ops`      structured-operator algebra (host oracle layer) and
                           the packed device runtime (batched block GEMMs)
- `butterfly_tpu.trees`    host-side spatial trees (quadtree/octree/interval/
                           Fiedler) exported as flat device tables
- `butterfly_tpu.geom`     points, bboxes, circles, ellipses, trimeshes, FEM
- `butterfly_tpu.fac`      butterfly factorizers: analytic 2D Helmholtz and
                           streaming algebraic (truncated-SVD merge-and-split)
- `butterfly_tpu.models`   applications: compressed-embedding retrieval,
                           Helmholtz BIE solve, covariance, LBO spectra
- `butterfly_tpu.parallel` mesh/sharding: multi-device butterfly apply with
                           per-level collectives
"""

__version__ = "0.1.0"

from butterfly_tpu.config import DeviceConfig, FacSpec

__all__ = ["DeviceConfig", "FacSpec", "__version__"]
