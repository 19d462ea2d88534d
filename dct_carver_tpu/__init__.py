"""dct_carver_tpu — a seam-carving (content-aware retargeting) framework
with the capabilities of avivrosenberg/dct-carver, rebuilt from scratch on
JAX for NVIDIA GPUs (the package name records that it was first written for
TPUs).

Layer map (mirrors SURVEY.md §1):
  platform  — the one place that picks each stage's implementation
  ops/      — DCT energy + DP seam ops (pure JAX semantics anchor)
  pallas/   — the GPU seam-DP kernel (Pallas through Triton)
  models/   — the Carver lifecycle object + retargeting pipelines
  parallel/ — mesh/batch sharding and spatially-sharded single-image carving
  utils/    — config, image helpers, checkpointing, metrics
  oracle/   — NumPy executable spec (test ground truth)
"""

__version__ = "0.1.0"

from .utils.config import CarverConfig  # noqa: F401
from .ops.energy import energy_map, to_luma, normalize_to_u8  # noqa: F401
