"""Device-mesh parallelism: sharding layouts and the batched pipeline.

Distribution (SURVEY.md §2 parallelism table):
  dp    — ciphertext-batch data parallel (independent proximity checks)
  limb  — RNS-limb tensor parallel (NTT/pointwise ops are limb-independent)
  coeff — polynomial-coefficient sequence parallel (cross-device NTT stages)
"""

from .mesh import make_mesh, ct_spec, ct_sharding
from .pipeline import build_batched_pipeline, make_batch_inputs

__all__ = [
    "make_mesh",
    "ct_spec",
    "ct_sharding",
    "build_batched_pipeline",
    "make_batch_inputs",
]
