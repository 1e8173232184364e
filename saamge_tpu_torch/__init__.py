"""saamge_tpu_torch: the PyTorch/CUDA port of saamge_tpu's structured
flagship solve (3-level brick V-cycle preconditioning PCG), with
hand-written Hopper (sm_90a) kernels for its stencil, smoother sweep,
tent R/P and mid-level chain.

The JAX package ``saamge_tpu`` stays the reference; this package imports
only its host-only (numpy/scipy) setup modules and never JAX."""

from saamge_tpu_torch._device import pin_fp32_precision
from saamge_tpu_torch.api import flagship_problem
from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                               StructuredHierarchy,
                                               compile_structured,
                                               struct_pcg_solve,
                                               struct_vcycle_apply)

pin_fp32_precision()

__all__ = ["BrickGeometry", "StructuredHierarchy", "compile_structured",
           "flagship_problem", "pin_fp32_precision", "struct_pcg_solve",
           "struct_vcycle_apply"]
