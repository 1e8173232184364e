"""saamge_tpu_torch: the PyTorch/CUDA port of saamge_tpu.

Device paths: the structured flagship solve (3-level brick V-cycle
preconditioning PCG, solve/structured.py) with its full-capacity and
box-contraction configurations, and the general (unstructured) solve
(solve/compiled.py), with hand-written Hopper (sm_90a) kernels for the
stencil, smoother sweeps, tent R/P, mid-level chain, matrix-free pass,
packed mid matvec and box contractions.

The host setup (fem/, topology/, setup/, the host solve/ modules,
utils/, native/) is the port's own copy of the JAX package's host-only
modules; its device setup (``device_setup=True``: setup/device_setup.py,
ops/filtered_eig.py, ops/batched_eig.py) solves the local eigenproblems
batched on the card, or on the CPU when asked.  The JAX package
``saamge_tpu`` stays the reference; this package imports nothing of it
and nothing of JAX."""

from saamge_tpu_torch._device import pin_fp32_precision
from saamge_tpu_torch.api import (SpectralAMGSolver, entry, flagship_problem,
                                  general_problem)
from saamge_tpu_torch.solve.compiled import (CompiledHierarchy,
                                             compile_hierarchy,
                                             compile_two_level, pcg_solve,
                                             vcycle_apply)
from saamge_tpu_torch.solve.structured import (BrickGeometry,
                                               StructuredHierarchy,
                                               compile_structured,
                                               struct_pcg_solve,
                                               struct_vcycle_apply)

pin_fp32_precision()

__all__ = ["BrickGeometry", "CompiledHierarchy", "SpectralAMGSolver",
           "StructuredHierarchy", "compile_hierarchy", "compile_structured",
           "compile_two_level", "entry", "flagship_problem",
           "general_problem", "pcg_solve", "pin_fp32_precision",
           "struct_pcg_solve", "struct_vcycle_apply", "vcycle_apply"]
