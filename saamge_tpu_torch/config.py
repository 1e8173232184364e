"""Typed runtime configuration.

Consolidates the reference's three config tiers (compile-time macros in
``config.hpp:92-94``, macro-generated CONFIG singletons in
``config_mgr.hpp:68-245`` with the GLOBAL instance at ``config.hpp:45-72`` and
the TG instance at ``tg.hpp:99-119``, and per-driver CLI options) into plain
dataclasses.  A module-level ``CONFIG`` instance plays the role of the global
singletons; solvers take explicit parameter objects wherever possible.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional


@dataclasses.dataclass
class GlobalConfig:
    """Equivalent of the reference GLOBAL config class (config.hpp:45-72)."""

    # Comparison tolerance for real numbers (config.hpp: diff_eps).
    diff_eps: float = 1e-12
    # Output verbosity 0-15 (config.hpp: output_level). Level semantics follow
    # the reference's SA_PRINTF_L ladder.
    output_level: int = 1
    # Debug/assert level 0-15 (config.hpp:92 SA_DEBUG_LEVEL, default 5).
    debug_level: int = 5
    # Enable wall-clock phase timers (config.hpp:94 SA_TIMERS).
    timers: bool = True
    # Where log output goes.
    stream = sys.stdout


@dataclasses.dataclass
class TGConfig:
    """Equivalent of the reference TG config class (tg.hpp:99-119).

    The reference stores pre/post smoother function pointers (defaults set in
    tg.cpp:48-57 to the symmetric polynomial smoother).  Here smoothers are
    named; the solve module maps names to implementations.
    """

    pre_smoother: str = "sym_poly"
    post_smoother: str = "sym_poly"
    # Which polynomial root family relaxation uses (smpr.cpp:359-397 defaults
    # to SAS, degree 3*nu+1).
    smoother_poly_family: str = "sas"
    # Reference defaults from the drivers (mltest.cpp:347,338,332).
    theta: float = 0.003
    nu_relax: int = 3
    nu_pro: int = 0


@dataclasses.dataclass
class SolverOptions:
    """Per-run knobs shared by drivers (mirrors mltest.cpp:315-421 surface)."""

    # theta and nu_relax accept a scalar or a per-coarsening list (the
    # reference's per-level MultilevelParameters arrays, ml.cpp:54-108)
    theta: object = 0.003
    first_theta: Optional[float] = None
    nu_pro: int = 0
    first_nu_pro: Optional[int] = None
    nu_relax: object = 3
    num_levels: int = 2
    elems_per_agg: int = 256
    first_elems_per_agg: Optional[int] = None
    minimal_coarse: bool = False
    linear_coarse: bool = False
    correct_nulspace: bool = True
    double_cycle: bool = False
    coarse_direct: bool = False
    direct_eigensolver: bool = True
    # run the per-AE setup eigensolves as batched device kernels
    device_setup: bool = False
    do_aggregates: bool = False
    zero_rhs: bool = False
    rtol: float = 1e-6
    maxiter: int = 1000
    # relaxation root family: sas (reference default, smpr.cpp:376), sa,
    # oneminusx, or invx (two mixed chains; param = spectral a in (0,1));
    # None = TG_CONFIG.smoother_poly_family
    smoother_poly_family: Optional[str] = None
    smoother_poly_param: float = 0.0

    def resolved(self) -> "SolverOptions":
        out = dataclasses.replace(self)
        if out.first_theta is None:
            t = out.theta
            out.first_theta = float(t[0]) if isinstance(
                t, (list, tuple)) else t
        if out.first_nu_pro is None:
            out.first_nu_pro = out.nu_pro
        if out.first_elems_per_agg is None:
            out.first_elems_per_agg = out.elems_per_agg
        if out.smoother_poly_family is None:
            out.smoother_poly_family = TG_CONFIG.smoother_poly_family
        return out


CONFIG = GlobalConfig()
TG_CONFIG = TGConfig()
