"""Problem-plugin coefficients.

Equivalents of the reference's plug-in coefficient machinery:
  - anisotropic diffusion tensor b (x) b^T + eps I from a direction field
    (AnisotropicDiffusionIntegrator.cpp:126-149, eps = 0.001);
  - SPE10-style inverse-permeability raster loader
    (InversePermeabilityFunction.{hpp,cpp}): 3*Nx*Ny*Nz values on a
    cell-centered Cartesian raster with spacings (hx, hy, hz), evaluated by
    nearest-cell lookup; optional 2D slices; the diffusion coefficient is
    the (diagonal) permeability 1/ip per component.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["anisotropic_tensor", "InversePermeability"]


def anisotropic_tensor(direction, eps: float = 0.001) -> Callable:
    """Returns x -> b(x) b(x)^T + eps I (the AnisotropicDiffusionIntegrator
    tensor).  ``direction`` is a constant vector or a callable x -> vector."""
    if callable(direction):
        def coef(x):
            b = np.asarray(direction(x), dtype=np.float64)
            return np.outer(b, b) + eps * np.eye(len(b))
        return coef
    b0 = np.asarray(direction, dtype=np.float64)
    T0 = np.outer(b0, b0) + eps * np.eye(len(b0))

    def coef(x):
        return T0
    return coef


class InversePermeability:
    """SPE10 permeability raster (InversePermeabilityFunction analog).

    The classic SPE10 file stores Nx*Ny*Nz cell values for each of the
    three components, x fastest (ReadPermeabilityFile,
    InversePermeabilityFunction.cpp:86-120).  SPE10 dimensions:
    Nx, Ny, Nz = 60, 220, 85 with h = (20ft, 10ft, 2ft)."""

    def __init__(self, Nx: int = 60, Ny: int = 220, Nz: int = 85,
                 hx: float = 20.0, hy: float = 10.0, hz: float = 2.0):
        self.N = (Nx, Ny, Nz)
        self.h = (hx, hy, hz)
        self.ip: Optional[np.ndarray] = None    # (3, Nz, Ny, Nx)
        self.slice_axis: Optional[int] = None
        self.slice_pos: int = 0

    def set_constant(self, ipx: float, ipy: float, ipz: float) -> None:
        Nx, Ny, Nz = self.N
        self.ip = np.empty((3, Nz, Ny, Nx))
        for c, v in enumerate((ipx, ipy, ipz)):
            self.ip[c] = v

    def read_file(self, path: str) -> None:
        Nx, Ny, Nz = self.N
        vals = np.fromfile(path, sep=" ")
        need = 3 * Nx * Ny * Nz
        assert len(vals) >= need, f"{path}: {len(vals)} < {need} values"
        self.ip = vals[:need].reshape(3, Nz, Ny, Nx)

    def set_2d_slice(self, axis: str, pos: int) -> None:
        """Restrict to a 2D slice: axis in 'xy' (fixed z), 'xz', 'yz'."""
        self.slice_axis = {"xy": 2, "xz": 1, "yz": 0}[axis]
        self.slice_pos = pos

    def _cell(self, x: np.ndarray):
        Nx, Ny, Nz = self.N
        hx, hy, hz = self.h
        if self.slice_axis is None:
            i = min(int(x[0] / hx), Nx - 1)
            j = min(int(x[1] / hy), Ny - 1)
            k = min(int(x[2] / hz), Nz - 1) if len(x) > 2 else 0
        else:
            coords = [0, 0, 0]
            free = [d for d in range(3) if d != self.slice_axis]
            for t, d in enumerate(free):
                coords[d] = min(int(x[t] / self.h[d]), self.N[d] - 1)
            coords[self.slice_axis] = self.slice_pos
            i, j, k = coords
        return i, j, k

    def inverse_permeability(self, x: np.ndarray) -> np.ndarray:
        i, j, k = self._cell(x)
        return self.ip[:, k, j, i]

    def permeability_tensor(self, x: np.ndarray) -> np.ndarray:
        """Diagonal permeability 1/ip — the diffusion matrix coefficient."""
        ipv = self.inverse_permeability(x)
        d = 2 if self.slice_axis is not None else (3 if len(x) > 2 else 2)
        if d == 2:
            free = [t for t in range(3) if t != (self.slice_axis
                                                 if self.slice_axis
                                                 is not None else 2)]
            return np.diag(1.0 / ipv[free])
        return np.diag(1.0 / ipv)

    def coefficient(self) -> Callable:
        assert self.ip is not None, "load or set permeability first"
        return self.permeability_tensor
