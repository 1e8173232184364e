"""Visualization output (GLVis-socket analog).

The reference streams meshes/partitionings/aggregates/solutions to a GLVis
socket (fem.cpp:156-430).  A TPU pod has no GLVis; we write legacy-VTK
files viewable in ParaView/VisIt instead, plus the same convenience
entry points: partitioning color field, per-DoF aggregate/MIS ids, and
nodal solutions.  Also mesh/gridfunction text I/O (fem_read/write_mesh|gf,
fem.cpp:433-476 analog) via numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from saamge_tpu_torch.fem.mesh import Mesh

_VTK_CELL = {"quad": 9, "tri": 5, "hex": 12, "tet": 10}


def write_vtk(path: str, mesh: Mesh,
              point_data: Optional[Dict[str, np.ndarray]] = None,
              cell_data: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write mesh + fields as legacy VTK (ASCII)."""
    pts = mesh.vertices
    if pts.shape[1] == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    cells = mesh.elements
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nsaamge_tpu\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(pts)} double\n")
        np.savetxt(f, pts, fmt="%.10g")
        nv = cells.shape[1]
        f.write(f"CELLS {len(cells)} {len(cells) * (nv + 1)}\n")
        block = np.hstack([np.full((len(cells), 1), nv), cells])
        np.savetxt(f, block, fmt="%d")
        f.write(f"CELL_TYPES {len(cells)}\n")
        np.savetxt(f, np.full(len(cells), _VTK_CELL[mesh.elem_type]),
                   fmt="%d")
        if cell_data:
            f.write(f"CELL_DATA {len(cells)}\n")
            for name, arr in cell_data.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, np.asarray(arr, dtype=np.float64), fmt="%.10g")
        if point_data:
            f.write(f"POINT_DATA {len(pts)}\n")
            for name, arr in point_data.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, np.asarray(arr, dtype=np.float64), fmt="%.10g")


def save_partitioning(path: str, mesh: Mesh,
                      partitioning: np.ndarray) -> None:
    """fem_parallel_visualize_partitioning analog: element color field."""
    write_vtk(path, mesh, cell_data={"partition": partitioning})


def save_aggregates(path: str, mesh: Mesh, rels, order: int = 1) -> None:
    """fem_parallel_visualize_aggregates analog: per-DoF AE / MIS ids
    (vertex dofs only for order 1)."""
    nd = mesh.num_dofs(order)
    ae_id = np.full(nd, -1.0)
    for ae in range(rels.nparts):
        ae_id[rels.AE_to_dof.row(ae)] = ae
    mis_id = np.full(nd, -1.0)
    if rels.mis_to_dof is not None:
        for m in range(rels.num_mises):
            mis_id[rels.mis_to_dof.row(m)] = m
    nverts = len(mesh.vertices)
    write_vtk(path, mesh, point_data={"AE": ae_id[:nverts],
                                      "MIS": mis_id[:nverts]},
              cell_data={"partition": rels.partitioning})


def save_solution(path: str, mesh: Mesh, x: np.ndarray,
                  name: str = "solution") -> None:
    """fem_parallel_visualize_gf analog (vertex dofs)."""
    nverts = len(mesh.vertices)
    write_vtk(path, mesh, point_data={name: x[:nverts]})


def write_gridfunction(path: str, x: np.ndarray) -> None:
    """fem_write_gf analog."""
    np.savetxt(path, x, header=f"saamge_tpu gridfunction {len(x)}")


def read_gridfunction(path: str) -> np.ndarray:
    return np.loadtxt(path)
