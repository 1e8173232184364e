"""Minimal unstructured-mesh front end (host side).

Provides what the reference obtained from MFEM meshes (fem.cpp:56-77,433-476,
mltest.cpp:441-506): structured quad/hex generators, MFEM v1.0 and NETGEN
neutral readers, uniform refinement, element adjacency (dual graph),
element->vertex connectivity, and boundary-attribute vertex lookup.

Supported element types: quad (Q1 geometry), hex, triangle, tet.  All elements
of a mesh share one type, which keeps element arrays rectangular — that is the
TPU-friendly invariant: every per-element quantity is a fixed-shape batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from saamge_tpu_torch.utils.tables import Table

# vertices per element / faces per element type
_GEOM = {
    "tri": dict(nv=3, dim=2,
                faces=[(0, 1), (1, 2), (2, 0)]),
    "quad": dict(nv=4, dim=2,
                 faces=[(0, 1), (1, 2), (2, 3), (3, 0)]),
    "tet": dict(nv=4, dim=3,
                faces=[(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]),
    "hex": dict(nv=8, dim=3,
                faces=[(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
                       (3, 7, 6, 2), (0, 4, 7, 3), (1, 2, 6, 5)]),
}


@dataclasses.dataclass
class Mesh:
    dim: int
    vertices: np.ndarray       # (NV, dim) float64
    elements: np.ndarray       # (NE, nv) int64
    elem_type: str             # 'tri' | 'quad' | 'tet' | 'hex'
    elem_attr: np.ndarray      # (NE,) int64
    boundary: np.ndarray       # (NB, nbv) int64 vertex lists of bdr faces
    bdr_attr: np.ndarray       # (NB,) int64
    # all elements congruent up to translation (structured generators set
    # this): assembly can integrate ONE element and broadcast
    uniform: bool = False
    # element-grid shape (nx, ny[, nz]) for lexicographic Cartesian
    # generators (set by hex_mesh; quad_mesh's vertex layout is j-major
    # and does not set it): enables the slab-add stencil assembly
    # (assemble.assemble_global_stencil_grid) and O(1) centers
    grid: tuple = None

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_elements(self) -> int:
        return self.elements.shape[0]

    # ------------------------------------------------------------------
    def elem_centers(self) -> np.ndarray:
        cached = getattr(self, "_elem_centers_cache", None)
        if cached is None:
            if self.grid is not None and self.dim == len(self.grid):
                # rectilinear grid: center = midpoint of the main
                # diagonal — strided slices, no (NE, nv, d) gather
                V = self.vertices.reshape(
                    tuple(g + 1 for g in self.grid) + (self.dim,))
                if self.dim == 3:
                    cached = 0.5 * (V[:-1, :-1, :-1] + V[1:, 1:, 1:])
                else:
                    cached = 0.5 * (V[:-1, :-1] + V[1:, 1:])
                cached = cached.reshape(-1, self.dim)
            else:
                cached = self.vertices[self.elements].mean(axis=1)
            object.__setattr__(self, "_elem_centers_cache", cached)
        return cached

    def elem_to_dof(self, order: int = 1, vdim: int = 1) -> Table:
        """H1 element->dof connectivity.

        order 1: dofs = vertices in element-local order (matches MFEM H1 order
        1 where GetElementDofs returns the element's vertices).
        order 2 (quad only): vertices, then edge dofs, then interior dof,
        matching MFEM's H1 quadratic local ordering.
        """
        if order == 1:
            e2d = self.elements
        elif order == 2 and self.elem_type == "quad":
            e2d = self._q2_elem_to_dof()[0]
        else:
            e2d = self._nodal_elem_to_dof(order)[0]
        if vdim == 1:
            return Table.from_rows(np.asarray(e2d), self.num_dofs(order))
        # Vector-valued flattening, byVDIM global numbering with
        # component-major local order (fem.cpp:478 vector_valued_elem_to_dof);
        # e2d is rectangular here, so one vectorized concat suffices
        e2d = np.asarray(e2d)
        rows = np.concatenate([e2d * vdim + vd for vd in range(vdim)],
                              axis=1)
        return Table.from_rows(rows, self.num_dofs(order) * vdim)

    def num_dofs(self, order: int = 1) -> int:
        if order == 1:
            return self.num_vertices
        if order == 2 and self.elem_type == "quad":
            return self._q2_elem_to_dof()[1]
        return self._nodal_elem_to_dof(order)[1]

    def dof_coords(self, order: int = 1) -> np.ndarray:
        """Coordinates of H1 dofs (used by polynomial coarse spaces)."""
        if order == 1:
            return self.vertices
        if order == 2 and self.elem_type == "quad":
            e2d, nd, coords = self._q2_elem_to_dof(with_coords=True)
            return coords
        return self._nodal_elem_to_dof(order)[2]

    # -- general-order nodal numbering -----------------------------------
    def _nodal_quant_tol(self) -> float:
        # minimum over ALL element edges, not just v0-v1: on an
        # anisotropic mesh the v0-v1 edge can be the LONG direction and
        # a tolerance derived from it would merge distinct lattice nodes
        # along the short direction (advisor-class finding)
        edges = {
            "tri": [(0, 1), (1, 2), (2, 0)],
            "quad": [(0, 1), (1, 2), (2, 3), (3, 0)],
            "tet": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
            "hex": [(0, 1), (1, 2), (2, 3), (3, 0),
                    (4, 5), (5, 6), (6, 7), (7, 4),
                    (0, 4), (1, 5), (2, 6), (3, 7)],
        }[self.elem_type]
        v = self.vertices
        E = self.elements
        h = np.inf
        for a, b in edges:
            d = np.linalg.norm(v[E[:, b]] - v[E[:, a]], axis=1)
            if (d > 0).any():
                h = min(h, float(d[d > 0].min()))
        return h / 16.0

    def _nodal_elem_to_dof(self, order: int):
        """Arbitrary-order H1 connectivity by COORDINATE deduplication:
        every element generates its nodal lattice through the (bi/tri)
        linear geometry map, and physically-coincident nodes become one
        global dof.  This sidesteps all edge/face orientation bookkeeping
        (the part MFEM's H1_FECollection spends most of its code on,
        fem.hpp:427-484) and gives shape functions a trivially consistent
        local ordering (the lattice order)."""
        cache = getattr(self, "_nodal_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_nodal_cache", cache)
        if order in cache:
            return cache[order]
        from saamge_tpu_torch.fem.assemble import nodal_lattice, geom_shape
        ref = nodal_lattice(self.elem_type, order)      # (nloc, d)
        N, _ = geom_shape(self.elem_type, ref)          # (nloc, nverts)
        # physical nodes: (NE, nloc, d)
        phys = np.einsum("lv,evd->eld", N, self.vertices[self.elements])
        tol = self._nodal_quant_tol() / max(order, 2)
        q = phys / tol
        keys = np.round(q).astype(np.int64)
        flat = keys.reshape(-1, keys.shape[-1])
        uniq, inv = np.unique(flat, axis=0, return_inverse=True)
        # Tolerance-robust merge: physically-coincident nodes computed
        # through different elements' geometry maps differ by roundoff and
        # can quantize to DIFFERENT keys when q lands within roundoff of a
        # half-integer.  Those borderline nodes are rare (|frac(q+1/2)|
        # below a loose 1e-6 bound on accumulated roundoff in tol units);
        # for them, probe the +/-1 neighbor key in each borderline
        # coordinate and union-find-merge cells whose representative
        # coordinates truly coincide (< tol/4 apart).
        qf = q.reshape(-1, q.shape[-1])
        border = np.abs(qf - flat) > 0.5 - 1e-6
        susp = np.flatnonzero(border.any(axis=1))
        if len(susp):
            key_of = {tuple(k): i for i, k in enumerate(uniq)}
            parent = np.arange(len(uniq))

            def find(i):
                while parent[i] != i:
                    parent[i] = parent[parent[i]]
                    i = parent[i]
                return i

            rep_pt = np.zeros((len(uniq), q.shape[-1]))
            rep_pt[inv] = qf                    # any member's coords
            for j in susp:
                base = flat[j]
                for d in np.flatnonzero(border[j]):
                    for s in (-1, 1):
                        nb = base.copy()
                        nb[d] += s
                        o = key_of.get(tuple(nb))
                        if o is None:
                            continue
                        if np.max(np.abs(rep_pt[o] - qf[j])) < 0.25:
                            a, bq = find(int(inv[j])), find(o)
                            if a != bq:
                                parent[max(a, bq)] = min(a, bq)
            roots = np.array([find(i) for i in range(len(uniq))])
            if not np.array_equal(roots, np.arange(len(uniq))):
                # compress merged cells into a dense unique numbering
                newu, inv2 = np.unique(roots, return_inverse=True)
                uniq = uniq[newu]
                inv = inv2[inv]
        # renumber in first-encounter order for determinism
        first = np.full(len(uniq), len(flat), dtype=np.int64)
        np.minimum.at(first, inv, np.arange(len(flat)))
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
        ids = rank[inv].reshape(keys.shape[:2])
        nd = len(uniq)
        coords = np.zeros((nd, self.dim))
        coords[ids.reshape(-1)] = phys.reshape(-1, self.dim)
        key_to_id = {tuple(k): int(rank[i])
                     for i, k in enumerate(uniq)}
        cache[order] = (ids, nd, coords, key_to_id, tol)
        return cache[order]

    def ess_nodal_dofs(self, ess_attr_marker: np.ndarray,
                       order: int) -> np.ndarray:
        """Boundary dofs of marked attributes for the general-order nodal
        numbering: boundary-face lattices are generated with the same
        geometry map and matched by quantized coordinates."""
        from saamge_tpu_torch.fem.assemble import nodal_lattice, geom_shape
        ids, nd, coords, key_to_id, tol = self._nodal_elem_to_dof(order)
        face_type = {"quad": "segment", "hex": "quad",
                     "tri": "segment", "tet": "tri"}[self.elem_type]
        ref = nodal_lattice(face_type, order)
        N, _ = geom_shape(face_type, ref)
        from itertools import product as _iproduct
        out = []
        for bverts, attr in zip(self.boundary, self.bdr_attr):
            if not ess_attr_marker[int(attr) - 1]:
                continue
            phys = N @ self.vertices[np.asarray(bverts)]
            q = phys / tol
            for qp, p in zip(q, np.round(q).astype(np.int64)):
                d = key_to_id.get(tuple(p))
                if d is None:
                    # quantization straddled a rounding boundary (face
                    # lattice computed through a different geometry map
                    # than the volume lattice): probe neighbor keys and
                    # accept a true coordinate match
                    for off in _iproduct((0, -1, 1), repeat=len(p)):
                        if not any(off):
                            continue
                        d2 = key_to_id.get(tuple(p + np.asarray(off)))
                        if d2 is not None and \
                                np.max(np.abs(coords[d2] / tol - qp)) < 0.25:
                            d = d2
                            break
                if d is None:
                    raise ValueError(
                        "essential-BC lattice node of a marked boundary "
                        f"face (attr {int(attr)}) at {qp * tol} matches no "
                        "volume dof — mesh boundary is inconsistent with "
                        "the element geometry maps")
                out.append(d)
        return np.unique(np.asarray(out, dtype=np.int64)) \
            if out else np.zeros(0, dtype=np.int64)

    def _q2_elem_to_dof(self, with_coords: bool = False):
        """Quadratic H1 dofs on quads: vertex dofs, one per unique edge, one
        per element interior.  Local order: 4 vertices, 4 edges (bottom,
        right, top, left), center — MFEM's H1_QuadrilateralElement order."""
        nv = self.num_vertices
        edges: Dict[Tuple[int, int], int] = {}
        rows = np.zeros((self.num_elements, 9), dtype=np.int64)
        edge_mid = []
        local_edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
        for e, verts in enumerate(self.elements):
            rows[e, :4] = verts
            for le, (a, b) in enumerate(local_edges):
                key = (min(verts[a], verts[b]), max(verts[a], verts[b]))
                if key not in edges:
                    edges[key] = nv + len(edges)
                    edge_mid.append(0.5 * (self.vertices[verts[a]]
                                           + self.vertices[verts[b]]))
                rows[e, 4 + le] = edges[key]
        ne_off = nv + len(edges)
        rows[:, 8] = ne_off + np.arange(self.num_elements)
        nd = ne_off + self.num_elements
        if with_coords:
            coords = np.concatenate(
                [self.vertices, np.asarray(edge_mid).reshape(-1, self.dim),
                 self.elem_centers()], axis=0)
            return rows, nd, coords
        return rows, nd

    def elem_to_elem(self) -> Table:
        """Dual graph: elements sharing a full face (mfem
        ElementToElementTable analog; no self loops).  Vectorized: all
        element faces are canonicalized by sorting their vertex tuples,
        then matching faces are found with one lexsort.

        Lexicographic Cartesian generators (``grid`` set) take a
        closed-form path instead: neighbors differ by the axis strides,
        no 6*NE-face sort — this was the dominant host-setup-tail item
        at 2.1M elements (14 s -> <0.5 s)."""
        cached = getattr(self, "_e2e_cache", None)
        if cached is not None:
            return cached
        if self.grid is not None and self.dim == len(self.grid):
            t = self._elem_to_elem_grid()
            object.__setattr__(self, "_e2e_cache", t)
            return t
        face_defs = np.asarray(_GEOM[self.elem_type]["faces"], dtype=np.int64)
        NE = self.num_elements
        nf, fv = face_defs.shape
        # (NE*nf, fv) vertex tuples, sorted within each face
        fverts = self.elements[:, face_defs].reshape(NE * nf, fv)
        fverts = np.sort(fverts, axis=1)
        owner = np.repeat(np.arange(NE, dtype=np.int64), nf)
        order = np.lexsort(fverts.T[::-1])
        fs = fverts[order]
        os_ = owner[order]
        same = np.all(fs[1:] == fs[:-1], axis=1)   # interior faces pair up
        a, b = os_[:-1][same], os_[1:][same]
        if len(a) == 0:
            t = Table.from_rows([[] for _ in range(NE)], NE)
            object.__setattr__(self, "_e2e_cache", t)
            return t
        pr = np.concatenate([np.stack([a, b], 1), np.stack([b, a], 1)])
        order = np.lexsort((pr[:, 1], pr[:, 0]))
        pr = pr[order]
        t = Table.from_pairs(pr[:, 0], pr[:, 1], NE, NE)
        object.__setattr__(self, "_e2e_cache", t)
        return t

    def _elem_to_elem_grid(self) -> Table:
        """Dual graph of a lexicographic element grid (element id
        ``(i*ny + j)*nz + k`` for grid (nx, ny, nz)): per-row neighbor
        ids in ascending order — identical Table to the generic
        face-matching path."""
        shape = tuple(int(g) for g in self.grid)
        NE = int(np.prod(shape))
        strides = np.ones(len(shape), dtype=np.int64)
        for a in range(len(shape) - 2, -1, -1):
            strides[a] = strides[a + 1] * shape[a + 1]
        e = np.arange(NE, dtype=np.int64)
        # ascending-offset column order: -s0 < -s1 < ... < +s1 < +s0
        axes = list(range(len(shape)))                    # s0 > s1 > ...
        ia = [(e // strides[a]) % shape[a] for a in axes]
        C = np.empty((NE, 2 * len(axes)), dtype=np.int64)
        M = np.empty((NE, 2 * len(axes)), dtype=bool)
        last = 2 * len(axes) - 1
        for a in axes:
            C[:, a] = e - strides[a]
            M[:, a] = ia[a] > 0
            C[:, last - a] = e + strides[a]
            M[:, last - a] = ia[a] < shape[a] - 1
        indptr = np.zeros(NE + 1, dtype=np.int64)
        np.cumsum(M.sum(axis=1, dtype=np.int64), out=indptr[1:])
        return Table(indptr, C[M], NE)

    def boundary_vertex_attrs(self) -> Dict[int, np.ndarray]:
        """attribute -> unique vertex ids on boundary faces of that attr."""
        out: Dict[int, list] = {}
        for verts, attr in zip(self.boundary, self.bdr_attr):
            out.setdefault(int(attr), []).extend(int(v) for v in verts)
        return {a: np.unique(np.asarray(v, dtype=np.int64))
                for a, v in out.items()}

    def max_bdr_attr(self) -> int:
        return int(self.bdr_attr.max()) if len(self.bdr_attr) else 0

    def ess_vertices(self, ess_attr_marker: np.ndarray) -> np.ndarray:
        """Vertices on boundary faces whose attribute is marked essential.

        ess_attr_marker[a-1] != 0 marks attribute a (mfem ess_bdr Array)."""
        if len(self.bdr_attr) == 0:
            return np.zeros(0, dtype=np.int64)
        bdr = np.asarray(self.boundary, dtype=np.int64)
        marker = np.asarray(ess_attr_marker)
        if bdr.ndim == 2:        # rectangular face lists: fully vectorized
            mask = marker[np.asarray(self.bdr_attr, dtype=np.int64) - 1] != 0
            return np.unique(bdr[mask])
        marked = []
        for verts, attr in zip(self.boundary, self.bdr_attr):
            if marker[int(attr) - 1]:
                marked.extend(int(v) for v in verts)
        return np.unique(np.asarray(marked, dtype=np.int64))

    # ------------------------------------------------------------------
    def refine_uniform(self) -> "Mesh":
        if self.elem_type == "quad":
            return _refine_quad(self)
        if self.elem_type == "hex":
            return _refine_hex(self)
        if self.elem_type == "tet":
            return _refine_tet(self)
        raise NotImplementedError(self.elem_type)

    def refined_times(self, n: int) -> "Mesh":
        m = self
        for _ in range(n):
            m = m.refine_uniform()
        return m

    def refined_to_at_least(self, target_ne: int) -> "Mesh":
        """fem_refine_mesh_to (fem.cpp:56-66): refine until NE >= target."""
        m = self
        while m.num_elements < target_ne:
            m = m.refine_uniform()
        return m


# ---------------------------------------------------------------------------
# generators


def quad_mesh(nx: int, ny: int = None, sx: float = 1.0,
              sy: float = 1.0) -> Mesh:
    """Structured quads on [0,sx]x[0,sy] (mfem Mesh(nx,ny,QUADRILATERAL)).

    Vertex numbering row-major bottom-to-top; element (i,j) has vertices
    (counter-clockwise) [v00, v10, v11, v01]. Boundary attrs: 1=bottom,
    2=right, 3=top, 4=left (MFEM cartesian convention)."""
    if ny is None:
        ny = nx
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return j * (nx + 1) + i

    elems = []
    for j in range(ny):
        for i in range(nx):
            elems.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                          vid(i, j + 1)])
    bdry, battr = [], []
    for i in range(nx):
        bdry.append([vid(i, 0), vid(i + 1, 0)]); battr.append(1)
        bdry.append([vid(i + 1, ny), vid(i, ny)]); battr.append(3)
    for j in range(ny):
        bdry.append([vid(nx, j), vid(nx, j + 1)]); battr.append(2)
        bdry.append([vid(0, j + 1), vid(0, j)]); battr.append(4)
    return Mesh(2, vertices, np.asarray(elems, dtype=np.int64), "quad",
                np.ones(len(elems), dtype=np.int64),
                np.asarray(bdry, dtype=np.int64),
                np.asarray(battr, dtype=np.int64), uniform=True)


def hex_mesh(nx: int, ny: int = None, nz: int = None, sx: float = 1.0,
             sy: float = 1.0, sz: float = 1.0) -> Mesh:
    """Structured hexes on [0,sx]x[0,sy]x[0,sz].

    Mirrors the SPE10 generator in the reference driver
    (mltest.cpp:54-150 create_hexadral_mesh) including its boundary
    attribute convention 1..6 (x-,x+,y-,y+,z-,z+)."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    sI = (ny + 1) * (nz + 1)
    sJ = nz + 1

    def vid(i, j, k):
        # vectorized: i/j/k may be arrays
        return i * sI + j * sJ + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    v000 = vid(I, J, K); v001 = vid(I, J, K + 1)
    v010 = vid(I, J + 1, K); v011 = vid(I, J + 1, K + 1)
    v100 = vid(I + 1, J, K); v101 = vid(I + 1, J, K + 1)
    v110 = vid(I + 1, J + 1, K); v111 = vid(I + 1, J + 1, K + 1)
    elems = np.stack([v000, v100, v110, v010, v001, v101, v111, v011],
                     axis=1)

    bdry_parts, battr_parts = [], []

    def face(mask, quad, attr):
        faces = np.stack([q[mask] for q in quad], axis=1)
        bdry_parts.append(faces)
        battr_parts.append(np.full(len(faces), attr, dtype=np.int64))

    face(I == 0, (v000, v001, v011, v010), 1)
    face(I == nx - 1, (v100, v110, v111, v101), 2)
    face(J == 0, (v000, v001, v101, v100), 3)
    face(J == ny - 1, (v010, v011, v111, v110), 4)
    face(K == 0, (v000, v100, v110, v010), 5)
    face(K == nz - 1, (v001, v101, v111, v011), 6)
    return Mesh(3, vertices, elems.astype(np.int64), "hex",
                np.ones(len(elems), dtype=np.int64),
                np.concatenate(bdry_parts).astype(np.int64),
                np.concatenate(battr_parts), uniform=True,
                grid=(nx, ny, nz))


# ---------------------------------------------------------------------------
# readers


def read_mfem_mesh(path: str) -> Mesh:
    """MFEM mesh v1.0 ASCII reader (subset: linear tri/quad/tet/hex)."""
    with open(path) as f:
        tokens_by_section = {}
        lines = [ln.split("#")[0].strip() for ln in f]
    lines = [ln for ln in lines if ln]
    it = iter(lines)
    header = next(it)
    assert "MFEM mesh" in header, header
    dim = None
    elements = None
    elem_attr = None
    elem_type = None
    boundary = None
    bdr_attr = None
    vertices = None
    geom_map = {2: ("tri", 3), 3: ("quad", 4), 4: ("tet", 4), 5: ("hex", 8)}
    while True:
        try:
            sec = next(it)
        except StopIteration:
            break
        if sec == "dimension":
            dim = int(next(it))
        elif sec in ("elements", "boundary"):
            n = int(next(it))
            rows, attrs, types = [], [], []
            for _ in range(n):
                parts = next(it).split()
                attrs.append(int(parts[0]))
                g = int(parts[1])
                verts = [int(x) for x in parts[2:]]
                types.append(g)
                rows.append(verts)
            if sec == "elements":
                elem_type, nv = geom_map[types[0]]
                elements = np.asarray(rows, dtype=np.int64)
                elem_attr = np.asarray(attrs, dtype=np.int64)
            else:
                boundary = np.asarray(rows, dtype=np.int64)
                bdr_attr = np.asarray(attrs, dtype=np.int64)
        elif sec == "vertices":
            n = int(next(it))
            vdim = int(next(it))
            vertices = np.zeros((n, vdim))
            for i in range(n):
                vertices[i] = [float(x) for x in next(it).split()]
    assert dim is not None and elements is not None and vertices is not None
    if boundary is None:
        # a file without a boundary section parses fine; synthesize
        # empty arrays so max_bdr_attr()/ess_vertices() degrade cleanly
        # instead of crashing on None far from the reader
        nbv = elements.shape[1] - (1 if elem_type in ("tet", "quad")
                                   else 2 if elem_type == "hex" else 1)
        boundary = np.zeros((0, max(nbv, 2)), dtype=np.int64)
        bdr_attr = np.zeros(0, dtype=np.int64)
    return Mesh(dim, vertices[:, :dim], elements, elem_type, elem_attr,
                boundary, bdr_attr)


def read_netgen_mesh(path: str) -> Mesh:
    """NETGEN neutral format tet mesh (cube474.mesh3d style).

    MFEM assigns boundary attribute = the surface element's attribute."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    it = iter(lines)
    first = next(it)
    if not first[0].isdigit():   # optional "NETGEN_Neutral_Format" header
        first = next(it)
    nv = int(first)
    vertices = np.array([[float(x) for x in next(it).split()]
                         for _ in range(nv)])
    ne = int(next(it))
    rows = np.zeros((ne, 4), dtype=np.int64)
    attrs = np.zeros(ne, dtype=np.int64)
    for i in range(ne):
        parts = [int(x) for x in next(it).split()]
        attrs[i] = parts[0]
        rows[i] = [p - 1 for p in parts[1:5]]
    nb = int(next(it))
    brows = np.zeros((nb, 3), dtype=np.int64)
    battrs = np.zeros(nb, dtype=np.int64)
    for i in range(nb):
        parts = [int(x) for x in next(it).split()]
        battrs[i] = parts[0]
        brows[i] = [p - 1 for p in parts[1:4]]
    return Mesh(3, vertices, rows, "tet", attrs, brows, battrs)


def read_mesh(path: str) -> Mesh:
    with open(path) as f:
        head = f.readline()
    if "MFEM" in head:
        return read_mfem_mesh(path)
    return read_netgen_mesh(path)


# ---------------------------------------------------------------------------
# refinement


class _EdgeMidpoints:
    def __init__(self, vertices: np.ndarray):
        self.verts = [v for v in vertices]
        self.cache: Dict[Tuple[int, int], int] = {}

    def mid(self, a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        v = self.cache.get(key)
        if v is None:
            v = len(self.verts)
            self.verts.append(0.5 * (self.verts[a] + self.verts[b]))
            self.cache[key] = v
        return v

    def center(self, ids) -> int:
        v = len(self.verts)
        self.verts.append(np.mean([self.verts[i] for i in ids], axis=0))
        return v

    def array(self) -> np.ndarray:
        return np.asarray(self.verts)


def _refine_quad(m: Mesh) -> Mesh:
    em = _EdgeMidpoints(m.vertices)
    elems, battr, bdry = [], [], []
    for verts in m.elements:
        v0, v1, v2, v3 = (int(x) for x in verts)
        e01 = em.mid(v0, v1); e12 = em.mid(v1, v2)
        e23 = em.mid(v2, v3); e30 = em.mid(v3, v0)
        c = em.center([v0, v1, v2, v3])
        elems += [[v0, e01, c, e30], [e01, v1, e12, c],
                  [c, e12, v2, e23], [e30, c, e23, v3]]
    for verts, attr in zip(m.boundary, m.bdr_attr):
        a, b = int(verts[0]), int(verts[1])
        mid = em.mid(a, b)
        bdry += [[a, mid], [mid, b]]
        battr += [int(attr)] * 2
    attr = np.repeat(m.elem_attr, 4)
    return Mesh(2, em.array(), np.asarray(elems, dtype=np.int64), "quad",
                attr, np.asarray(bdry, dtype=np.int64),
                np.asarray(battr, dtype=np.int64))


def _refine_hex(m: Mesh) -> Mesh:
    em = _EdgeMidpoints(m.vertices)
    elems = []
    face_defs = _GEOM["hex"]["faces"]
    face_cache: Dict[Tuple[int, ...], int] = {}

    def face_center(ids):
        key = tuple(sorted(ids))
        v = face_cache.get(key)
        if v is None:
            v = em.center(ids)
            face_cache[key] = v
        return v

    for verts in m.elements:
        v = [int(x) for x in verts]
        # local structured grid of 27 points
        p = {}
        for i, vi in enumerate(v):
            p[i] = vi
        e = {fr: em.mid(v[a], v[b]) for fr, (a, b) in enumerate(
            [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)])}
        f = [face_center([v[i] for i in fd]) for fd in face_defs]
        c = em.center(v)
        # assemble 8 children (standard hex refinement template)
        elems += [
            [v[0], e[0], f[0], e[3], e[8], f[2], c, f[4]],
            [e[0], v[1], e[1], f[0], f[2], e[9], f[5], c],
            [f[0], e[1], v[2], e[2], c, f[5], e[10], f[3]],
            [e[3], f[0], e[2], v[3], f[4], c, f[3], e[11]],
            [e[8], f[2], c, f[4], v[4], e[4], f[1], e[7]],
            [f[2], e[9], f[5], c, e[4], v[5], e[5], f[1]],
            [c, f[5], e[10], f[3], f[1], e[5], v[6], e[6]],
            [f[4], c, f[3], e[11], e[7], f[1], e[6], v[7]],
        ]
    bdry, battr = [], []
    for verts, attr in zip(m.boundary, m.bdr_attr):
        q = [int(x) for x in verts]
        eds = [em.mid(q[i], q[(i + 1) % 4]) for i in range(4)]
        fc = face_center(q)
        bdry += [[q[0], eds[0], fc, eds[3]], [eds[0], q[1], eds[1], fc],
                 [fc, eds[1], q[2], eds[2]], [eds[3], fc, eds[2], q[3]]]
        battr += [int(attr)] * 4
    return Mesh(3, em.array(), np.asarray(elems, dtype=np.int64), "hex",
                np.repeat(m.elem_attr, 8),
                np.asarray(bdry, dtype=np.int64),
                np.asarray(battr, dtype=np.int64))


def _refine_tet(m: Mesh) -> Mesh:
    em = _EdgeMidpoints(m.vertices)
    elems = []
    for verts in m.elements:
        v0, v1, v2, v3 = (int(x) for x in verts)
        m01 = em.mid(v0, v1); m02 = em.mid(v0, v2); m03 = em.mid(v0, v3)
        m12 = em.mid(v1, v2); m13 = em.mid(v1, v3); m23 = em.mid(v2, v3)
        elems += [
            [v0, m01, m02, m03], [m01, v1, m12, m13],
            [m02, m12, v2, m23], [m03, m13, m23, v3],
            # octahedron split along diagonal m01-m23; last two vertices
            # ordered so every child keeps POSITIVE orientation (the
            # mfem ReorientTetMesh invariant — consumers may assume
            # consistent signed volumes even though assembly uses |det|)
            [m01, m02, m23, m12], [m01, m12, m23, m13],
            [m01, m13, m23, m03], [m01, m03, m23, m02],
        ]
    bdry, battr = [], []
    for verts, attr in zip(m.boundary, m.bdr_attr):
        a, b, c = (int(x) for x in verts)
        ab = em.mid(a, b); bc = em.mid(b, c); ca = em.mid(c, a)
        bdry += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        battr += [int(attr)] * 4
    return Mesh(3, em.array(), np.asarray(elems, dtype=np.int64), "tet",
                np.repeat(m.elem_attr, 8),
                np.asarray(bdry, dtype=np.int64),
                np.asarray(battr, dtype=np.int64))
