from .trimesh import TriMesh
from .marking import (
    BoundaryMarkers,
    mark_boundaries,
    airfoil_polyline,
    WALLS,
    AIRFOIL,
    INFLOW,
    OUTFLOW,
    UNMARKED,
)
from .smooth import smooth
from .xdmf import load_npz, read_xdmf, save_npz, write_xdmf

__all__ = [
    "TriMesh",
    "BoundaryMarkers",
    "mark_boundaries",
    "airfoil_polyline",
    "WALLS",
    "AIRFOIL",
    "INFLOW",
    "OUTFLOW",
    "UNMARKED",
    "load_npz",
    "read_xdmf",
    "save_npz",
    "smooth",
    "write_xdmf",
]
