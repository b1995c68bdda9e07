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
]
