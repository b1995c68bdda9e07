"""Triangle-mesh I/O: XDMF/HDF5 in, and a compact .npz form for the card.

`read_xdmf` is a copy of meshdqn_tpu/mesh/xdmf.py's reader (XDMF 3.0 with
geometry and topology in an HDF5 file).  It imports h5py when it is called,
so importing the package never needs it: the machines that run the port may
have no h5py.  Such a machine reads the meshes from .npz files made here:

    python -m meshdqn_tpu_torch.mesh.xdmf src.xdmf dst.npz

writes `coords`, `cells` and `source_sha8`, the first 8 hex digits of the
sha256 of the mesh's .h5 payload (the MESH_SHA8 column of the oracle CSVs in
docs/examples/).  The package carries the finest generated meshes of both
airfoils this way under meshdqn_tpu_torch/data/.
"""
from __future__ import annotations

import hashlib
import os
import re
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from .trimesh import TriMesh

DATA_DIR = Path(__file__).resolve().parents[1] / "data"


def read_xdmf(path: str) -> TriMesh:
    """Load a triangle mesh from an XDMF file with HDF5 heavy data."""
    import h5py

    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))

    def _load(item) -> np.ndarray:
        text = item.text.strip()
        if item.get("Format", "HDF") == "HDF":
            h5path, dset = text.split(":", 1)
            if not os.path.isabs(h5path):
                h5path = os.path.join(base, h5path)
            with h5py.File(h5path, "r") as f:
                return f[dset][:]
        # Inline XML data.
        dims = [int(d) for d in re.split(r"\s+", item.get("Dimensions").strip())]
        return np.fromstring(text, sep=" ").reshape(dims)

    geom = root.find(".//Geometry/DataItem")
    topo = root.find(".//Topology/DataItem")
    if geom is None or topo is None:
        raise ValueError(f"{path}: no Geometry/Topology DataItem found")
    coords = np.asarray(_load(geom), dtype=np.float64)
    if coords.shape[1] == 3:  # XYZ geometry with zero z
        coords = coords[:, :2]
    cells = np.asarray(_load(topo), dtype=np.int32)
    return TriMesh(coords=coords, cells=cells)


def mesh_sha8(xdmf_path: str) -> str:
    """sha256 prefix of the mesh's .h5 payload (of the XDMF file itself when
    there is no .h5 beside it), as scripts/make_fine_oracle.py computes it."""
    h5 = os.path.splitext(xdmf_path)[0] + ".h5"
    target = h5 if os.path.exists(h5) else xdmf_path
    return hashlib.sha256(Path(target).read_bytes()).hexdigest()[:8]


def save_npz(path: str, mesh: TriMesh, source_sha8: str) -> None:
    np.savez_compressed(path, coords=mesh.coords, cells=mesh.cells,
                        source_sha8=np.asarray(source_sha8))


def load_npz(path) -> tuple[TriMesh, str]:
    """The mesh saved by `save_npz` and the sha8 of the file it came from."""
    with np.load(path) as z:
        return TriMesh(coords=z["coords"], cells=z["cells"]), str(z["source_sha8"])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m meshdqn_tpu_torch.mesh.xdmf SRC.xdmf DST.npz",
              file=sys.stderr)
        return 2
    src, dst = argv
    mesh, sha8 = read_xdmf(src), mesh_sha8(src)
    save_npz(dst, mesh, sha8)
    print(f"{dst}: {mesh.num_vertices} vertices, {mesh.num_cells} cells, "
          f"source_sha8={sha8}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
