"""Host triangle meshes (port of ``shimmer_tpu/shapes/mesh.py``:
``TriangleMesh``, ``quad_mesh`` and the PLY reader ``read_ply``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.reference.frozen.ops.transform import Transform


class TriangleMesh:
    """Host-side mesh with vertices pre-transformed to render space."""

    def __init__(
        self,
        render_from_object: Transform,
        indices,
        p,
        n=None,
        uv=None,
        reverse_orientation: bool = False,
    ):
        self.indices = np.asarray(indices, np.int32).reshape(-1, 3)
        p = np.asarray(p, np.float32)
        m = np.asarray(render_from_object.m, np.float64)
        ph = p @ m[:3, :3].T + m[:3, 3]
        ww = p @ m[3:4, :3].T + m[3, 3]
        self.p = (ph / np.where(ww == 0.0, 1.0, ww)).astype(np.float32)
        if n is not None:
            mi = np.asarray(render_from_object.m_inv, np.float64)
            n_r = np.asarray(n, np.float32) @ mi[:3, :3]
            norm = np.linalg.norm(n_r, axis=-1, keepdims=True)
            self.n = (n_r / np.maximum(norm, 1e-12)).astype(np.float32)
            if bool(render_from_object.swaps_handedness()):
                self.n = -self.n
        else:
            self.n = None
        self.uv = np.asarray(uv, np.float32) if uv is not None else None
        self.reverse_orientation = bool(reverse_orientation)

    @property
    def n_triangles(self):
        return self.indices.shape[0]

    def as_scene_dict(self, material_id=-1, area_light_id=-1) -> dict:
        return {
            "p": self.p,
            "indices": self.indices,
            "n": self.n,
            "uv": self.uv,
            "material_id": material_id,
            "area_light_id": area_light_id,
            "reverse_orientation": self.reverse_orientation,
        }


def quad_mesh(render_from_object: Transform, p00, p10, p11, p01, **kw) -> TriangleMesh:
    """Two-triangle quad."""
    p = np.stack([p00, p10, p11, p01]).astype(np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriangleMesh(render_from_object, idx, p, uv=uv, **kw)


# --- PLY reading ---

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str | Path) -> dict:
    """Read a PLY mesh (ascii, binary little- or big-endian) -> dict with
    ``p`` (V, 3) float32, ``indices`` (T, 3) int32 (each quad split into
    two triangles) and ``n`` / ``uv`` float32 or None."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', idx_t, val_t, name)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        out = {}
        if fmt == "ascii":
            text = f.read().decode("ascii").split("\n")
            pos = 0
            for name, count, props in elements:
                rows = []
                for i in range(count):
                    rows.append(text[pos + i].split())
                pos += count
                out[name] = (props, rows)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            for name, count, props in elements:
                if any(p[0] == "list" for p in props):
                    # variable-length lists: parse sequentially
                    assert len(props) == 1, "mixed list/scalar props unsupported"
                    _, idx_t, val_t, pname = props[0]
                    idx_dt = np.dtype(endian + _PLY_DTYPES[idx_t])
                    val_dt = np.dtype(endian + _PLY_DTYPES[val_t])
                    faces = []
                    # Fast path: peek first face count, assume uniform, verify.
                    raw = f.read()
                    off = 0
                    n0 = int(np.frombuffer(raw, idx_dt, 1, off)[0])
                    stride = idx_dt.itemsize + n0 * val_dt.itemsize
                    if len(raw) >= count * stride:
                        counts = np.frombuffer(
                            raw[: count * stride], np.uint8
                        ).reshape(count, stride)[:, : idx_dt.itemsize]
                        counts = counts.copy().view(idx_dt).reshape(count)
                        if np.all(counts == n0):
                            vals = (
                                np.frombuffer(raw[: count * stride], np.uint8)
                                .reshape(count, stride)[:, idx_dt.itemsize :]
                                .copy()
                                .view(val_dt)
                                .reshape(count, n0)
                            )
                            out[name] = (props, vals.astype(np.int64))
                            f = None
                            break
                    # Slow path: ragged lists.
                    for _ in range(count):
                        k = int(np.frombuffer(raw, idx_dt, 1, off)[0])
                        off += idx_dt.itemsize
                        faces.append(
                            np.frombuffer(raw, val_dt, k, off).astype(np.int64)
                        )
                        off += k * val_dt.itemsize
                    out[name] = (props, faces)
                else:
                    dt = np.dtype(
                        [(p[0], endian + _PLY_DTYPES[p[1]]) for p in props]
                    )
                    data = np.frombuffer(f.read(count * dt.itemsize), dt)
                    out[name] = (props, data)

    # Extract vertices.
    vprops, vdata = out["vertex"]
    if isinstance(vdata, np.ndarray) and vdata.dtype.names:
        names = vdata.dtype.names
        p = np.stack(
            [vdata["x"], vdata["y"], vdata["z"]], axis=-1
        ).astype(np.float32)
        n = (
            np.stack([vdata["nx"], vdata["ny"], vdata["nz"]], axis=-1).astype(
                np.float32
            )
            if "nx" in names
            else None
        )
        uv = None
        for ukey, vkey in (("u", "v"), ("s", "t")):
            if ukey in names:
                uv = np.stack([vdata[ukey], vdata[vkey]], axis=-1).astype(np.float32)
                break
    else:  # ascii rows
        names = [pp[0] for pp in vprops]
        arr = np.array(vdata, np.float64)
        col = {nm: arr[:, i] for i, nm in enumerate(names)}
        p = np.stack([col["x"], col["y"], col["z"]], -1).astype(np.float32)
        n = (
            np.stack([col["nx"], col["ny"], col["nz"]], -1).astype(np.float32)
            if "nx" in col
            else None
        )
        uv = (
            np.stack([col["u"], col["v"]], -1).astype(np.float32)
            if "u" in col
            else None
        )

    # Faces -> triangles, quads split in two.
    fname = "face" if "face" in out else "faces"
    fprops, fdata = out[fname]
    tris = []
    if isinstance(fdata, np.ndarray) and fdata.ndim == 2:
        k = fdata.shape[1]
        if k == 3:
            tris.append(fdata)
        elif k == 4:
            tris.append(fdata[:, [0, 1, 2]])
            tris.append(fdata[:, [0, 2, 3]])
        else:
            raise ValueError(f"{k}-gon faces unsupported")
    else:
        for face in fdata:
            if isinstance(face, list):
                # ascii row: leading element is the list count
                k = int(face[0])
                face = np.asarray(face[1 : 1 + k], np.int64)
            else:
                face = np.asarray(face, np.int64)
            if len(face) == 3:
                tris.append(face[None])
            elif len(face) == 4:
                tris.append(np.array([face[[0, 1, 2]], face[[0, 2, 3]]]))
            else:
                raise ValueError(f"{len(face)}-gon faces unsupported")
    indices = np.concatenate(tris).astype(np.int32)
    return {"p": p, "indices": indices, "n": n, "uv": uv}
