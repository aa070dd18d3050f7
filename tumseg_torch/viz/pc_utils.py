"""Point-cloud render/IO utilities: PLY read/write, cloud<->volume
conversion, euler rotations, and gaussian-disk three-view renders.

Capability parity with visualizer/pc_utils.py (which vendors
python-plyfile and NiBabel's eulerangles); here the PLY codec is a small
self-contained implementation (ascii + binary_little_endian vertex
elements) and the renderers are vectorized NumPy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# ----------------------------------------------------------------------
# Euler angles (z-y-x intrinsic, matching eulerangles.euler2mat semantics)
# ----------------------------------------------------------------------

def euler2mat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """Rotation matrix for intrinsic rotations about z, then y, then x."""
    mats = []
    if z:
        c, s = np.cos(z), np.sin(z)
        mats.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = np.cos(y), np.sin(y)
        mats.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = np.cos(x), np.sin(x)
        mats.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    out = np.eye(3)
    for m in mats:
        out = out @ m
    return out


def mat2euler(M, cy_thresh: float | None = None):
    """Invert :func:`euler2mat`: rotation matrix -> ``(z, y, x)`` angles.

    Same API surface as the reference's vendored eulerangles module
    (visualizer/eulerangles.py:168-227); derivation is our
    own for the ``Mz @ My @ Mx`` composition above: with ``cy = cos(y)``,
    ``M[2,0] = -sin(y)``, ``M[0,0]/M[1,0] = cy*cos(z)/cy*sin(z)`` and
    ``M[2,1]/M[2,2] = cy*sin(x)/cy*cos(x)``. Near the gimbal lock
    (``cy ~ 0``) x is unobservable from z; we pin ``x = 0`` and read the
    remaining angle off the first row.
    """
    M = np.asarray(M, dtype=float)
    if cy_thresh is None:
        cy_thresh = np.finfo(M.dtype).eps * 4
    cy = np.sqrt(M[0, 0] ** 2 + M[1, 0] ** 2)
    if cy > cy_thresh:
        z = np.arctan2(M[1, 0], M[0, 0])
        y = np.arctan2(-M[2, 0], cy)
        x = np.arctan2(M[2, 1], M[2, 2])
    else:
        # sy = -M[2,0] = +-1. Row 0 degenerates to [0, -+sin(x -+ z),
        # +-cos(x -+ z)]; with x pinned to 0 the row yields z directly.
        sy = -M[2, 0]
        z = np.arctan2(-M[0, 1], np.sign(sy) * M[0, 2])
        y = np.arctan2(sy, cy)
        x = 0.0
    return z, y, x


def euler2quat(z: float = 0, y: float = 0, x: float = 0) -> np.ndarray:
    """``(z, y, x)`` angles -> unit quaternion ``[w, x, y, z]`` for the same
    rotation as :func:`euler2mat` (qz * qy * qx Hamilton product; reference
    surface visualizer/eulerangles.py:228-270)."""
    cz, sz = np.cos(z / 2.0), np.sin(z / 2.0)
    cy, sy = np.cos(y / 2.0), np.sin(y / 2.0)
    cx, sx = np.cos(x / 2.0), np.sin(x / 2.0)
    return np.array([
        cx * cy * cz + sx * sy * sz,
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
    ])


def _quat2mat(q) -> np.ndarray:
    """Unit-normalizing quaternion ``[w, x, y, z]`` -> rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=float)
    n = w * w + x * x + y * y + z * z
    if n < np.finfo(float).eps:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1.0 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1.0 - xx - yy],
    ])


def quat2euler(q):
    """Quaternion ``[w, x, y, z]`` -> ``(z, y, x)`` angles (reference
    surface visualizer/eulerangles.py:271-296)."""
    return mat2euler(_quat2mat(q))


def euler2angle_axis(z: float = 0, y: float = 0, x: float = 0):
    """``(z, y, x)`` angles -> ``(theta, unit_vector)`` rotation
    (reference surface visualizer/eulerangles.py:297-326)."""
    w, qx, qy, qz = euler2quat(z, y, x)
    v = np.array([qx, qy, qz])
    norm = np.linalg.norm(v)
    theta = 2.0 * np.arctan2(norm, w)
    if norm < np.finfo(float).eps:
        return 0.0, np.array([1.0, 0.0, 0.0])
    return theta, v / norm


def angle_axis2euler(theta: float, vector, is_normalized: bool = False):
    """``(theta, axis)`` rotation -> ``(z, y, x)`` angles (reference
    surface visualizer/eulerangles.py:327-358). Rodrigues
    rotation composed from our quaternion helpers."""
    v = np.asarray(vector, dtype=float)
    if not is_normalized:
        v = v / np.linalg.norm(v)
    half = theta / 2.0
    q = np.concatenate([[np.cos(half)], np.sin(half) * v])
    return mat2euler(_quat2mat(q))


# ----------------------------------------------------------------------
# Cloud <-> volume
# ----------------------------------------------------------------------

def point_cloud_to_volume(points: np.ndarray, vsize: int,
                          radius: float = 1.0) -> np.ndarray:
    """[N,3] points in [-radius, radius] -> binary occupancy [vsize]^3."""
    vol = np.zeros((vsize, vsize, vsize))
    voxel = 2 * radius / float(vsize)
    locations = ((points + radius) / voxel).astype(int)
    locations = np.clip(locations, 0, vsize - 1)
    vol[locations[:, 0], locations[:, 1], locations[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds: np.ndarray, vsize: int = 12,
                                radius: float = 1.0, flatten: bool = True):
    vols = [point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds]
    if flatten:
        return np.vstack([v.flatten() for v in vols])
    return np.stack(vols)[..., None]


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupancy grid -> [N,3] voxel coordinates (vectorized)."""
    return np.argwhere(vol == 1).astype(np.float64)


# ----------------------------------------------------------------------
# PLY IO (self-contained: ascii + binary_little_endian, vertex element)
# ----------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> np.ndarray:
    """Read the vertex element of a PLY file -> [N, 3] xyz array."""
    data = read_ply_full(path)
    v = data["vertex"]
    return np.stack([v["x"], v["y"], v["z"]], axis=1)


# property spec: (name, item dtype code, count dtype code or None for scalar)
_PropSpec = Tuple[str, str, object]


def _parse_ply_header(f) -> Tuple[str, List[Tuple[str, int, List[_PropSpec]]]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, List[_PropSpec]]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        parts = line.decode("ascii").strip().split()
        if not parts or parts[0] in ("comment", "obj_info"):
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _PLY_TYPES[parts[3]], _PLY_TYPES[parts[2]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], None))
        elif parts[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")
    return fmt, elements


def _read_binary_element(f, count, props, bo):
    has_list = any(cnt is not None for _, _, cnt in props)
    if not has_list:
        dtype = np.dtype([(p, bo + t) for p, t, _ in props])
        return np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                             count=count)
    # variable-length rows: parse sequentially; list fields become object cols
    dtype = np.dtype([(p, "O" if cnt is not None else t)
                      for p, t, cnt in props])
    rec = np.empty(count, dtype=dtype)
    for i in range(count):
        for p, t, cnt in props:
            if cnt is None:
                rec[i][p] = np.frombuffer(
                    f.read(np.dtype(t).itemsize), dtype=bo + t)[0]
            else:
                n = int(np.frombuffer(f.read(np.dtype(cnt).itemsize),
                                      dtype=bo + cnt)[0])
                rec[i][p] = np.frombuffer(
                    f.read(np.dtype(t).itemsize * n), dtype=bo + t, count=n)
    return rec


def _read_ascii_element(tokens, pos, count, props):
    has_list = any(cnt is not None for _, _, cnt in props)
    if not has_list:
        ncol = len(props)
        chunk = np.array(tokens[pos:pos + count * ncol], dtype=np.float64)
        chunk = chunk.reshape(count, ncol)
        rec = np.zeros(count, dtype=[(p, t) for p, t, _ in props])
        for i, (p, _, _) in enumerate(props):
            rec[p] = chunk[:, i]
        return rec, pos + count * ncol
    dtype = np.dtype([(p, "O" if cnt is not None else t)
                      for p, t, cnt in props])
    rec = np.empty(count, dtype=dtype)
    for i in range(count):
        for p, t, cnt in props:
            if cnt is None:
                rec[i][p] = np.array(tokens[pos], dtype=t)[()]
                pos += 1
            else:
                n = int(tokens[pos])
                pos += 1
                rec[i][p] = np.array(tokens[pos:pos + n], dtype=t)
                pos += n
    return rec, pos


def read_ply_full(path: str) -> Dict[str, np.ndarray]:
    """Parse all elements of a PLY file (ascii, binary little- or big-endian,
    scalar and list properties — the full capability surface of the
    reference's vendored plyfile, visualizer/plyfile.py) into
    structured arrays keyed by element name; list properties become object
    columns of per-row arrays."""
    with open(path, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        out = {}
        if fmt == "ascii":
            tokens = f.read().decode("ascii").split()
            pos = 0
            for name, count, props in elements:
                out[name], pos = _read_ascii_element(tokens, pos, count, props)
        else:
            bo = "<" if fmt == "binary_little_endian" else ">"
            for name, count, props in elements:
                out[name] = _read_binary_element(f, count, props, bo)
        return out


_PLY_NAMES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def _ply_type_name(dtype) -> str:
    code = np.dtype(dtype).str.lstrip("<>=|")
    if code not in _PLY_NAMES:
        raise ValueError(f"dtype {dtype} not representable in PLY")
    return _PLY_NAMES[code]


def write_ply_full(filename: str, elements: Dict[str, np.ndarray],
                   text: bool = True, byte_order: str = "<",
                   comments=()) -> None:
    """Write structured arrays as a multi-element PLY file (ascii or binary,
    either endianness); object-dtype columns are written as list properties
    with a uint count. Inverse of :func:`read_ply_full`."""
    fmt = ("ascii" if text else
           "binary_little_endian" if byte_order == "<"
           else "binary_big_endian")
    header = ["ply", f"format {fmt} 1.0"]
    header += [f"comment {c}" for c in comments]
    specs = {}
    for name, rec in elements.items():
        header.append(f"element {name} {rec.shape[0]}")
        props = []
        for p in rec.dtype.names:
            if rec.dtype[p] == np.dtype("O"):
                item = np.asarray(rec[p][0]).dtype if rec.shape[0] else "f4"
                header.append(
                    f"property list uint {_ply_type_name(item)} {p}")
                props.append((p, np.dtype(item).str.lstrip("<>=|"), "u4"))
            else:
                header.append(f"property {_ply_type_name(rec.dtype[p])} {p}")
                props.append((p, rec.dtype[p].str.lstrip("<>=|"), None))
        specs[name] = props
    header.append("end_header")

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for name, rec in elements.items():
            props = specs[name]
            if text:
                for row in rec:
                    cells = []
                    for p, _, cnt in props:
                        v = row[p]
                        if cnt is None:
                            cells.append(str(v))
                        else:
                            arr = np.asarray(v)
                            cells.append(" ".join(
                                [str(arr.size)] + [str(x) for x in arr]))
                    f.write((" ".join(cells) + "\n").encode("ascii"))
            elif all(cnt is None for _, _, cnt in props):
                dtype = np.dtype([(p, byte_order + t) for p, t, _ in props])
                f.write(rec.astype(dtype).tobytes())
            else:
                for row in rec:
                    for p, t, cnt in props:
                        v = row[p]
                        if cnt is None:
                            f.write(np.asarray(v, dtype=byte_order + t)
                                    .tobytes())
                        else:
                            arr = np.asarray(v, dtype=byte_order + t)
                            f.write(np.asarray(arr.size,
                                               dtype=byte_order + cnt)
                                    .tobytes())
                            f.write(arr.tobytes())


def write_ply(points: np.ndarray, filename: str, text: bool = True) -> None:
    """Write [N,3] xyz to a PLY file (ascii by default, like the reference's
    write_ply at pc_utils.py:86-91; binary_little_endian otherwise)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    header = ["ply",
              "format %s 1.0" % ("ascii" if text else "binary_little_endian"),
              "comment vertices",
              f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "end_header"]
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if text:
            for p in points:
                f.write((f"{p[0]} {p[1]} {p[2]}\n").encode("ascii"))
        else:
            f.write(points.astype("<f4").tobytes())


# ----------------------------------------------------------------------
# Gaussian-disk renders
# ----------------------------------------------------------------------

def draw_point_cloud(input_points: np.ndarray, canvasSize: int = 500,
                     space: int = 200, diameter: int = 25, xrot: float = 0,
                     yrot: float = 0, zrot: float = 0,
                     switch_xyz=(0, 1, 2), normalize: bool = True) -> np.ndarray:
    """Render a cloud to a grayscale [canvasSize]^2 image with back-to-front
    gaussian-disk splats and exponential depth blending (pc_utils.py:98-155
    semantics, vectorized splat precompute)."""
    image = np.zeros((canvasSize, canvasSize))
    if input_points is None or input_points.shape[0] == 0:
        return image

    points = input_points[:, list(switch_xyz)].astype(np.float64)
    points = points @ euler2mat(zrot, yrot, xrot).T

    if normalize:
        points = points - points.mean(axis=0)
        furthest = np.sqrt((points ** 2).sum(axis=1)).max()
        points = points / max(furthest, 1e-12)

    radius = (diameter - 1) / 2.0
    ii, jj = np.meshgrid(np.arange(diameter), np.arange(diameter),
                         indexing="ij")
    rr = (ii - radius) ** 2 + (jj - radius) ** 2
    disk = np.where(rr <= radius ** 2,
                    np.exp(-rr / (radius ** 2)), 0.0)
    mask = np.argwhere(disk > 0)
    dx, dy = mask[:, 0], mask[:, 1]
    dv = disk[disk > 0]

    order = np.argsort(points[:, 2])
    points = points[order]
    z = points[:, 2]
    z = (z - z.min()) / max(z.max() - z.min(), 1e-12)
    max_depth = z.max()

    centers = np.round(canvasSize / 2 + points[:, :2] * space).astype(int)
    # paint far-to-near (reference iterates j from the nearest down)
    for j in range(points.shape[0] - 1, -1, -1):
        px = dx + centers[j, 0]
        py = dy + centers[j, 1]
        ok = (px >= 0) & (px < canvasSize) & (py >= 0) & (py < canvasSize)
        image[px[ok], py[ok]] = (image[px[ok], py[ok]] * 0.7
                                 + dv[ok] * (max_depth - z[j]) * 0.3)

    m = image.max()
    return image / m if m > 0 else image


def point_cloud_three_views(points: np.ndarray) -> np.ndarray:
    """Three standard views concatenated to a 500x1500 gray image
    (pc_utils.py:158-169)."""
    deg = np.pi / 180.0
    img1 = draw_point_cloud(points, zrot=110 * deg, xrot=45 * deg, yrot=0)
    img2 = draw_point_cloud(points, zrot=70 * deg, xrot=135 * deg, yrot=0)
    img3 = draw_point_cloud(points, zrot=180 * deg, xrot=90 * deg, yrot=0)
    return np.concatenate([img1, img2, img3], axis=1)


def point_cloud_three_views_demo(points: np.ndarray,
                                 output_filename: str = "example.jpg") -> str:
    """Save a three-view render of a cloud as a JPEG (the reference demo at
    pc_utils.py:173-181, minus its hardcoded ShapeNet loader — the cloud is
    an argument here)."""
    from PIL import Image

    im_array = point_cloud_three_views(np.asarray(points))
    img = Image.fromarray(np.uint8(im_array * 255.0))
    img.save(output_filename)
    return output_filename


# ----------------------------------------------------------------------
# Matplotlib 3D previews (reference pc_utils.py:190-207; unlike the
# reference, savefig is actually called so the output file exists)
# ----------------------------------------------------------------------

def pyplot_draw_point_cloud(points: np.ndarray, output_filename: str) -> None:
    """Scatter an [N,3] cloud in a 3D axes and save it to a file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.savefig(output_filename)
    plt.close(fig)


def pyplot_draw_volume(vol: np.ndarray, output_filename: str) -> None:
    """Scatter-plot the occupied voxels of a [v,v,v] volume to a file."""
    pyplot_draw_point_cloud(volume_to_point_cloud(vol), output_filename)
