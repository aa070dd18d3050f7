"""Pure-NumPy LAS 1.2/1.3/1.4 point-cloud reader/writer.

The reference pipeline ingests TUM-Facade tiles with ``laspy``
(the reference's localfunctions.py:122-126, sem_seg_training.py:137-153) and
accesses extra CloudCompare scalar fields by name via ``getattr(las, name)``
(sem_seg_training.py:150-153).  This module provides the same capability
surface without external dependencies:

- header parsing for LAS 1.2 (227 B), 1.3 (235 B) and 1.4 (375 B)
- point record formats 0-3 and 6-8 parsed with a NumPy structured dtype
  in one vectorized ``np.frombuffer`` (no per-point Python loop)
- Extra Bytes VLR (user id "LASF_Spec", record id 4) support so
  CloudCompare-exported scalar fields (e.g. "Planarity (0.8)") are exposed
  as attributes, like laspy does
- a writer (LAS 1.4, formats 2/3/6/7 + extra bytes) used by tools and the
  synthetic-tile test fixtures

Attribute access mirrors laspy: ``las.x/.y/.z`` are scaled float64 coords,
``las.classification`` masks the 5 classification bits for formats 0-5 and
uses the full byte for 6+, ``las.red/.green/.blue`` are uint16 colors, and
extra dimensions resolve by exact name, then case/space-insensitively.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_HEADER_FMT_12 = "<4sHH16sBB32s32sHHHLLBHL5L12d"  # through legacy point counts + scales/offsets/minmax
# We parse field-by-field instead for clarity; sizes below:
HEADER_SIZE = {(1, 2): 227, (1, 3): 235, (1, 4): 375}

# point format id -> (record length without extra bytes, structured dtype fields)
_COMMON_05 = [
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
    ("intensity", "<u2"), ("flags", "u1"), ("raw_classification", "u1"),
    ("scan_angle_rank", "i1"), ("user_data", "u1"), ("point_source_id", "<u2"),
]
_COMMON_610 = [
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
    ("intensity", "<u2"), ("return_info", "u1"), ("flags", "u1"),
    ("raw_classification", "u1"), ("user_data", "u1"),
    ("scan_angle", "<i2"), ("point_source_id", "<u2"),
]
_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_GPS = [("gps_time", "<f8")]
_NIR = [("nir", "<u2")]

POINT_FORMATS: Dict[int, List] = {
    0: _COMMON_05,
    1: _COMMON_05 + _GPS,
    2: _COMMON_05 + _RGB,
    3: _COMMON_05 + _GPS + _RGB,
    6: _COMMON_610 + _GPS,
    7: _COMMON_610 + _GPS + _RGB,
    8: _COMMON_610 + _GPS + _RGB + _NIR,
}

# Extra Bytes VLR data_type codes -> numpy dtype
_EB_DTYPES = {
    1: "u1", 2: "i1", 3: "<u2", 4: "<i2", 5: "<u4",
    6: "<i4", 7: "<u8", 8: "<i8", 9: "<f4", 10: "<f8",
}
_EB_DTYPE_CODE = {np.dtype(v.lstrip("<")): k for k, v in _EB_DTYPES.items()}


@dataclass
class ExtraDim:
    name: str
    dtype: np.dtype
    scale: Optional[float] = None
    offset: Optional[float] = None
    description: str = ""


@dataclass
class LasHeader:
    version: tuple = (1, 4)
    point_format: int = 7
    point_count: int = 0
    scales: np.ndarray = field(default_factory=lambda: np.array([0.001, 0.001, 0.001]))
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(3))
    mins: np.ndarray = field(default_factory=lambda: np.zeros(3))
    maxs: np.ndarray = field(default_factory=lambda: np.zeros(3))
    point_record_length: int = 0


class LasData:
    """Parsed LAS point cloud with laspy-like attribute access."""

    def __init__(self, header: LasHeader, records: np.ndarray,
                 extra_dims: List[ExtraDim]):
        self.header = header
        self._records = records
        self._extra_dims = {d.name: d for d in extra_dims}
        # Secondary lookup: lowercased, spaces/parens stripped.
        self._extra_alias = {_sanitize(d.name): d.name for d in extra_dims}

    def __len__(self):
        return len(self._records)

    # ---- coordinate accessors (scaled to world units, float64) ----
    @property
    def x(self) -> np.ndarray:
        return self._records["X"] * self.header.scales[0] + self.header.offsets[0]

    @property
    def y(self) -> np.ndarray:
        return self._records["Y"] * self.header.scales[1] + self.header.offsets[1]

    @property
    def z(self) -> np.ndarray:
        return self._records["Z"] * self.header.scales[2] + self.header.offsets[2]

    @property
    def xyz(self) -> np.ndarray:
        return np.stack([self.x, self.y, self.z], axis=1)

    @property
    def classification(self) -> np.ndarray:
        raw = self._records["raw_classification"]
        if self.header.point_format <= 5:
            return (raw & 0x1F).astype(np.uint8)
        return raw.astype(np.uint8)

    @property
    def point_format_dimensions(self) -> List[str]:
        return list(self._records.dtype.names) + list(self._extra_dims)

    def __getattr__(self, name: str):
        # Called only when normal lookup fails: standard record fields,
        # then extra-bytes dims (exact, then sanitized alias).
        records = self.__dict__.get("_records")
        if records is not None and records.dtype.names and name in records.dtype.names:
            return records[name]
        extra = self.__dict__.get("_extra_dims") or {}
        alias = self.__dict__.get("_extra_alias") or {}
        key = name if name in extra else alias.get(_sanitize(name))
        if key is not None:
            dim = extra[key]
            vals = records[_eb_field(key)]
            if dim.scale is not None or dim.offset is not None:
                return vals * (dim.scale or 1.0) + (dim.offset or 0.0)
            return vals
        raise AttributeError(f"LAS point cloud has no dimension {name!r}; "
                             f"available: {self.point_format_dimensions}")


def _sanitize(name: str) -> str:
    return "".join(ch for ch in name.lower() if ch.isalnum())


def _eb_field(name: str) -> str:
    return "__eb__" + name


def _read_vlrs(buf: bytes, offset: int, count: int):
    """Parse ``count`` VLRs starting at ``offset``; returns (vlrs, end_offset)."""
    vlrs = []
    for _ in range(count):
        if offset + 54 > len(buf):
            break
        (_, user_id, record_id, rec_len, _desc) = struct.unpack_from(
            "<H16sHH32s", buf, offset)
        payload = buf[offset + 54: offset + 54 + rec_len]
        vlrs.append((user_id.split(b"\x00")[0].decode("ascii", "replace"),
                     record_id, payload))
        offset += 54 + rec_len
    return vlrs, offset


def _parse_extra_bytes_vlr(payload: bytes) -> List[ExtraDim]:
    dims = []
    for off in range(0, len(payload) - 191, 192):
        (_, data_type, options) = struct.unpack_from("<HBB", payload, off)
        name = payload[off + 4: off + 36].split(b"\x00")[0].decode("ascii", "replace")
        scale = offset_v = None
        if options & 0x08:  # scale bit
            scale = struct.unpack_from("<d", payload, off + 112)[0]
        if options & 0x10:  # offset bit
            offset_v = struct.unpack_from("<d", payload, off + 136)[0]
        desc = payload[off + 160: off + 192].split(b"\x00")[0].decode("ascii", "replace")
        if data_type == 0:
            # options = number of raw undocumented bytes
            dims.append(ExtraDim(name or f"eb_{off//192}", np.dtype(("u1", options or 1)),
                                 None, None, desc))
        elif data_type in _EB_DTYPES:
            dims.append(ExtraDim(name or f"eb_{off//192}", np.dtype(_EB_DTYPES[data_type]),
                                 scale, offset_v, desc))
    return dims


def read_las(path: str) -> LasData:
    """Read a .las file (formats 0-3, 6-8; LAS 1.2-1.4) into a LasData."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file (bad signature {buf[:4]!r})")

    ver_major, ver_minor = buf[24], buf[25]
    header_size, = struct.unpack_from("<H", buf, 94)
    point_offset, = struct.unpack_from("<L", buf, 96)
    n_vlrs, = struct.unpack_from("<L", buf, 100)
    point_format = buf[104] & 0x3F  # high bits flag compression (laz unsupported)
    if buf[104] & 0xC0:
        raise ValueError(f"{path}: LAZ-compressed files are not supported")
    record_len, = struct.unpack_from("<H", buf, 105)
    legacy_count, = struct.unpack_from("<L", buf, 107)
    scales = np.array(struct.unpack_from("<3d", buf, 131))
    offsets = np.array(struct.unpack_from("<3d", buf, 155))
    max_x, min_x, max_y, min_y, max_z, min_z = struct.unpack_from("<6d", buf, 179)
    point_count = legacy_count
    if (ver_major, ver_minor) >= (1, 4) and header_size >= 375:
        count64, = struct.unpack_from("<Q", buf, 247)
        if count64:
            point_count = count64

    if point_format not in POINT_FORMATS:
        raise ValueError(f"{path}: unsupported point format {point_format}")

    vlrs, _ = _read_vlrs(buf, header_size, n_vlrs)
    extra_dims: List[ExtraDim] = []
    for user_id, record_id, payload in vlrs:
        if user_id == "LASF_Spec" and record_id == 4:
            extra_dims = _parse_extra_bytes_vlr(payload)

    base_fields = list(POINT_FORMATS[point_format])
    base_len = np.dtype(base_fields).itemsize
    fields = list(base_fields)
    eb_len = sum(d.dtype.itemsize for d in extra_dims)
    if base_len + eb_len != record_len:
        # Unknown trailing bytes (no/partial EB VLR): expose them as raw pad.
        pad = record_len - base_len - eb_len
        if pad < 0:
            raise ValueError(
                f"{path}: record length {record_len} smaller than format "
                f"{point_format} base {base_len} + extra {eb_len}")
        if pad:
            extra_dims = extra_dims + [ExtraDim("__pad__", np.dtype(("u1", pad)))]
    fields += [(_eb_field(d.name), d.dtype) for d in extra_dims]

    dtype = np.dtype(fields)
    assert dtype.itemsize == record_len, (dtype.itemsize, record_len)
    records = np.frombuffer(buf, dtype=dtype, count=point_count, offset=point_offset)

    header = LasHeader(
        version=(ver_major, ver_minor), point_format=point_format,
        point_count=point_count, scales=scales, offsets=offsets,
        mins=np.array([min_x, min_y, min_z]), maxs=np.array([max_x, max_y, max_z]),
        point_record_length=record_len)
    return LasData(header, records, [d for d in extra_dims if d.name != "__pad__"])


def write_las(path: str, xyz: np.ndarray, classification: np.ndarray,
              rgb: Optional[np.ndarray] = None,
              extra: Optional[Dict[str, np.ndarray]] = None,
              scales=(0.001, 0.001, 0.001)) -> None:
    """Write a LAS 1.4 file. Uses point format 7 (with RGB) or 6 (without).

    ``rgb`` is uint16 per LAS spec (callers with 8-bit colors should scale);
    ``extra`` maps scalar-field names to per-point arrays, written as an
    Extra Bytes VLR so that :func:`read_las` (and laspy/CloudCompare) can
    recover them by name.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    n = len(xyz)
    classification = np.asarray(classification).astype(np.uint8)
    point_format = 7 if rgb is not None else 6
    fields = list(POINT_FORMATS[point_format])

    extra = extra or {}
    extra_arrays = {k: np.asarray(v) for k, v in extra.items()}
    extra_dims = [ExtraDim(k, v.dtype if v.dtype.kind in "iuf" else np.dtype("<f8"))
                  for k, v in extra_arrays.items()]
    fields += [(_eb_field(d.name), d.dtype) for d in extra_dims]
    dtype = np.dtype(fields)

    offsets = xyz.min(axis=0)
    scales = np.asarray(scales, dtype=np.float64)
    records = np.zeros(n, dtype=dtype)
    scaled = np.round((xyz - offsets) / scales).astype(np.int64)
    if np.any(np.abs(scaled) > np.iinfo(np.int32).max):
        raise ValueError("coordinates overflow int32 at the given scale")
    records["X"], records["Y"], records["Z"] = scaled[:, 0], scaled[:, 1], scaled[:, 2]
    records["raw_classification"] = classification
    records["return_info"] = 0x11  # 1 return, return number 1
    if rgb is not None:
        rgb = np.asarray(rgb).astype(np.uint16)
        records["red"], records["green"], records["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    for d in extra_dims:
        records[_eb_field(d.name)] = extra_arrays[d.name].astype(d.dtype)

    # Extra Bytes VLR
    vlr_blobs = b""
    n_vlrs = 0
    if extra_dims:
        payload = b""
        for d in extra_dims:
            entry = bytearray(192)
            struct.pack_into("<HBB", entry, 0, 0, _EB_DTYPE_CODE[np.dtype(d.dtype.base)], 0)
            entry[4:4 + min(32, len(d.name))] = d.name.encode("ascii", "replace")[:32]
            payload += bytes(entry)
        vlr_blobs += struct.pack("<H16sHH32s", 0, b"LASF_Spec", 4, len(payload),
                                 b"Extra Bytes") + payload
        n_vlrs = 1

    header_size = HEADER_SIZE[(1, 4)]
    point_offset = header_size + len(vlr_blobs)
    mins, maxs = xyz.min(axis=0), xyz.max(axis=0)

    hdr = bytearray(header_size)
    hdr[0:4] = b"LASF"
    hdr[24], hdr[25] = 1, 4
    hdr[26:26 + 6] = b"tumseg"                       # system identifier
    hdr[58:58 + 10] = b"tumseg-las"                  # generating software
    struct.pack_into("<H", hdr, 94, header_size)
    struct.pack_into("<L", hdr, 96, point_offset)
    struct.pack_into("<L", hdr, 100, n_vlrs)
    hdr[104] = point_format
    struct.pack_into("<H", hdr, 105, dtype.itemsize)
    legacy = n if n < 2**32 and point_format <= 5 else 0
    struct.pack_into("<L", hdr, 107, legacy)
    struct.pack_into("<3d", hdr, 131, *scales)
    struct.pack_into("<3d", hdr, 155, *offsets)
    struct.pack_into("<6d", hdr, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])
    struct.pack_into("<Q", hdr, 247, n)              # 64-bit point count

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(vlr_blobs)
        f.write(records.tobytes())


def read_las_file_with_labels(path: str):
    """Convenience mirroring the reference's localfunctions.py:122-126:
    returns (coords [N,3] float64, labels [N] uint8)."""
    las = read_las(path)
    return las.xyz, las.classification.astype(np.uint8)
