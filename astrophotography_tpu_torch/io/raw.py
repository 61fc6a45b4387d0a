"""RAW container decode: DNG/TIFF, PGM, and FITS Bayer mosaics.

The reference delegates RAW decode to LibRaw via rawpy (reference
core/RawConv.py:5,82) and EXIF to exifread (:192-248).  This module is
the host-side replacement: it parses the container into a
:class:`RawImage` — uint16 mosaic, per-pixel color map, black levels,
white level, white balances, EXIF dict — which is exactly the state the
device kernels in ops/demosaic.py consume.

Supported containers:

* **DNG / TIFF** with uncompressed CFA data (Compression=1), including
  SubIFD layouts.  Lossless-JPEG-compressed DNG/CR2 (Compression=7)
  is decoded by the native C++ decoder when built (io/losslessjpeg),
  else raises a clear error.
* **PGM** (binary P5, 8/16-bit) — dcraw-style mosaic dumps.
* **FITS** mosaics with BAYERPAT/black-level/white-level keywords
  (this framework's own interchange format for synthetic data).

A minimal uncompressed-DNG *writer* is included so tests and users can
round-trip mosaics through a real container.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .fits import open_fits
from ..synth import bayer_color_map

# TIFF tag ids
_TAG_NEW_SUBFILE = 254
_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_MAKE = 271
_TAG_MODEL = 272
_TAG_STRIP_OFFSETS = 273
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_DATETIME = 306
_TAG_SUB_IFDS = 330
_TAG_CFA_REPEAT_DIM = 33421
_TAG_CFA_PATTERN_EXIF = 33422
_TAG_EXPOSURE_TIME = 33434
_TAG_FNUMBER = 33437
_TAG_EXIF_IFD = 34665
_TAG_ISO = 34855
_TAG_FOCAL_LENGTH = 37386
_TAG_CFA_PATTERN_DNG = 33422
_TAG_DNG_VERSION = 50706
_TAG_BLACK_LEVEL_REPEAT = 50713
_TAG_BLACK_LEVEL = 50714
_TAG_WHITE_LEVEL = 50717
_TAG_AS_SHOT_NEUTRAL = 50728
_TAG_CR2_SLICE = 50752  # Canon 0xc640: [n_extra_slices, width, last_width]

_PHOTOMETRIC_CFA = 32803

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}


@dataclasses.dataclass
class RawImage:
    """Decoded RAW frame: everything the conversion kernels need."""

    mosaic: np.ndarray            # (H, W) uint16 CFA samples
    color_map: np.ndarray         # (H, W) uint8, 0=R 1=G1 2=B 3=G2
    black_levels: np.ndarray      # (4,) float per color plane
    white_level: float
    camera_wb: np.ndarray         # (4,) multipliers, min-normalized to 1.0
    daylight_wb: np.ndarray       # (4,) multipliers, min-normalized to 1.0
    exif: Dict[str, Any]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.mosaic.shape


def normalize_wb(values) -> np.ndarray:
    """Normalize 4 white-balance factors so the minimum nonzero is 1.0.

    Reference _default_whitebalances (core/RawConv.py:130-161), including
    the 'last element zero means reuse G1' fixup.
    """
    vals = [float(v) for v in values]
    if len(vals) == 3:
        vals = [vals[0], vals[1], vals[2], vals[1]]
    if vals[3] == 0.0:
        vals[3] = vals[1]
    lo = min(v for v in vals if v > 0) if any(v > 0 for v in vals) else 1.0
    return np.array([v / lo if v > 0 else 1.0 for v in vals], dtype=np.float64)


# --------------------------------------------------------------------------
# TIFF / DNG reading
# --------------------------------------------------------------------------

class _Tiff:
    def __init__(self, data: bytes) -> None:
        self.data = data
        if data[:2] == b"II":
            self.end = "<"
        elif data[:2] == b"MM":
            self.end = ">"
        else:
            raise ValueError("not a TIFF/DNG file")
        magic, = struct.unpack(self.end + "H", data[2:4])
        if magic != 42:
            raise ValueError("bad TIFF magic")
        self.first_ifd, = struct.unpack(self.end + "I", data[4:8])

    def read_ifd(self, offset: int) -> Dict[int, Any]:
        d = self.data
        n, = struct.unpack(self.end + "H", d[offset:offset + 2])
        entries: Dict[int, Any] = {}
        for i in range(n):
            base = offset + 2 + 12 * i
            tag, typ, count = struct.unpack(self.end + "HHI", d[base:base + 8])
            size = _TYPE_SIZES.get(typ, 1) * count
            if size <= 4:
                raw = d[base + 8:base + 8 + size]
            else:
                ptr, = struct.unpack(self.end + "I", d[base + 8:base + 12])
                raw = d[ptr:ptr + size]
            entries[tag] = self._decode(typ, count, raw)
        next_ifd, = struct.unpack(self.end + "I",
                                  d[offset + 2 + 12 * n:offset + 6 + 12 * n])
        entries[-1] = next_ifd
        return entries

    def _decode(self, typ: int, count: int, raw: bytes) -> Any:
        e = self.end
        if typ == 2:  # ASCII
            return raw.split(b"\0")[0].decode("latin-1", "replace")
        if typ in (1, 6, 7):
            vals = list(raw[:count])
        elif typ == 3:
            vals = list(struct.unpack(e + f"{count}H", raw[:2 * count]))
        elif typ == 8:
            vals = list(struct.unpack(e + f"{count}h", raw[:2 * count]))
        elif typ == 4:
            vals = list(struct.unpack(e + f"{count}I", raw[:4 * count]))
        elif typ == 9:
            vals = list(struct.unpack(e + f"{count}i", raw[:4 * count]))
        elif typ in (5, 10):
            fmt = "I" if typ == 5 else "i"
            pairs = struct.unpack(e + f"{2 * count}{fmt}", raw[:8 * count])
            vals = [pairs[2 * i] / pairs[2 * i + 1] if pairs[2 * i + 1] else 0.0
                    for i in range(count)]
        elif typ == 11:
            vals = list(struct.unpack(e + f"{count}f", raw[:4 * count]))
        elif typ == 12:
            vals = list(struct.unpack(e + f"{count}d", raw[:8 * count]))
        else:
            vals = list(raw)
        return vals[0] if count == 1 else vals

    def all_ifds(self) -> List[Dict[int, Any]]:
        ifds = []
        seen = set()
        stack = [self.first_ifd]
        while stack:
            off = stack.pop()
            if not off or off in seen or off >= len(self.data):
                continue
            seen.add(off)
            ifd = self.read_ifd(off)
            ifds.append(ifd)
            if ifd.get(-1):
                stack.append(ifd[-1])
            subs = ifd.get(_TAG_SUB_IFDS)
            if subs is not None:
                subs = subs if isinstance(subs, list) else [subs]
                stack.extend(subs)
        return ifds


def _as_list(v) -> list:
    return v if isinstance(v, list) else [v]


def _cfa_color_map(shape, ifd) -> np.ndarray:
    """Color map from the CFAPattern tag (0=R,1=G,2=B); first G becomes
    G1, second G becomes G2 to match the 4-plane convention."""
    dims = _as_list(ifd.get(_TAG_CFA_REPEAT_DIM, [2, 2]))
    pat = _as_list(ifd.get(_TAG_CFA_PATTERN_DNG, [0, 1, 1, 2]))
    ph, pw = int(dims[0]), int(dims[1])
    pattern = np.array(pat, dtype=np.uint8).reshape(ph, pw)
    out = np.zeros((ph, pw), dtype=np.uint8)
    green_seen = False
    for y in range(ph):
        for x in range(pw):
            v = pattern[y, x]
            if v == 0:
                out[y, x] = 0
            elif v == 2:
                out[y, x] = 2
            else:
                out[y, x] = 3 if green_seen else 1
                green_seen = True
    h, w = shape
    return np.tile(out, ((h + ph - 1) // ph, (w + pw - 1) // pw))[:h, :w]


def _expand_black_levels(ifd, color_map) -> np.ndarray:
    """(4,) black level per color plane from BlackLevel/BlackLevelRepeatDim."""
    bl = ifd.get(_TAG_BLACK_LEVEL, 0)
    vals = [float(v) for v in _as_list(bl)]
    if len(vals) == 1:
        return np.full(4, vals[0])
    if len(vals) >= 4:
        # repeat-dim pattern maps positionally onto the CFA pattern
        dims = _as_list(ifd.get(_TAG_BLACK_LEVEL_REPEAT, [2, 2]))
        ph, pw = int(dims[0]), int(dims[1])
        grid = np.array(vals[: ph * pw]).reshape(ph, pw)
        out = np.zeros(4)
        seen = np.zeros(4, bool)
        for y in range(ph):
            for x in range(pw):
                c = int(color_map[y, x])
                if not seen[c]:
                    out[c] = grid[y, x]
                    seen[c] = True
        return out
    if len(vals) == 3:
        return np.array([vals[0], vals[1], vals[2], vals[1]])
    return np.full(4, vals[0])


def _collect_exif(tiff: _Tiff, ifds: List[Dict[int, Any]]) -> Dict[str, Any]:
    exif: Dict[str, Any] = {}
    named = {
        _TAG_MAKE: "Make",
        _TAG_MODEL: "Model",
        _TAG_DATETIME: "DateTime",
        _TAG_EXPOSURE_TIME: "ExposureTime",
        _TAG_FNUMBER: "FNumber",
        _TAG_ISO: "ISOSpeedRatings",
        _TAG_FOCAL_LENGTH: "FocalLength",
    }
    exif_ifds = list(ifds)
    for ifd in ifds:
        ptr = ifd.get(_TAG_EXIF_IFD)
        if ptr:
            try:
                exif_ifds.append(tiff.read_ifd(int(ptr)))
            except Exception:
                pass
    for ifd in exif_ifds:
        for tag, name in named.items():
            if tag in ifd and name not in exif:
                exif[name] = ifd[tag]
    return exif


def load_dng(path: str) -> RawImage:
    """Decode a DNG/TIFF CFA raw file.

    A truncated or bit-damaged container surfaces as ValueError (the
    struct/KeyError internals of the IFD walk never escape raw)."""
    with open(path, "rb") as fh:
        data = fh.read()
    try:
        return _load_dng_parsed(path, data)
    except (struct.error, KeyError, IndexError) as exc:
        raise ValueError(
            f"{path!r}: truncated or corrupt TIFF/DNG container "
            f"({type(exc).__name__}: {exc})") from exc


def _load_dng_parsed(path: str, data: bytes) -> RawImage:
    tiff = _Tiff(data)
    ifds = tiff.all_ifds()
    cfa_ifds = [i for i in ifds if i.get(_TAG_PHOTOMETRIC) == _PHOTOMETRIC_CFA]
    if not cfa_ifds:
        raise ValueError(f"{path!r}: no CFA image found (not a raw DNG/TIFF?)")
    ifd = max(cfa_ifds,
              key=lambda i: int(i.get(_TAG_WIDTH, 0)) * int(i.get(_TAG_LENGTH, 0)))
    w = int(ifd[_TAG_WIDTH])
    h = int(ifd[_TAG_LENGTH])
    bits = int(_as_list(ifd.get(_TAG_BITS, 16))[0])
    compression = int(ifd.get(_TAG_COMPRESSION, 1))
    offsets = [int(v) for v in _as_list(ifd[_TAG_STRIP_OFFSETS])]
    counts = [int(v) for v in _as_list(ifd.get(_TAG_STRIP_BYTE_COUNTS, [0]))]
    if compression == 1:
        payload = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
        if bits == 16:
            mosaic = np.frombuffer(payload, dtype=tiff.end + "u2",
                                   count=h * w).reshape(h, w)
            mosaic = mosaic.astype("u2")
        elif bits == 8:
            mosaic = np.frombuffer(payload, dtype="u1",
                                   count=h * w).reshape(h, w).astype("u2")
        else:
            mosaic = _unpack_bits(payload, bits, h, w)
    elif compression == 7:
        from .losslessjpeg import decode_lossless_jpeg  # native decoder
        payload = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
        mosaic = decode_lossless_jpeg(payload, h, w)
        slice_tag = ifd.get(_TAG_CR2_SLICE)
        if slice_tag is not None:
            mosaic = _unslice_cr2(mosaic, _as_list(slice_tag), h, w)
    else:
        raise ValueError(f"{path!r}: unsupported TIFF compression {compression}")
    color_map = _cfa_color_map((h, w), ifd)
    black = _expand_black_levels(ifd, color_map)
    white = float(ifd.get(_TAG_WHITE_LEVEL, (1 << bits) - 1))
    neutral = ifd.get(_TAG_AS_SHOT_NEUTRAL)
    if neutral is not None:
        nv = [float(v) for v in _as_list(neutral)]
        cam_wb = normalize_wb([1.0 / v if v else 0.0 for v in nv])
    else:
        cam_wb = np.ones(4)
    exif = _collect_exif(tiff, ifds)
    return RawImage(mosaic=mosaic, color_map=color_map, black_levels=black,
                    white_level=white, camera_wb=cam_wb,
                    daylight_wb=cam_wb.copy(), exif=exif)


def _unslice_cr2(decoded: np.ndarray, slice_tag, h: int, w: int) -> np.ndarray:
    """Undo Canon CR2 vertical slicing (tag 0xc640).

    The entropy-coded stream fills vertical slices left to right: the
    first ``n`` slices have ``width`` columns, the last has
    ``last_width``; within a slice samples are row-major.  The decoder
    returns the stream reshaped (h, w); re-gather columns per slice.
    """
    n_extra, width, last_width = (int(v) for v in slice_tag[:3])
    widths = [width] * n_extra + [last_width]
    if sum(widths) != w:
        raise ValueError(
            f"CR2 slice widths {widths} do not sum to width {w}")
    flat = decoded.reshape(-1)
    out = np.empty((h, w), dtype=decoded.dtype)
    pos = 0
    col = 0
    for ws in widths:
        block = flat[pos:pos + h * ws].reshape(h, ws)
        out[:, col:col + ws] = block
        pos += h * ws
        col += ws
    return out


def _unpack_bits(payload: bytes, bits: int, h: int, w: int) -> np.ndarray:
    """Unpack big-endian bit-packed samples (e.g. 12-bit DNG)."""
    arr = np.frombuffer(payload, dtype=np.uint8)
    total = h * w
    out = np.zeros(total, dtype=np.uint16)
    bitpos = np.arange(total, dtype=np.int64) * bits
    for b in range(bits):
        idx = bitpos + b
        byte = arr[idx >> 3]
        bit = (byte >> (7 - (idx & 7))) & 1
        out |= bit.astype(np.uint16) << (bits - 1 - b)
    return out.reshape(h, w)


# --------------------------------------------------------------------------
# DNG writing — round-trip utility + synthetic test input
# --------------------------------------------------------------------------

def write_dng(
    path: str,
    mosaic: np.ndarray,
    black_levels=(0, 0, 0, 0),
    white_level: int = 65535,
    camera_wb=(1.0, 1.0, 1.0, 1.0),
    exif: Optional[Dict[str, Any]] = None,
    compression: int = 1,
    strip_payload: Optional[bytes] = None,
) -> None:
    """Write a minimal RGGB DNG (single IFD, one strip).

    ``compression`` 1 writes the mosaic uncompressed; 7 lossless-JPEG
    encodes it (io/losslessjpeg), producing camera-style compressed
    input.  ``strip_payload`` supplies pre-encoded compression-7 strip
    bytes so callers writing many identical-payload files (benchmarks)
    skip re-encoding.
    """
    mosaic = np.ascontiguousarray(mosaic, dtype="<u2")
    h, w = mosaic.shape
    if compression == 7:
        if strip_payload is None:
            from .losslessjpeg import encode_lossless_jpeg
            strip_payload = encode_lossless_jpeg(mosaic)
        strip_bytes = strip_payload
    elif compression == 1:
        strip_bytes = mosaic.tobytes()
    else:
        raise ValueError(f"compression must be 1 or 7, got {compression}")
    exif = exif or {}
    # AsShotNeutral = 1/wb for RGB
    wb = [float(x) for x in camera_wb]
    neutral = [1.0 / wb[0] if wb[0] else 1.0, 1.0 / wb[1] if wb[1] else 1.0,
               1.0 / wb[2] if wb[2] else 1.0]

    entries = []  # (tag, type, count, value_bytes or offset placeholder)
    extra: List[bytes] = []

    def rat(x: float, denom: int = 1000000) -> bytes:
        return struct.pack("<II", int(round(x * denom)), denom)

    def add(tag, typ, count, packed: bytes):
        entries.append([tag, typ, count, packed])

    header_size = 8
    # IFD: count(2) + n*12 + next(4); data area after
    def build(num_entries: int) -> int:
        return header_size + 2 + num_entries * 12 + 4

    add(_TAG_NEW_SUBFILE, 4, 1, struct.pack("<I", 0))
    add(_TAG_WIDTH, 4, 1, struct.pack("<I", w))
    add(_TAG_LENGTH, 4, 1, struct.pack("<I", h))
    add(_TAG_BITS, 3, 1, struct.pack("<HH", 16, 0))
    add(_TAG_COMPRESSION, 3, 1, struct.pack("<HH", compression, 0))
    add(_TAG_PHOTOMETRIC, 3, 1, struct.pack("<HH", _PHOTOMETRIC_CFA, 0))
    if "Make" in exif:
        add(_TAG_MAKE, 2, 0, exif["Make"].encode("latin-1") + b"\0")
    if "Model" in exif:
        add(_TAG_MODEL, 2, 0, exif["Model"].encode("latin-1") + b"\0")
    add(_TAG_STRIP_OFFSETS, 4, 1, b"STRP")  # patched later
    add(_TAG_ROWS_PER_STRIP, 4, 1, struct.pack("<I", h))
    add(_TAG_STRIP_BYTE_COUNTS, 4, 1, struct.pack("<I", len(strip_bytes)))
    if "DateTime" in exif:
        add(_TAG_DATETIME, 2, 0, exif["DateTime"].encode("latin-1") + b"\0")
    add(_TAG_CFA_REPEAT_DIM, 3, 2, struct.pack("<HH", 2, 2))
    add(_TAG_CFA_PATTERN_DNG, 1, 4, bytes([0, 1, 1, 2]))
    if "ExposureTime" in exif:
        add(_TAG_EXPOSURE_TIME, 5, 1, rat(float(exif["ExposureTime"])))
    if "FNumber" in exif:
        add(_TAG_FNUMBER, 5, 1, rat(float(exif["FNumber"])))
    if "ISOSpeedRatings" in exif:
        add(_TAG_ISO, 3, 1, struct.pack("<HH", int(exif["ISOSpeedRatings"]), 0))
    if "FocalLength" in exif:
        add(_TAG_FOCAL_LENGTH, 5, 1, rat(float(exif["FocalLength"])))
    add(_TAG_DNG_VERSION, 1, 4, bytes([1, 4, 0, 0]))
    add(_TAG_BLACK_LEVEL, 5, 4,
        b"".join(rat(float(b), 1) for b in
                 (black_levels[0], black_levels[1], black_levels[3],
                  black_levels[2])))
    add(_TAG_WHITE_LEVEL, 4, 1, struct.pack("<I", int(white_level)))
    add(_TAG_AS_SHOT_NEUTRAL, 5, 3, b"".join(rat(v) for v in neutral))

    entries.sort(key=lambda e: e[0])
    ifd_off = header_size
    data_off = build(len(entries))
    out_entries = []
    for tag, typ, count, packed in entries:
        if typ == 2:
            count = len(packed)
        elif count == 0:
            count = len(packed)
        size = len(packed)
        if tag == _TAG_STRIP_OFFSETS:
            out_entries.append((tag, typ, 1, None))  # patch later
            continue
        if size <= 4:
            out_entries.append((tag, typ, count, packed.ljust(4, b"\0")))
        else:
            out_entries.append((tag, typ, count,
                                struct.pack("<I", data_off + sum(len(x) for x in extra))))
            extra.append(packed)
    strip_offset = data_off + sum(len(x) for x in extra)
    buf = bytearray()
    buf += b"II*\x00" + struct.pack("<I", ifd_off)
    buf += struct.pack("<H", len(out_entries))
    for tag, typ, count, val in out_entries:
        if val is None:
            val = struct.pack("<I", strip_offset)
        buf += struct.pack("<HHI", tag, typ, count) + val
    buf += struct.pack("<I", 0)  # next IFD
    for blob in extra:
        buf += blob
    assert len(buf) == strip_offset
    buf += strip_bytes
    with open(path, "wb") as fh:
        fh.write(bytes(buf))


# --------------------------------------------------------------------------
# PGM + FITS mosaics
# --------------------------------------------------------------------------

def load_pgm(path: str, pattern: str = "RGGB") -> RawImage:
    """Binary PGM (P5) mosaic, as produced by ``dcraw -D -4``."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path!r} is not a binary PGM file")
    fields: List[bytes] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos] in b" \t\r\n":
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos] not in b" \t\r\n":
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    w, h, maxval = (int(f) for f in fields)
    dtype = ">u2" if maxval > 255 else "u1"
    mosaic = np.frombuffer(data, dtype=dtype, count=h * w,
                           offset=pos).reshape(h, w).astype("u2")
    return RawImage(
        mosaic=mosaic,
        color_map=_pattern_map((h, w), pattern),
        black_levels=np.zeros(4),
        white_level=float(maxval),
        camera_wb=np.ones(4),
        daylight_wb=np.ones(4),
        exif={},
    )


_PATTERN_COLORS = {"R": 0, "B": 2}


def _pattern_map(shape, pattern: str) -> np.ndarray:
    pattern = pattern.upper()
    if len(pattern) != 4:
        raise ValueError(f"Bayer pattern must have 4 letters, got {pattern!r}")
    vals = []
    green_seen = False
    for ch in pattern:
        if ch == "G":
            vals.append(3 if green_seen else 1)
            green_seen = True
        else:
            vals.append(_PATTERN_COLORS[ch])
    pat = np.array(vals, dtype=np.uint8).reshape(2, 2)
    return bayer_color_map(shape, pat)


def load_fits_mosaic(path: str) -> RawImage:
    """FITS mosaic with BAYERPAT + optional BLKLEV*/WHITELEV/WB_* keys."""
    hdus = open_fits(path)
    hdu = hdus[0]
    if hdu.data is None:
        for cand in hdus:
            if getattr(cand, "data", None) is not None:
                hdu = cand
                break
    data = np.asarray(hdu.data)
    if data.ndim != 2:
        raise ValueError(f"{path!r}: mosaic must be 2-D")
    hdr = hdu.header
    pattern = str(hdr.get("BAYERPAT", "RGGB")).strip()
    blacks = np.array([float(hdr.get(f"BLKLEV{n}", hdr.get("BLKLEVEL", 0)))
                       for n in ("R", "G1", "B", "G2")])
    wb = normalize_wb([float(hdr.get(f"WB_{n}", 1.0))
                       for n in ("R", "G1", "B", "G2")])
    exif = {}
    for key, name in (("EXPTIME", "ExposureTime"), ("ISONUM", "ISOSpeedRatings"),
                      ("INSTRUME", "Model"), ("FOCALLEN", "FocalLength"),
                      ("DATE-OBS", "DateTime")):
        if key in hdr:
            exif[name] = hdr[key]
    return RawImage(
        mosaic=data.astype(np.uint16),
        color_map=_pattern_map(data.shape, pattern),
        black_levels=blacks,
        white_level=float(hdr.get("WHITELEV", 65535)),
        camera_wb=wb,
        daylight_wb=wb.copy(),
        exif=exif,
    )


def load_rawpy(path: str) -> RawImage:
    """Optional rawpy/LibRaw loader for camera formats outside the
    native parsers (CR3/NEF/ARW...).  Only used when rawpy happens to
    be installed; the native DNG/CR2 path needs no third-party code."""
    import rawpy  # optional dependency

    with rawpy.imread(path) as raw:
        mosaic = np.ascontiguousarray(raw.raw_image_visible).astype(np.uint16)
        color_map = np.ascontiguousarray(raw.raw_colors_visible).astype(
            np.uint8)
        blacks = np.asarray(raw.black_level_per_channel, dtype=np.float64)
        cam_wb = normalize_wb(list(raw.camera_whitebalance))
        day_wb = normalize_wb(list(raw.daylight_whitebalance))
        white = float(raw.white_level)
    return RawImage(mosaic=mosaic, color_map=color_map, black_levels=blacks,
                    white_level=white, camera_wb=cam_wb, daylight_wb=day_wb,
                    exif={})


def load_raw(path: str, pattern: str = "RGGB") -> RawImage:
    """Load any supported RAW container by extension/magic."""
    lower = path.lower()
    if lower.endswith((".fits", ".fit", ".fits.gz", ".ftz")):
        return load_fits_mosaic(path)
    if lower.endswith(".pgm"):
        return load_pgm(path, pattern)
    if lower.endswith((".dng", ".tif", ".tiff", ".cr2")):
        return load_dng(path)
    if lower.endswith((".cr3", ".nef", ".arw", ".orf", ".raf", ".rw2")):
        try:
            return load_rawpy(path)
        except ImportError as exc:
            raise ValueError(
                f"{path!r}: this camera format needs the optional rawpy "
                "package (native support covers DNG/TIFF/CR2/PGM/FITS)"
            ) from exc
    # fall back on magic sniffing
    with open(path, "rb") as fh:
        magic = fh.read(6)
    if magic[:2] in (b"II", b"MM"):
        return load_dng(path)
    if magic[:2] == b"P5":
        return load_pgm(path, pattern)
    if magic[:6] == b"SIMPLE":
        return load_fits_mosaic(path)
    raise ValueError(f"unrecognized RAW container: {path!r}")
