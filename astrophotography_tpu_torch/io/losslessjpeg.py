"""Lossless JPEG (SOF3) codec: native C++ entropy stages + numpy.

The decoder (native/losslessjpeg.cpp, built at first use with g++ into
``build/torch_native/`` of the checkout and loaded via ctypes; the
library is named by a hash of its source, so an edit rebuilds it)
provides the CR2/compressed-DNG decode capability the reference gets
from LibRaw (reference core/RawConv.py:82).  The encoder runs
prediction/categorization vectorized in numpy and the entropy pack in
the same native library (byte-identical pure-Python fallbacks cover
toolchain-less hosts).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logger import get_logger

logger = get_logger("io.losslessjpeg")

_PKG_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC_PATH = os.path.join(_PKG_DIR, "native", "losslessjpeg.cpp")
#: where the library is built: beside the CUDA kernels' build directory
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _so_path() -> str:
    """The library's path, keyed by a hash of the source and the flags."""
    with open(_SRC_PATH, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"liblosslessjpeg_{h.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: a second process loading
    # at the same moment never sees a half-written library
    tmp = f"{so_path}.tmp{os.getpid()}_{threading.get_ident()}"
    cmd = ["g++", *_CXX_FLAGS, "-o", tmp, _SRC_PATH]
    logger.info(f"Building native lossless-JPEG codec: {' '.join(cmd)}")
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def native_loaded() -> bool:
    """Whether the native library is loaded in this process."""
    return _lib is not None


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        return _load_locked()


def _load_locked() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so_path = _so_path()
    if not os.path.exists(so_path):
        _build(so_path)
    lib = ctypes.CDLL(so_path)
    lib.lljpeg_decode.restype = ctypes.c_int
    lib.lljpeg_entropy_encode.restype = ctypes.c_long
    lib.lljpeg_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.lljpeg_entropy_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t]
    _lib = lib
    return lib


def _frame_geometry(payload: bytes) -> Optional[Tuple[int, int, int]]:
    """(height, width, components) of the SOF3 frame header, found by
    the same marker walk as the native decoder's, or None when the walk
    ends without a usable frame header and scan (the native decoder then
    names the fault)."""
    size = len(payload)
    if size < 4 or payload[0] != 0xFF or payload[1] != 0xD8:
        return None
    pos = 2
    geom = None
    while pos + 4 <= size:
        if payload[pos] != 0xFF:
            pos += 1
            continue
        marker = payload[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            return None
        seglen = (payload[pos + 2] << 8) | payload[pos + 3]
        if seglen < 2 or pos + 2 + seglen > size:
            return None
        if marker in (0xC3, 0xC7, 0xCB, 0xCF):
            if seglen < 8:
                return None
            seg = payload[pos + 4:pos + 10]
            geom = ((seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5])
        elif marker == 0xDA:
            if geom is None or 0 in geom:
                return None
            return geom
        pos += 2 + seglen
    return None


def decode_lossless_jpeg(payload: bytes, height: int, width: int) -> np.ndarray:
    """Decode an SOF3 stream to an (height, width) uint16 mosaic.

    ``height``/``width`` are the sensor geometry (e.g. from the TIFF
    IFD); the JPEG frame may pack multiple components per sample
    (jpeg_width * ncomp == width), which are re-interleaved along rows.
    """
    if not 0 < height * width <= (1 << 31):
        # a corrupt container IFD can claim absurd sensor geometry;
        # refuse before allocating the claimed buffer
        raise ValueError(
            f"implausible sensor geometry {height}x{width}")
    # the claimed geometry is held against the stream itself BEFORE the
    # output buffer is allocated: the frame header must describe exactly
    # height * width samples, and every sample costs at least one bit of
    # entropy-coded data, so a short payload cannot fill a large frame
    geom = _frame_geometry(payload)
    if geom is not None:
        jhv, jwv, jcv = geom
        if jhv * jwv * jcv != height * width:
            raise ValueError(
                f"decoded geometry {jhv}x{jwv}x{jcv} does not match "
                f"expected {height}x{width}")
        if height * width > 8 * len(payload):
            raise ValueError(
                f"lossless JPEG payload of {len(payload)} bytes cannot "
                f"hold {height}x{width} samples")
    lib = _load()
    buf = np.frombuffer(payload, dtype=np.uint8)
    # a stream whose headers this module could not walk gets a token
    # buffer: the native parser then reports what is wrong with it
    out = np.zeros((height * width if geom is not None else 0) + 16,
                   dtype=np.uint16)
    jw = ctypes.c_int()
    jh = ctypes.c_int()
    jc = ctypes.c_int()
    rc = lib.lljpeg_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
        ctypes.byref(jw), ctypes.byref(jh), ctypes.byref(jc))
    if rc != 0:
        detail = {-1: "no SOI marker", -2: "bad SOF fields",
                  -3: "EOI before scan", -4: "incomplete headers",
                  -5: "frame larger than expected geometry",
                  -6: "missing/corrupt Huffman table",
                  -7: "segment overruns payload",
                  -8: "truncated scan data",
                  -9: "invalid Huffman code in scan"}.get(rc, "")
        raise ValueError(
            f"lossless JPEG decode failed (code {rc}: {detail})")
    jwv, jhv, jcv = jw.value, jh.value, jc.value
    n = jhv * jwv * jcv
    data = out[:n].reshape(jhv, jwv * jcv)
    if (jhv, jwv * jcv) != (height, width):
        if n == height * width:
            data = data.reshape(height, width)
        else:
            raise ValueError(
                f"decoded geometry {jhv}x{jwv}x{jcv} does not match "
                f"expected {height}x{width}")
    return np.ascontiguousarray(data)


# --------------------------------------------------------------------------
# Encoder (Python): SOF3, predictor 1, one Huffman table
# --------------------------------------------------------------------------

def _build_huffman_spec(max_ssss: int) -> Tuple[List[int], List[int]]:
    """All categories at code length 5: trivially a valid prefix code
    for up to 32 symbols (Kraft sum n/32 <= 1).  Compression is modest;
    the encoder exists for round-trip tests, not for ratio."""
    symbols = list(range(max_ssss + 1))
    if len(symbols) > 32:
        raise ValueError("too many ssss categories")
    counts = [0] * 16
    counts[4] = len(symbols)
    return counts, symbols


class _BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc = 0
                self.nbits = 0

    def flush(self) -> bytes:
        if self.nbits:
            pad = 8 - self.nbits
            self.acc = (self.acc << pad) | ((1 << pad) - 1)
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def _canonical_codes(counts: List[int], symbols: List[int]):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_PRED_FUNCS = {
    1: lambda Ra, Rb, Rc: Ra,
    2: lambda Ra, Rb, Rc: Rb,
    3: lambda Ra, Rb, Rc: Rc,
    4: lambda Ra, Rb, Rc: Ra + Rb - Rc,
    5: lambda Ra, Rb, Rc: Ra + ((Rb - Rc) >> 1),
    6: lambda Ra, Rb, Rc: Rb + ((Ra - Rc) >> 1),
    7: lambda Ra, Rb, Rc: (Ra + Rb) >> 1,
}


def _predict_diffs_general(samples: np.ndarray, precision: int,
                           predictor: int,
                           restart_interval: int) -> List[np.ndarray]:
    """Per-restart-interval difference lists with ITU-T81 H.2 prediction:
    the first line from the scan start / each restart origin uses the 1-D
    left predictor with a defaulted first sample; other rows start from
    Rb and use the selected predictor elsewhere."""
    h, jw, ncomp = samples.shape
    default = 1 << (precision - 1)
    pred_fn = _PRED_FUNCS[predictor]
    intervals: List[np.ndarray] = []
    cur: List[int] = []
    restart_row, restart_col = 0, 0
    mcu = 0
    for row in range(h):
        for col in range(jw):
            for c in range(ncomp):
                if row == restart_row and col >= restart_col:
                    pred = default if col == restart_col else int(
                        samples[row, col - 1, c])
                elif col == 0:
                    pred = int(samples[row - 1, 0, c])
                else:
                    pred = pred_fn(int(samples[row, col - 1, c]),
                                   int(samples[row - 1, col, c]),
                                   int(samples[row - 1, col - 1, c]))
                cur.append(int(samples[row, col, c]) - pred)
            if restart_interval:
                mcu += 1
                if mcu == restart_interval and not (row == h - 1
                                                    and col == jw - 1):
                    intervals.append(np.asarray(cur, np.int64))
                    cur = []
                    mcu = 0
                    restart_row = row + 1 if col == jw - 1 else row
                    restart_col = 0 if col == jw - 1 else col + 1
    intervals.append(np.asarray(cur, np.int64))
    return intervals


_BITLEN = None


def _bitlen_lut() -> np.ndarray:
    """uint8[65536] bit lengths (the ssss category of a magnitude)."""
    global _BITLEN
    if _BITLEN is None:
        n = np.arange(65536, dtype=np.uint32)
        lut = np.zeros(65536, np.uint8)
        for b in range(1, 17):
            lut[(n >= (1 << (b - 1))) & (n < (1 << b))] = b
        _BITLEN = lut
    return _BITLEN


def _entropy_encode_vectorized(flat: np.ndarray, ssss: np.ndarray,
                               codes) -> bytes:
    """Fast entropy coder: byte-identical to the per-sample _BitWriter
    loop (same MSB-first packing, 0xFF byte stuffing, and 1-bit flush
    padding).  Uses the native C++ packer when the library builds
    (~500x the Python loop); falls back to a numpy scatter-OR packer."""
    code_arr = np.zeros(17, np.uint32)
    len_arr = np.zeros(17, np.int64)
    for sym, (code, length) in codes.items():
        code_arr[sym] = code
        len_arr[sym] = length
    try:
        lib = _load()
        diffs32 = np.ascontiguousarray(flat, np.int32)
        ssss32 = np.ascontiguousarray(ssss, np.int32)
        cap = flat.size * 8 + 16
        out = np.empty(cap, np.uint8)
        nw = lib.lljpeg_entropy_encode(
            diffs32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ssss32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_size_t(flat.size),
            code_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len_arr.astype(np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_size_t(cap))
        if nw > 0:
            return out[:nw].tobytes()
    except Exception:  # no toolchain / load failure: numpy fallback
        pass
    s = ssss.astype(np.int64)
    has_extra = (s > 0) & (s < 16)
    s_extra = np.where(has_extra, s, 0)
    # extra-bit value: d >= 0 -> d, else d + 2^s - 1, masked to s bits
    extra = np.where(flat >= 0, flat, flat + (1 << s_extra) - 1)
    extra = (extra & ((1 << s_extra) - 1)).astype(np.uint64)
    value = (code_arr[s].astype(np.uint64) << s_extra.astype(np.uint64)) \
        | extra
    nbits = len_arr[s] + s_extra                      # <= 31 bits/sample
    end = np.cumsum(nbits)
    start = end - nbits
    total_bits = int(end[-1])
    nbytes = (total_bits + 7) >> 3
    buf = np.zeros(nbytes + 8, np.uint8)
    byte_idx = (start >> 3).astype(np.int64)
    bit_in_byte = (start & 7).astype(np.uint64)
    # place each sample's bits MSB-first in a 64-bit window at byte_idx
    shifted = value << (np.uint64(64) - bit_in_byte - nbits.astype(np.uint64))
    for k in range(6):  # 7 + 31 bits spans at most 5 bytes; 6 for margin
        np.bitwise_or.at(buf, byte_idx + k,
                         (shifted >> np.uint64(56 - 8 * k)).astype(np.uint8))
    pad = (8 - (total_bits & 7)) & 7
    if pad:
        buf[nbytes - 1] |= (1 << pad) - 1             # flush pads with 1s
    out = buf[:nbytes]
    stuff = np.flatnonzero(out == 0xFF)               # byte stuffing
    if stuff.size:
        out = np.insert(out, stuff + 1, 0)
    return out.tobytes()


def encode_lossless_jpeg(mosaic: np.ndarray, precision: int = 16,
                         ncomp: int = 1, predictor: int = 1,
                         restart_interval: int = 0) -> bytes:
    """Encode an (H, W) uint16 array as lossless JPEG.

    ``ncomp`` splits each row into interleaved components (CR2-style
    2/4-component layouts); W must be divisible by ncomp.  ``predictor``
    selects the ITU-T81 H.1 prediction mode 1-7; ``restart_interval``
    (in MCUs/samples) inserts DRI/RSTn markers with spec-conformant
    prediction resets — mainly for decoder tests.
    """
    mosaic = np.ascontiguousarray(mosaic, dtype=np.uint16)
    h, w = mosaic.shape
    if w % ncomp:
        raise ValueError(f"width {w} not divisible by ncomp {ncomp}")
    if predictor not in _PRED_FUNCS:
        raise ValueError(f"predictor must be 1-7, got {predictor}")
    jw = w // ncomp
    samples = mosaic.reshape(h, jw, ncomp).astype(np.int32)

    if predictor == 1 and not restart_interval:
        # vectorized fast path (left; above for col 0; default at origin)
        diffs = np.zeros_like(samples)
        diffs[0, 0, :] = samples[0, 0, :] - (1 << (precision - 1))
        diffs[0, 1:, :] = samples[0, 1:, :] - samples[0, :-1, :]
        diffs[1:, 0, :] = samples[1:, 0, :] - samples[:-1, 0, :]
        diffs[1:, 1:, :] = samples[1:, 1:, :] - samples[1:, :-1, :]
        intervals = [diffs.reshape(-1)]
    else:
        intervals = _predict_diffs_general(samples, precision, predictor,
                                           restart_interval)

    # lossless JPEG differences are modulo 2^16, mapped to
    # [-32768, 32767]; exactly -32768 is the bit-less ssss=16 category
    def to_ssss(flat):
        # int32 throughout; & 65535 == % 65536 on two's complement
        flat = (((flat.astype(np.int32) + 32768) & 65535) - 32768)
        ssss = _bitlen_lut()[np.abs(flat)].astype(np.int32)
        return flat, ssss

    mapped = [to_ssss(iv) for iv in intervals]
    max_ssss = max((int(s.max(initial=0)) for _, s in mapped), default=0)

    counts, symbols = _build_huffman_spec(max(max_ssss, 1))
    codes = _canonical_codes(counts, symbols)

    chunks = []
    for flat, ssss in mapped:
        if flat.size >= 4096:
            chunks.append(_entropy_encode_vectorized(flat, ssss, codes))
            continue
        bw = _BitWriter()
        for d, s in zip(flat.tolist(), ssss.tolist()):
            code, length = codes[s]
            bw.put(code, length)
            if s and s < 16:  # ssss=16 (diff -32768) carries no extra bits
                v = d if d >= 0 else d + (1 << s) - 1
                bw.put(v & ((1 << s) - 1), s)
        chunks.append(bw.flush())
    entropy = chunks[0]
    for i, chunk in enumerate(chunks[1:]):
        entropy += bytes([0xFF, 0xD0 + (i % 8)]) + chunk

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload

    dht = bytes([0x00]) + bytes(counts) + bytes(symbols)
    sof_comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    sof = bytes([precision]) + h.to_bytes(2, "big") + jw.to_bytes(2, "big") \
        + bytes([ncomp]) + sof_comps
    sos_comps = b"".join(bytes([i + 1, 0x00]) for i in range(ncomp))
    sos = bytes([ncomp]) + sos_comps + bytes([predictor, 0, 0])  # pt 0
    dri = seg(0xDD, restart_interval.to_bytes(2, "big")) \
        if restart_interval else b""

    return (b"\xFF\xD8" + seg(0xC4, dht) + dri + seg(0xC3, sof)
            + seg(0xDA, sos) + entropy + b"\xFF\xD9")
