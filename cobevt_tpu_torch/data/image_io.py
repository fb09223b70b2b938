"""Image files: ``cv2.imread`` / ``cv2.imwrite`` where OpenCV is installed,
else a PNG codec on the standard library's ``zlib`` and numpy.

The codec reads 8-bit grayscale, BGR and BGRA PNGs that are not interlaced,
with all five row filters, and writes them with filter 0 (none).  Arrays are
in OpenCV's channel order: ``imread`` returns what ``cv2.imread`` returns
for these files, (H, W, 3) BGR (a grayscale file repeated over the three
channels, an alpha channel dropped), ``decode_png`` the stored channels;
``imwrite`` takes (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA.  Any other
file raises: a file that exists is decoded or refused, never read as zeros.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types the codec takes
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray,
              bpp: int) -> np.ndarray:
    """One reconstructed scanline (PNG spec section 9.2)."""
    if kind == 0:
        return line
    if kind == 1:       # Sub: a running sum of each channel along the row
        sums = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
        return (sums & 0xFF).astype(np.uint8).reshape(-1)
    if kind == 2:       # Up
        return line + prior
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG row filter {kind}")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:   # Average
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        else:           # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: the PNG codec reads 8-bit gray, RGB and RGBA files "
            f"without interlacing, not bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    stride = width * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} pixel bytes for "
                         f"{height} rows of {stride}")
    rows = raw.reshape(height, stride + 1)
    img = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        prior = img[r] = _unfilter(int(rows[r, 0]), rows[r, 1:], prior, ch)
    img = img.reshape(height, width, ch)
    if ch == 1:
        return img[..., 0]
    # RGB(A) -> BGR(A)
    order = [2, 1, 0] + ([3] if ch == 4 else [])
    return np.ascontiguousarray(img[..., order])


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 -> PNG bytes,
    every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"the PNG codec writes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"cannot write an image of shape {img.shape}")
    height, width, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    if ch > 1:
        img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
    rows = np.zeros((height, width * ch + 1), np.uint8)
    rows[:, 1:] = img.reshape(height, width * ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype,
                                       0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) +
            chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)``.  Raises for a file that is absent or cannot be
    decoded."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        return img
    with open(path, "rb") as f:
        img = decode_png(f.read(), path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a PNG path.  Raises on failure."""
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise OSError(f"cv2 could not write {path}")
        return
    if not path.lower().endswith(".png"):
        raise ValueError(f"without cv2 only PNG files are written: {path}")
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
