"""Image files: ``cv2.imread`` / ``cv2.imwrite`` where OpenCV is installed,
else a PNG codec on the standard library's ``zlib`` and numpy; and the
antialiased bilinear resize of PIL on ``F.interpolate``.

The codec reads 8-bit grayscale, BGR and BGRA PNGs and 16-bit grayscale
PNGs (big-endian samples, as PIL writes an int32 label image) that are not
interlaced, with all five row filters, and writes them with filter 0 (none).
Arrays are in OpenCV's channel order: ``imread`` returns what ``cv2.imread``
returns for 8-bit files, (H, W, 3) BGR (a grayscale file repeated over the
three channels, an alpha channel dropped); ``imread_unchanged`` and
``decode_png`` the stored channels and dtype (uint16 for a 16-bit file), as
``cv2.IMREAD_UNCHANGED`` does; ``imwrite`` and ``write_png`` take (H, W)
gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8, or (H, W) uint16.  Any other
file raises: a file that exists is decoded or refused, never read as zeros.

Rows filtered with Average or Paeth depend on their left neighbour, so they
are rebuilt one anti-diagonal of pixels at a time across all rows (H + W
vector steps); the other filters take one vector step a row.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types the codec takes
_CHANNELS = {0: 1, 2: 3, 6: 4}
# (bit depth, colour type) the codec reads
_READS = {(8, 0), (8, 2), (8, 6), (16, 0)}


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


def _unfilter_rows(kinds: np.ndarray, rows: np.ndarray, prior: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Rows filtered with None, Sub or Up (PNG spec section 9.2), one vector
    step a row, after ``prior`` (the reconstructed row above the first)."""
    out = np.empty_like(rows)
    for r, kind in enumerate(kinds):
        line = rows[r]
        if kind == 0:
            out[r] = line
        elif kind == 1:     # Sub: a running sum of each channel along the row
            sums = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8)
            out[r] = sums.reshape(-1)
        elif kind == 2:     # Up
            out[r] = line + prior
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        prior = out[r]
    return out


def _unfilter_diagonal(kinds: np.ndarray, rows: np.ndarray,
                       prior: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of any filter, one anti-diagonal of pixels at a time: pixel (r,
    j) needs (r, j - 1), (r - 1, j) and (r - 1, j - 1), all on earlier
    diagonals.  ``diag[r + j + 2, r + 1]`` holds pixel (r, j); row 0 of
    every diagonal is ``prior``, and entries off the image stay 0, which is
    what the filters read left of the first pixel."""
    n, stride = rows.shape
    width = stride // bpp
    if np.any(kinds > 4):
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    r = np.arange(n)[:, None]
    j = np.arange(width)[None, :]
    skew = (r + j + 2, r + 1)
    raw = np.zeros((n + width + 1, n + 1, bpp), np.int16)
    raw[skew] = rows.reshape(n, width, bpp)
    diag = np.zeros_like(raw)
    diag[np.arange(width) + 1, 0] = prior.reshape(width, bpp)
    # the predictor of row r is a * sub + b * up + (a + b) // 2 * avg +
    # paeth(a, b, c) * paeth_row; terms no row uses are skipped
    masks = [(kinds == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4)]
    used = [bool(m.any()) for m in masks]
    sub, up, avg, paeth_row = masks
    for t in range(2, n + width + 1):
        lo, hi = max(0, t - 1 - width), min(n, t - 1)   # rows on diagonal t
        a = diag[t - 1, lo + 1:hi + 1]                  # left
        b = diag[t - 1, lo:hi]                          # up
        pred = raw[t, lo + 1:hi + 1].copy()
        if used[0]:
            pred += a * sub[lo:hi]
        if used[1]:
            pred += b * up[lo:hi]
        if used[2]:
            pred += ((a + b) >> 1) * avg[lo:hi]
        if used[3]:
            c = diag[t - 2, lo:hi]                      # up-left
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            pick = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
            pred += pick * paeth_row[lo:hi]
        np.bitwise_and(pred, 0xFF, out=diag[t, lo + 1:hi + 1])
    return diag[skew].astype(np.uint8).reshape(n, stride)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """All scanlines of an image: (H, 1 + stride) filtered -> (H, stride).
    The rows from the first Average or Paeth row to the last take the
    diagonal walk; the rest one step a row."""
    kinds = rows[:, 0]
    data = rows[:, 1:]
    img = np.empty_like(data)
    prior = np.zeros(data.shape[1], np.uint8)
    slow = np.flatnonzero((kinds == 3) | (kinds == 4))
    first, last = ((slow[0], slow[-1] + 1) if slow.size
                   else (len(kinds), len(kinds)))
    for lo, hi, fn in ((0, first, _unfilter_rows),
                       (first, last, _unfilter_diagonal),
                       (last, len(kinds), _unfilter_rows)):
        if hi > lo:
            img[lo:hi] = fn(kinds[lo:hi], data[lo:hi], prior, bpp)
            prior = img[hi - 1]
    return img


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8, or
    (H, W) uint16 for a 16-bit grayscale file."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if (depth, ctype) not in _READS or interlace:
        raise ValueError(
            f"{path}: the PNG codec reads 8-bit gray, RGB and RGBA and 16-bit "
            f"gray files without interlacing, not bit depth {depth}, colour "
            f"type {ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} pixel bytes for "
                         f"{height} rows of {stride}")
    img = _unfilter(raw.reshape(height, stride + 1), bpp)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(height, width)
    img = img.reshape(height, width, ch)
    if ch == 1:
        return img[..., 0]
    # RGB(A) -> BGR(A)
    order = [2, 1, 0] + ([3] if ch == 4 else [])
    return np.ascontiguousarray(img[..., order])


def _filter_rows(data: np.ndarray, bpp: int, row_filter) -> np.ndarray:
    """(H, stride) bytes -> (H, 1 + stride) filtered scanlines: every row
    with filter ``row_filter`` (0-4), or with ``"adaptive"`` the filter
    whose bytes, read as signed, have the least absolute sum (libpng's and
    PIL's heuristic)."""
    x = data.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (0, a, b, (a + b) >> 1, paeth)
    kinds = range(5) if row_filter == "adaptive" else (int(row_filter),)
    cands = np.stack([(x - preds[k]) & 0xFF for k in kinds]).astype(np.uint8)
    if row_filter == "adaptive":
        cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
        pick = cost.argmin(0)
    else:
        pick = np.zeros(len(x), np.int64)
    rows = np.empty((len(x), x.shape[1] + 1), np.uint8)
    rows[:, 0] = np.asarray(kinds)[pick]
    rows[:, 1:] = cands[pick, np.arange(len(x))]
    return rows


def encode_png(img: np.ndarray, row_filter=0) -> bytes:
    """(H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8, or (H, W) uint16
    -> PNG bytes, every row with filter ``row_filter`` (0, none, by
    default; 1-4, or ``"adaptive"``, see :func:`_filter_rows`)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ch = 16, 1
        height, width = img.shape
        data = img.astype(">u2").view(np.uint8).reshape(height, 2 * width)
    elif img.dtype == np.uint8:
        depth = 8
        if img.ndim == 2:
            img = img[..., None]
        if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
            raise ValueError(f"cannot write an image of shape {img.shape}")
        height, width, ch = img.shape
        if ch > 1:
            img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
        data = img.reshape(height, width * ch)
    else:
        raise ValueError(f"the PNG codec writes uint8 images and uint16 "
                         f"grayscale ones, got {img.dtype} {img.shape}")
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = _filter_rows(data, ch * depth // 8, row_filter)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                       ctype, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) +
            chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` for 8-bit files.  Raises for a file that is
    absent or cannot be decoded; without cv2, for a 16-bit file too (read it
    with :func:`imread_unchanged`)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        return img
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG; read it unchanged")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: the stored channels and
    dtype (a 16-bit grayscale file as uint16).  Raises for a file that is
    absent or cannot be decoded."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"cv2 cannot decode {path}")
        return img
    return read_png(path)


def read_png(path: str) -> np.ndarray:
    """The codec's decode of a PNG file, on every machine."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def write_png(path: str, img: np.ndarray, row_filter=0) -> None:
    """The codec's encode of ``img`` into ``path``, on every machine: the
    same bytes whether or not cv2 is installed."""
    data = encode_png(img, row_filter)
    with open(path, "wb") as f:
        f.write(data)


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a PNG path.  Raises on failure."""
    if cv2 is not None:
        if not cv2.imwrite(path, img):
            raise OSError(f"cv2 could not write {path}")
        return
    if not path.lower().endswith(".png"):
        raise ValueError(f"without cv2 only PNG files are written: {path}")
    write_png(path, img)


def resize_bilinear_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (h, w[, C]) uint8, resampled as PIL's
    ``Image.resize(..., BILINEAR)`` does: a triangle filter widened by the
    scale when shrinking (``F.interpolate`` with ``antialias=True``), pixel
    centres aligned, rounded to uint8.  Within 1 level of PIL."""
    import torch
    import torch.nn.functional as F

    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"resize_bilinear_u8 takes uint8, got {arr.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(arr))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    y = y[0, 0] if arr.ndim == 2 else y[0].permute(1, 2, 0)
    return np.ascontiguousarray(y.numpy())
