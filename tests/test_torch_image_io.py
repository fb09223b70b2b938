"""``data/image_io.py``: the numpy PNG codec against OpenCV.

PNGs that cv2 wrote with an explicit compression level (its adaptive
filtering, which uses all five row filters on these images; the test checks
that it did) decode bit-equal to ``cv2.imread``, with ``IMREAD_COLOR``
(``imread``) and ``IMREAD_UNCHANGED`` (``decode_png``), for gray, BGR and
BGRA; the codec's own files (filter 0) read back bit-equal through cv2.  The
codec path is the one the module takes when cv2 cannot be imported, which
the tests stand in for by setting the module's ``cv2`` to None.  Exact
equality throughout.
"""

import struct
import zlib

import numpy as np
import pytest

from cobevt_tpu_torch.data import image_io

cv2 = pytest.importorskip("cv2")


def _image(ch: int, seed: int = 0, size: int = 64) -> np.ndarray:
    """Gradients, a noise band and a flat band: rows where each filter
    wins."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    planes = [(xx * 5) % 256, (yy * 3 + xx) % 256, (xx * yy // 7) % 256,
              (255 - yy * 2) % 256]
    img = np.stack(planes[:ch], -1).astype(np.uint8)
    img[:12] = rng.randint(0, 256, (12, size, ch))
    img[30:36] = 100
    img[44:] = ((xx * 7 + yy * 11) % 256)[44:, :, None]
    return img[..., 0] if ch == 1 else img


def _filters(path) -> set:
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * ch + 1)[:, 0].tolist())


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setattr(image_io, "cv2", None)


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_codec_reads_cv2_files_bit_equal(ch, tmp_path, monkeypatch):
    path = str(tmp_path / f"cv2_{ch}.png")
    img = _image(ch)
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 3])
    assert _filters(path) == {0, 1, 2, 3, 4}
    want = cv2.imread(path)
    want_unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    monkeypatch.setattr(image_io, "cv2", None)
    got = image_io.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(image_io.decode_png(f.read()),
                                      want_unchanged)


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_cv2_reads_codec_files_bit_equal(ch, tmp_path, no_cv2):
    path = str(tmp_path / f"codec_{ch}.png")
    img = _image(ch, seed=1)
    image_io.imwrite(path, img)
    assert _filters(path) == {0}
    np.testing.assert_array_equal(
        cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(image_io.decode_png(f.read()), img)


def test_with_cv2_the_module_is_cv2(tmp_path):
    path = str(tmp_path / "x.png")
    img = _image(3, seed=2)
    image_io.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


@pytest.mark.parametrize("use_cv2", [True, False])
def test_a_file_that_cannot_be_decoded_raises(use_cv2, tmp_path,
                                              monkeypatch):
    if not use_cv2:
        monkeypatch.setattr(image_io, "cv2", None)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        image_io.imread(str(bad))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "absent.png"))


def test_codec_refuses_what_it_does_not_read(no_cv2):
    header = struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(header)) + b"IHDR"
            + header + b"\0" * 4 + struct.pack(">I", 0) + b"IEND" + b"\0" * 4)
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(data)
