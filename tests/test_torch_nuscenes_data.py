"""The port's nuScenes data path against the JAX package's, on the CPU.

* ``data/image_io.py``: 16-bit grayscale PNGs (the bit-packed ``bev``
  labels PIL writes from an int32 image) written by the codec read back by
  PIL, and PIL's read by the codec, equal; every row filter (0-4 and the
  adaptive choice) at 8 and 16 bits decodes bit-equal to PIL and cv2 and to
  a per-byte reading of the PNG spec; ``resize_bilinear_u8`` within 1 level
  of PIL's ``BILINEAR`` and equal on at least 99% of the elements, at the
  nuScenes camera's ratio and at an odd one.
* ``data/nuscenes_gen.py``: the same scene through the JAX
  ``NuScenesGeneratedDataset`` and the port's: every label, pose and matrix
  equal, images within 1/255 for PNG cameras (PIL's resize against the
  port's) and bit-equal for JPEG cameras (PIL on both sides); a JPEG with
  PIL hidden raises naming the file and PIL.  Label directories written by
  either package's ``save_scene_labels`` read back equal through either
  dataset.
* ``data/nuscenes_labelgen.py``: the rasterizers equal to the JAX
  functions (cv2 present), and naming cv2 where it is absent.
* ``data/loader.py``: two epochs through one ``DataLoader`` with two
  workers reuse the same worker processes and give the JAX loader's
  batches; a dataset whose ``epoch_state`` changes gets new workers.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest

from cobevt_tpu_torch.data import image_io, nuscenes_gen, nuscenes_labelgen
from cobevt_tpu_torch.tools.bench_input import (
    synth_camera,
    write_nuscenes_fixture,
)
from tests.test_torch_image_io import _image

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")


def _pil_png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _rows(data: bytes):
    """(filter kinds of the rows, bit depth) of a PNG."""
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB",
                                               data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return set(raw[:, 0].tolist()), depth


def _spec_unfilter(data: bytes, bpp: int) -> np.ndarray:
    """The PNG spec's reconstruction, one byte at a time (section 9.2)."""
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = len(raw) // h - 1
    out, prior = [], bytes(stride)
    for r in range(h):
        kind, line = raw[r * (stride + 1)], raw[r * (stride + 1) + 1:
                                                (r + 1) * (stride + 1)]
        cur = bytearray(stride)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) >> 1, paeth)[kind]
            cur[i] = (line[i] + pred) & 0xFF
        out.append(bytes(cur))
        prior = bytes(cur)
    return np.frombuffer(b"".join(out), np.uint8).reshape(h, stride)


def test_16_bit_labels_cross_between_the_codec_and_pil():
    rng = np.random.RandomState(0)
    packed = rng.randint(0, 1 << 12, (37, 53)).astype(np.int32)
    pil_bytes = _pil_png(packed)
    assert _rows(pil_bytes)[1] == 16
    got = image_io.decode_png(pil_bytes)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, packed)
    mine = image_io.encode_png(packed.astype(np.uint16))
    back = np.asarray(Image.open(io.BytesIO(mine)))
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back, packed)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_UNCHANGED),
        packed)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4, "adaptive"])
def test_every_row_filter_decodes_bit_equal(depth, row_filter, tmp_path):
    rng = np.random.RandomState(1)
    if depth == 8:
        img = synth_camera(rng, 41, 67)
        bpp = 3
    else:
        img = (rng.randint(0, 1 << 12, (41, 67)) *
               (np.arange(67) % 3 != 0)).astype(np.uint16)
        bpp = 2
    data = image_io.encode_png(img[..., ::-1] if depth == 8 else img,
                               row_filter)
    kinds, got_depth = _rows(data)
    assert got_depth == depth
    if row_filter == "adaptive":
        assert len(kinds) > 1
    else:
        assert kinds == {row_filter}
    got = image_io.decode_png(data)
    want_pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got[..., ::-1] if depth == 8 else got,
                                  want_pil)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  got)
    spec = _spec_unfilter(data, bpp)
    raw = got[..., ::-1] if depth == 8 else got.astype(">u2")
    np.testing.assert_array_equal(
        np.frombuffer(np.ascontiguousarray(raw).tobytes(), np.uint8),
        spec.reshape(-1))


def test_pil_and_cv2_files_of_all_five_filters_decode_bit_equal(tmp_path):
    """cv2's own adaptive rows (all five filters on this image), and PIL's,
    through the codec."""
    img = _image(3)
    path = str(tmp_path / "cv2.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 3])
    data = open(path, "rb").read()
    assert _rows(data)[0] == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    pil = _pil_png(img)
    np.testing.assert_array_equal(image_io.decode_png(pil)[..., ::-1], img)


@pytest.mark.parametrize("hw,size", [((900, 1600), (270, 480)),
                                     ((123, 457), (61, 200)),
                                     ((90, 160), (110, 128))])
def test_resize_holds_to_pil_bilinear(hw, size):
    img = synth_camera(np.random.RandomState(3), *hw)
    want = np.asarray(Image.fromarray(img).resize(size[::-1],
                                                  Image.BILINEAR))
    got = image_io.resize_bilinear_u8(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def _jax_dataset(path, cfg, raw_uint8=False):
    from cobevt_tpu.data.nuscenes_gen import ImageConfig as JaxImageConfig
    from cobevt_tpu.data.nuscenes_gen import concat_scene_datasets as jcat

    scenes = sorted(f[:-5] for f in os.listdir(os.path.join(path, "labels"))
                    if f.endswith(".json"))
    return jcat(scenes, os.path.join(path, "data"),
                os.path.join(path, "labels"),
                JaxImageConfig(cfg.h, cfg.w, cfg.top_crop))


def _port_dataset(path, cfg, raw_uint8=False):
    scenes = sorted(f[:-5] for f in os.listdir(os.path.join(path, "labels"))
                    if f.endswith(".json"))
    return nuscenes_gen.concat_scene_datasets(
        scenes, os.path.join(path, "data"), os.path.join(path, "labels"),
        cfg, raw_uint8=raw_uint8)


CFG = nuscenes_gen.ImageConfig(h=64, w=128, top_crop=46)


def _assert_samples(got, want, image_atol):
    assert set(got) == set(want) == {"image", "intrinsics", "extrinsics",
                                     "view", "bev", "visibility", "center",
                                     "pose"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        if k == "image":
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=image_atol)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_the_dataset_reads_like_jax(fmt, tmp_path):
    write_nuscenes_fixture(str(tmp_path), 2, 2, n_cam=2, cam_hw=(90, 160),
                           bev=40, row_filter="adaptive", camera_format=fmt)
    ref, port = _jax_dataset(str(tmp_path), CFG), _port_dataset(
        str(tmp_path), CFG)
    assert len(port) == len(ref) == 4
    for i in range(4):
        # PNG cameras: PIL's resize against the port's, within 1 level; JPEG
        # cameras go through PIL on both sides
        _assert_samples(port[i], ref[i],
                        1 / 255 + 1e-7 if fmt == "png" else 0.0)
    assert 0.0 < port[0]["bev"].mean() < 1.0
    assert port[0]["image"].shape == (2, 64, 128, 3)
    u8 = _port_dataset(str(tmp_path), CFG, raw_uint8=True)[1]["image"]
    assert u8.dtype == np.uint8
    np.testing.assert_array_equal(u8.astype(np.float32) / 255.0,
                                  port[1]["image"])


def test_a_jpeg_without_pil_raises_naming_the_file(tmp_path, monkeypatch):
    write_nuscenes_fixture(str(tmp_path), 1, 1, n_cam=1, cam_hw=(90, 160),
                           bev=40, camera_format="jpg")
    monkeypatch.setattr(nuscenes_gen, "Image", None)
    with pytest.raises(RuntimeError, match=r"cam_00000\.jpg.*PIL"):
        _port_dataset(str(tmp_path), CFG)[0]


def _labelgen_samples(n_cam=2):
    rng = np.random.RandomState(4)
    out = []
    for i in range(3):
        out.append({
            "token": f"t{i}", "images": [f"cam_{i}_{c}.png"
                                         for c in range(n_cam)],
            "intrinsics": [np.eye(3).tolist()] * n_cam,
            "extrinsics": [np.eye(4).tolist()] * n_cam,
            "view": np.eye(3).tolist(),
            "bev": (rng.rand(30, 30, 12) > 0.7).astype(np.uint8) * 255,
            "visibility": rng.randint(0, 5, (30, 30)).astype(np.uint8),
            "aux": rng.rand(30, 30, 2).astype(np.float32)})
    out[1].pop("aux")
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_directories_cross_between_the_packages(writer, tmp_path):
    """A scene written by either package's ``save_scene_labels`` reads back
    equal through both datasets, its JSON index equal to the other
    writer's."""
    import json

    from cobevt_tpu.data import nuscenes_labelgen as jgen

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(5)
    samples = _labelgen_samples()
    for s in samples:
        for name in s["images"]:
            image_io.write_png(str(data / name),
                               synth_camera(rng, 90, 160)[..., ::-1])
    both = {}
    for who, fn in (("jax", jgen.save_scene_labels),
                    ("port", nuscenes_labelgen.save_scene_labels)):
        fn("scene-a", samples, str(tmp_path / who / "labels"))
        os.symlink(data, tmp_path / who / "data")
        with open(tmp_path / who / "labels" / "scene-a.json") as f:
            both[who] = json.load(f)
    assert both["jax"] == both["port"]
    path = str(tmp_path / writer)
    bev = open(os.path.join(path, "labels", "scene-a", "bev_t0.png"),
               "rb").read()
    assert _rows(bev)[1] == 16
    ref, port = _jax_dataset(path, CFG), _port_dataset(path, CFG)
    for i in range(3):
        want, got = ref[i], port[i]
        assert set(got) == set(want)
        for k in ("bev", "visibility", "center", "pose", "view",
                  "intrinsics", "extrinsics"):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            got["bev"], (samples[i]["bev"] > 0).astype(np.float32))


def test_rasterizers_match_jax():
    from cobevt_tpu.data import nuscenes_labelgen as jgen

    rng = np.random.RandomState(6)
    view = np.array([[0.0, -2.0, 50.0], [-2.0, 0.0, 50.0], [0.0, 0.0, 1.0]])
    polys = [rng.uniform(-20, 20, (5, 2)) for _ in range(4)]
    for thickness in (-1, 2):
        np.testing.assert_array_equal(
            nuscenes_labelgen.rasterize_polygons(polys, view, (100, 100),
                                                 thickness),
            jgen.rasterize_polygons(polys, view, (100, 100), thickness))
    corners = rng.uniform(-20, 20, (6, 4, 3))
    w2e = np.eye(4)
    w2e[:3, 3] = [1.0, -2.0, 0.5]
    pix = nuscenes_labelgen.project_box_footprints(corners, view, w2e)
    np.testing.assert_array_equal(
        pix, jgen.project_box_footprints(corners, view, w2e))
    assert pix.shape == (6, 4, 2)
    np.testing.assert_array_equal(
        nuscenes_labelgen.render_dynamic_layers(pix, (100, 100)),
        jgen.render_dynamic_layers(pix, (100, 100)))
    np.testing.assert_array_equal(
        nuscenes_labelgen.render_center_offset(pix, (100, 100)),
        jgen.render_center_offset(pix, (100, 100)))
    vis = rng.randint(0, 5, 6)
    np.testing.assert_array_equal(
        nuscenes_labelgen.render_visibility(pix, vis, (100, 100)),
        jgen.render_visibility(pix, vis, (100, 100)))


def test_rasterizers_name_cv2_where_it_is_absent(monkeypatch):
    monkeypatch.setattr(nuscenes_labelgen, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        nuscenes_labelgen.render_dynamic_layers(np.zeros((1, 4, 2)))
    # the writer needs no cv2
    assert nuscenes_labelgen.render_center_offset(
        np.zeros((1, 4, 2)), (8, 8)).shape == (8, 8, 2)


class PidDataset:
    """Each sample: its index and the process that made it (module level,
    so spawned workers unpickle it)."""

    def __init__(self, n):
        self.n = n
        self.version = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32),
                "pid": np.array(os.getpid())}

    def epoch_state(self):
        return self.version

    @staticmethod
    def collate(samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_loader_keeps_its_workers_across_epochs():
    from cobevt_tpu.data.loader import DataLoader as JaxDataLoader
    from cobevt_tpu_torch.data.loader import DataLoader

    ds = PidDataset(10)
    kw = dict(batch_size=3, shuffle=True, seed=4)
    jl = JaxDataLoader(ds, **kw)
    pl = DataLoader(ds, num_workers=2, **kw)
    pids = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"].numpy(), w["x"])
        pids.append({int(p) for g in got for p in g["pid"]})
    assert pids[0] == pids[1] and os.getpid() not in pids[0]
    assert 1 <= len(pids[0]) <= 2
    # the dataset changed between epochs: new workers see it
    ds.version += 1
    again = {int(p) for g in pl for p in g["pid"]}
    assert again.isdisjoint(pids[0])
    pl.close()
    assert pl._torch_loader is None


@pytest.mark.parametrize("hw,size", [((224, 480), (160, 342)),
                                     ((48, 70), (684, 684)),
                                     ((57, 91), (33, 140))])
def test_the_viewer_resize_holds_to_cv2(hw, size, monkeypatch):
    """``utils/nuscenes_viz.py`` resizes within 1 level of ``cv2.resize``
    (bilinear), shrinking and enlarging, and its panels are within 1 level
    of the same panels resized by cv2."""
    from cobevt_tpu_torch.utils import nuscenes_viz

    img = synth_camera(np.random.RandomState(7), *hw)
    want = cv2.resize(img, size[::-1])
    got = nuscenes_viz.resize_linear(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1
    batch = {"image": np.random.RandomState(8).rand(1, 2, 64, 128, 3),
             "bev": (np.random.RandomState(9).rand(1, 40, 40, 12) > 0.9)
             .astype(np.float32)}
    got = nuscenes_viz.sample_panel(batch)
    monkeypatch.setattr(nuscenes_viz, "resize_linear",
                        lambda im, hw: cv2.resize(im, hw[::-1]))
    with_cv2 = nuscenes_viz.sample_panel(batch)
    assert got.shape == with_cv2.shape == (160 + 640, 640, 3)
    assert np.abs(got.astype(np.int16) - with_cv2).max() <= 1


def test_the_bgr_read_refuses_a_16_bit_file_without_cv2(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "bev.png")
    image_io.write_png(path, np.arange(12, dtype=np.uint16).reshape(3, 4))
    monkeypatch.setattr(image_io, "cv2", None)
    with pytest.raises(ValueError, match="16-bit"):
        image_io.imread(path)
    np.testing.assert_array_equal(image_io.imread_unchanged(path),
                                  np.arange(12).reshape(3, 4))
