"""The LiDAR viewer, port vs JAX: ``tools/view_lidar.py`` on the fixture tree
of ``tests/test_lidar_dataset_e2e.py`` writes a PNG a frame and the HTML
viewer, as the JAX tool does with the same flags; the viewer's geometry
(``box_edge_segments``) and colors (``color_encoding``, every mode) equal
the JAX package's.  Tolerance: equal arrays; the PNGs are checked for size
and content only (matplotlib draws both sides)."""

import numpy as np
import pytest

from cobevt_tpu.utils import lidar_viz as jviz
from cobevt_tpu_torch.data.image_io import read_png
from cobevt_tpu_torch.tools import view_lidar
from cobevt_tpu_torch.utils import lidar_viz as pviz
from tests.test_lidar_dataset_e2e import write_lidar_fixture


@pytest.mark.parametrize("view", ["bev", "3d"])
def test_view_lidar_writes_frames_and_html(tmp_path, view):
    root, out = str(tmp_path / "lidar"), str(tmp_path / "viz")
    write_lidar_fixture(root)
    paths = view_lidar.main(["--root", root, "--out", out, "--view", view,
                             "--mode", "intensity", "--max_frames", "2",
                             "--html"])
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "frame_00000.png", "frame_00001.png", "viewer.html"]
    for path in paths[:2]:
        img = read_png(path)
        assert img.ndim == 3 and img.shape[0] > 100 and img.std() > 1.0
    html = open(paths[2]).read()
    assert html.startswith("<!DOCTYPE html>") and '"gt":[' in html


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_box_edges_and_colors_equal_the_jax_packages(order):
    rng = np.random.RandomState(0)
    boxes = np.column_stack([rng.uniform(-20, 20, (6, 3)),
                             rng.uniform(1, 4, (6, 3)),
                             rng.uniform(-3, 3, 6)])
    np.testing.assert_array_equal(pviz.box_edge_segments(boxes, order),
                                  jviz.box_edge_segments(boxes, order))
    corners = pviz.boxes_to_corners_3d(boxes, order)
    np.testing.assert_array_equal(pviz.box_edge_segments(corners),
                                  jviz.box_edge_segments(corners))
    assert pviz.box_edge_segments(np.zeros((0, 7))).shape == (0, 12, 2, 3)
    values = np.concatenate([rng.rand(50), rng.uniform(-2, 1, 50)])
    for mode in ("intensity", "z-value", "constant"):
        np.testing.assert_array_equal(pviz.color_encoding(values, mode),
                                      jviz.color_encoding(values, mode))
    import matplotlib.pyplot as plt
    fig = pviz.visualize_bev(rng.rand(32, 32, 5), save_path=None)
    assert len(fig.axes) == 1
    plt.close(fig)
