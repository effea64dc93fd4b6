"""The port's host-side data pipeline against the JAX package's.

Every module under ``panacea_tpu_torch/data/nuscenes`` and the rasterizer of
``panacea_tpu_torch/native`` is the port's own copy of a NumPy/cv2 module of
``panacea_tpu``; the same seeded inputs go through both and the outputs are
equal (tolerance 0: the arithmetic is the same, and both draw with cv2 and
the same C++ rasterizer source).
"""

import random

import numpy as np
import pytest

from panacea_tpu import native as jnative
from panacea_tpu.data.nuscenes import calib as jcalib
from panacea_tpu.data.nuscenes import dataset as jdataset
from panacea_tpu.data.nuscenes import draw as jdraw
from panacea_tpu.data.nuscenes import geometry as jgeometry
from panacea_tpu.data.nuscenes import map_extractor as jmap
from panacea_tpu.data.nuscenes import prompts as jprompts
from panacea_tpu.data.nuscenes import synthetic as jsynthetic
from panacea_tpu_torch import native
from panacea_tpu_torch.data.nuscenes import calib, dataset, draw, geometry, map_extractor
from panacea_tpu_torch.data.nuscenes import prompts, synthetic

FINAL_DIM = (32, 64)


def assert_tree_equal(got, want, path="root"):
    """Nested dicts, lists and arrays equal, with equal types and dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def make_dataset(mod_dataset, mod_synthetic, **kw):
    infos = mod_synthetic.make_synthetic_infos(num_frames=6, seed=3)
    # the whole 900 x 1600 source image on the small canvas, so that boxes and
    # road lines land inside it
    return mod_dataset.NuScenesVideoDataset(
        infos=infos, queue_length=2, final_dim=FINAL_DIM, resize=0.04,
        image_loader=mod_synthetic.synthetic_image_loader, seed=3, **kw)


def test_synthetic_infos_and_images_equal():
    assert_tree_equal(synthetic.make_synthetic_infos(num_frames=4, seed=5),
                      jsynthetic.make_synthetic_infos(num_frames=4, seed=5))
    path = "synthetic/CAM_BACK/synth__CAM_BACK__000000000002.jpg"
    assert synthetic.path_seed(path) == jsynthetic.path_seed(path)
    np.testing.assert_array_equal(synthetic.synthetic_image_loader(path),
                                  jsynthetic.synthetic_image_loader(path))


@pytest.mark.parametrize("kw", [{}, {"use_last_frame": False}, {"repeat_cond_frames": True},
                                {"render_pose": False},
                                {"shift_view": True, "split": "train"},
                                {"shift_view": True, "random_shift": True, "split": "train"}])
def test_dataset_items_and_collate_equal(kw):
    """``NuScenesVideoDataset[idx]`` and ``collate`` on the synthetic scenes:
    every array equal, ``txt`` and ``filenames`` equal. Index 0 has no full
    window, so both sides redraw an index from their seeded generators."""
    ds, jds = make_dataset(dataset, synthetic, **kw), make_dataset(jdataset, jsynthetic, **kw)
    assert len(ds) == len(jds) == 6
    items, jitems = [ds[i] for i in (1, 5, 0)], [jds[i] for i in (1, 5, 0)]
    assert_tree_equal(items, jitems)
    item = items[0]
    assert item["jpg"].shape == (2, 32, 6 * 64, 3) and item["jpg"].dtype == np.float32
    assert item["cond_img"].shape == (2, 32, 6 * 64, 19)
    assert (item["cond_img"][..., :13] != 1.0).any()      # boxes were drawn
    assert (item["cond_img"][..., 13:16] != 1.0).any()    # and road lines
    assert_tree_equal(dataset.collate(items), jdataset.collate(jitems))
    assert dataset.collate(items)["cond_img"].shape == (3, 2, 32, 6 * 64, 19)


def test_filenames_are_in_panorama_order():
    """Views 2 and 5 of the info's creation order swap into panorama order
    (F, FR, BR, B, BL, FL): the Gen-nuScenes writer keys its folders off this."""
    item = make_dataset(dataset, synthetic)[1]
    cams = [name.split("__")[1] for name in item["filenames"][-1]]
    assert cams == dataset.PANORAMA_VIEWS
    assert dataset.PANORAMA_VIEWS == jdataset.PANORAMA_VIEWS
    assert dataset.CAM_ORDER == jdataset.CAM_ORDER


def test_load_infos_sorts_by_timestamp(tmp_path):
    import pickle

    infos = [{"timestamp": t, "token": str(t)} for t in (3, 1, 2)]
    for payload, name in (({"infos": infos}, "a.pkl"), (infos, "b.pkl")):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(payload, f)
        got = dataset.load_infos(str(tmp_path / name))
        assert got == jdataset.load_infos(str(tmp_path / name))
        assert [e["timestamp"] for e in got] == [1, 2, 3]


def _boxes(rs, n, h, w):
    """Boxes that start inside the canvas, as ``project_boxes_to_views`` clips
    them, and may end past it."""
    x0, y0 = rs.uniform(0, w - 5, n), rs.uniform(0, h - 5, n)
    boxes = np.stack([x0, y0, x0 + rs.uniform(1, 30, n), y0 + rs.uniform(1, 20, n)], axis=1)
    return boxes, rs.randint(0, 10, n), rs.uniform(0, 100, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_bboxes_equal_on_both_paths(seed):
    """The compiled path and the NumPy path (chosen by argument) give the JAX
    package's pixels."""
    h, w = 48, 80
    boxes, labels, depths = _boxes(np.random.RandomState(seed), 9, h, w)
    want = jdraw.draw_bboxes((h, w), boxes, labels, depths)
    np.testing.assert_array_equal(draw.draw_bboxes((h, w), boxes, labels, depths), want)
    np.testing.assert_array_equal(
        draw.draw_bboxes((h, w), boxes, labels, depths, use_native=False), want)
    assert (want != 255).any()
    empty = draw.draw_bboxes((h, w), np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,)))
    assert (empty == 255).all() and empty.shape == (h, w, 10)


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_corners_equal(seed):
    rs = np.random.RandomState(seed)
    h, w = 48, 80
    n = 4
    centre = rs.uniform([5, 5], [w - 5, h - 5], (n, 1, 2))
    corners = centre + rs.uniform(-15, 15, (n, 8, 2))
    labels, depths = rs.randint(0, 10, n), rs.uniform(1, 60, n)
    want = jdraw.draw_corners((h, w), corners, labels, depths)
    np.testing.assert_array_equal(draw.draw_corners((h, w), corners, labels, depths), want)
    assert (want != 255).any()
    assert (draw.draw_corners((h, w), [], [], []) == 255).all()


def test_draw_map_polylines_and_pose_images_equal():
    infos = synthetic.make_synthetic_infos(num_frames=2, seed=0)
    ds = make_dataset(dataset, synthetic)
    fr = ds._frame_tensors(infos[1])
    h, w = FINAL_DIM
    drawn = 0
    for l2i in fr["lidar2img"]:
        want = jdraw.draw_map_polylines((h, w), fr["vectors"], l2i, jdataset.ID2CAT_MAP)
        got = draw.draw_map_polylines((h, w), fr["vectors"], l2i, dataset.ID2CAT_MAP)
        np.testing.assert_array_equal(got, want)
        drawn += int((want != 255).any())
    assert drawn >= 2   # the road lines are visible in several cameras
    i2l = [np.linalg.inv(m) for m in fr["lidar2img"]]
    for got, want in zip(draw.render_directions((h, w), i2l),
                         jdraw.render_directions((h, w), i2l)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(draw.render_view_colors((h, w), dataset.CAM_ORDER),
                         jdraw.render_view_colors((h, w), jdataset.CAM_ORDER)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["fill_depth_boxes", "draw_polyline", "fill_convex_poly"])
def test_rasterizer_functions_equal(fn):
    """The port's rasterizer (built from its own copy of the source into
    ``_build/``) against the JAX package's binding, on the same canvases."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's rasterizer did not build: no C++ compiler")
    rs = np.random.RandomState(7)
    h, w = 40, 60
    if fn == "fill_depth_boxes":
        boxes, labels, depths = _boxes(rs, 8, h, w)
        boxes = np.clip(boxes, 0, [w, h, w, h])
        got, want = (np.full((h, w, 10), 255, np.uint8) for _ in range(2))
        native.fill_depth_boxes(got, boxes, labels, depths)
        assert jnative.fill_depth_boxes(want, boxes, labels, depths)
    elif fn == "draw_polyline":
        pts = rs.randint(-5, 65, (6, 2))
        got, want = (np.full((h, w, 3), 255, np.uint8) for _ in range(2))
        native.draw_polyline(got, pts, (0, 128, 255), 3)
        assert jnative.draw_polyline(want, pts, (0, 128, 255), 3)
    else:
        pts = np.array([[5, 4], [50, 8], [55, 30], [20, 36]])
        got, want = (np.zeros((h, w, 3), np.uint8) for _ in range(2))
        native.fill_convex_poly(got, pts, (9, 8, 7))
        assert jnative.fill_convex_poly(want, pts, (9, 8, 7))
    np.testing.assert_array_equal(got, want)
    assert (got != got[0, 0]).any()


def test_rasterizer_build_failure_raises(monkeypatch, tmp_path):
    """No swallowed exception: without a compiler, or with a source that does
    not compile, the build raises."""
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        native.build()


def test_rasterizer_refuses_a_wrong_canvas():
    with pytest.raises(ValueError, match="uint8"):
        native.fill_depth_boxes(np.zeros((4, 4, 10), np.float32), np.zeros((0, 4)), [], [])
    with pytest.raises(ValueError, match="uint8"):
        native.draw_polyline(np.zeros((4, 4, 10), np.uint8), np.zeros((2, 2)), (0, 0, 0), 1)


def _map_json():
    """The fixture of tests/test_map_extractor.py: two road polygons sharing
    an edge, one divider line, one pedestrian crossing."""
    nodes = {}

    def node(tok, x, y):
        nodes[tok] = {"token": tok, "x": float(x), "y": float(y)}

    for i, x in enumerate(range(80, 130, 10)):
        node(f"d{i}", x, 100.0)
    for tok, (x, y) in {
        "a0": (80, 90), "a1": (110, 90), "a2": (110, 100), "a3": (80, 100),
        "b0": (110, 90), "b1": (130, 90), "b2": (130, 100), "b3": (110, 100),
        "p0": (95, 92), "p1": (100, 92), "p2": (100, 98), "p3": (95, 98),
    }.items():
        node(tok, x, y)
    return {
        "node": list(nodes.values()),
        "line": [{"token": "L1", "node_tokens": [f"d{i}" for i in range(5)]}],
        "polygon": [
            {"token": "PA", "exterior_node_tokens": ["a0", "a1", "a2", "a3"]},
            {"token": "PB", "exterior_node_tokens": ["b0", "b1", "b2", "b3"]},
            {"token": "PC", "exterior_node_tokens": ["p0", "p1", "p2", "p3"]},
        ],
        "lane_divider": [{"token": "ld", "line_token": "L1"}],
        "road_divider": [],
        "ped_crossing": [{"token": "pc", "polygon_token": "PC"}],
        "road_segment": [
            {"token": "ra", "polygon_token": "PA"},
            {"token": "rb", "polygon_token": "PB"},
        ],
        "lane": [],
    }


@pytest.mark.parametrize("pose", [([100.0, 95.0, 0.0], [1.0, 0, 0, 0]),
                                  ([104.0, 96.0, 0.0], [0.9238795, 0, 0, 0.3826834])])
def test_extract_map_vectors_equal(pose):
    got = map_extractor.extract_map_vectors(map_extractor.NuscMapData(_map_json()), *pose)
    want = jmap.extract_map_vectors(jmap.NuscMapData(_map_json()), *pose)
    assert_tree_equal(got, want)
    assert all(len(got[k]) >= 1 for k in (0, 1, 2))
    line = np.array([[-50.0, 0.0], [50.0, 0.0]])
    assert_tree_equal(map_extractor._clip_polyline_to_roi(line), jmap._clip_polyline_to_roi(line))


def test_dataset_reads_map_json_like_the_jax_package(tmp_path):
    import json

    with open(tmp_path / "somewhere.json", "w") as f:
        json.dump(_map_json(), f)
    info = {"location": "somewhere", "ego2global_translation": [100.0, 95.0, 0.0],
            "ego2global_rotation": [1.0, 0, 0, 0]}
    ds = make_dataset(dataset, synthetic, map_root=str(tmp_path))
    jds = make_dataset(jdataset, jsynthetic, map_root=str(tmp_path))
    assert_tree_equal(ds._map_vectors(info), jds._map_vectors(info))


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "yaw_to_rotmat", "pose", "build_lidar2img",
                                "ida", "box3d_corners", "resample_polyline",
                                "project_boxes_to_views", "post_process_coords"])
def test_calib_and_geometry_equal(fn):
    rs = np.random.RandomState(11)
    q = rs.standard_normal(4)
    q /= np.linalg.norm(q)
    k = np.array([[800.0, 0, 800.0], [0, 800.0, 450.0], [0, 0, 1.0]])
    if fn == "quat_to_rotmat":
        pairs = [(calib.quat_to_rotmat(q), jcalib.quat_to_rotmat(q))]
    elif fn == "yaw_to_rotmat":
        pairs = [(calib.yaw_to_rotmat(0.7), jcalib.yaw_to_rotmat(0.7))]
    elif fn == "pose":
        m, jm = (c.pose_to_matrix(c.quat_to_rotmat(q), [1.0, 2.0, 3.0]) for c in (calib, jcalib))
        pairs = [(m, jm), (calib.invert_pose(m), jcalib.invert_pose(jm))]
    elif fn == "build_lidar2img":
        pairs = list(zip(calib.build_lidar2img(q, [1.5, 0.2, 1.6], k),
                         jcalib.build_lidar2img(q, [1.5, 0.2, 1.6], k)))
    elif fn == "ida":
        got = calib.standard_ida_resize_crop((900, 1600), 0.32, (256, 512))
        want = jcalib.standard_ida_resize_crop((900, 1600), 0.32, (256, 512))
        assert got == want
        l2i, pad, _ = calib.build_lidar2img(q, [1.5, 0.2, 1.6], k)
        pairs = list(zip(calib.update_intrinsics_resize_crop(l2i, pad, *got),
                         jcalib.update_intrinsics_resize_crop(l2i, pad, *want)))
    elif fn == "box3d_corners":
        boxes = rs.uniform(-20, 20, (5, 7))
        pairs = [(geometry.box3d_corners(boxes), jgeometry.box3d_corners(boxes))]
    elif fn == "resample_polyline":
        pts = rs.uniform(-30, 30, (6, 3))
        pairs = [(geometry.resample_polyline(pts, 50), jgeometry.resample_polyline(pts, 50))]
    elif fn == "post_process_coords":
        pts = rs.uniform(-50, 150, (8, 2))
        got = geometry.post_process_coords(pts, (100, 120))
        assert got == jgeometry.post_process_coords(pts, (100, 120)) and got is not None
        return
    else:
        ds = make_dataset(dataset, synthetic)
        seen = 0
        for info in ds.infos:
            fr = ds._frame_tensors(info)
            corners = geometry.box3d_corners(fr["boxes"])
            args = (corners, fr["labels"], fr["lidar2img"], FINAL_DIM)
            got = geometry.project_boxes_to_views(*args)
            assert_tree_equal(got, jgeometry.project_boxes_to_views(*args))
            seen += sum(len(v) for v in got["label2d"])
        assert seen > 0
        return
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)


def test_prompts_equal():
    assert prompts.PROMPT_TEMPLATES == jprompts.PROMPT_TEMPLATES
    got = prompts.generate_prompt([0, 3, 8], draw.CLASS_NAMES, random.Random(4))
    assert got == jprompts.generate_prompt([0, 3, 8], jdraw.CLASS_NAMES, random.Random(4))
    assert got.endswith("car, bus, pedestrian")
