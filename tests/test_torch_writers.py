"""The port's output writers against the JAX package's: the same arrays
written by both give the same tree of file names, and every file decodes to
the same image (PNG, GIF frames and JPEG alike: both use PIL with the same
settings)."""

import os

import numpy as np
import pytest
from PIL import Image, ImageSequence

from panacea_tpu import writers as jwriters
from panacea_tpu_torch import writers

T, H, VW = 2, 16, 32     # frames, height, width of one view
CAMS = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT",
        "CAM_FRONT_LEFT"]


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def decoded(path):
    with Image.open(path) as im:
        return [np.array(frame.convert("RGB")) for frame in ImageSequence.Iterator(im)]


def assert_same_files(a, b):
    assert tree(a) == tree(b) and tree(a)
    for rel in tree(a):
        fa, fb = decoded(os.path.join(a, rel)), decoded(os.path.join(b, rel))
        assert len(fa) == len(fb), rel
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y, err_msg=rel)


def make_log(seed=0):
    rs = np.random.RandomState(seed)
    img = lambda: rs.uniform(-1.2, 1.2, (T, H, 6 * VW, 3)).astype(np.float32)  # noqa: E731
    cond = rs.uniform(0, 1, (T, H, 6 * VW, 19)).astype(np.float32)
    return {"inputs": img(), "cond_img": cond, "reconstructions": img(),
            "control": cond * 2 - 1, "samples": img()}


def make_filenames():
    return [[f"synthetic/{cam}/synth__{cam}__{t:012d}.jpg" for cam in CAMS] for t in range(T)]


def test_to_uint8_and_displayable_equal():
    x = np.random.RandomState(1).uniform(-1.5, 1.5, (3, 4, 5, 19)).astype(np.float32)
    np.testing.assert_array_equal(writers.to_uint8(x), jwriters.to_uint8(x))
    np.testing.assert_array_equal(writers.to_uint8(x, (0.0, 1.0)), jwriters.to_uint8(x, (0.0, 1.0)))
    np.testing.assert_array_equal(writers._displayable(x), jwriters._displayable(x))
    assert writers._displayable(x).shape == (3, 4, 5)
    assert writers._displayable(x[..., :3]).shape == (3, 4, 5, 3)
    assert writers.PANORAMA_VIEWS == jwriters.PANORAMA_VIEWS == CAMS


def test_log_outputs_writes_the_same_tree_and_images(tmp_path):
    log, names = make_log(), make_filenames()
    writers.log_outputs(log, str(tmp_path / "port"), names, num_frames=T, view_width=VW)
    jwriters.log_outputs(log, str(tmp_path / "jax"), names, num_frames=T, view_width=VW)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    got = tree(str(tmp_path / "port"))
    stem = "synth__CAM_FRONT__000000000001"
    # grids and GIFs per log key but cond_img and reconstructions
    for key in ("inputs", "control", "samples"):
        assert f"{key}/{stem}.png" in got and f"{key}/{stem}.gif" in got
    assert not any(p.startswith(("cond_img", "reconstructions")) for p in got)
    # the tree the StreamPETR harness reads: <CAM>_<stem>/_00000<i>.jpg, keyed
    # by the last frame's names
    for cam in CAMS:
        for i in range(T):
            assert f"gen-nuscenes/{cam}_synth__{cam}__000000000001/_{i:06d}.jpg" in got
    assert len(got) == 6 + 6 * T
    grid = decoded(str(tmp_path / "port" / "samples" / f"{stem}.png"))[0]
    assert grid.shape == (T * H, 6 * VW, 3)
    assert len(decoded(str(tmp_path / "port" / "control" / f"{stem}.gif"))) == T


@pytest.mark.parametrize("flags", [{"save_gifs": False}, {"save_grids": False},
                                   {"save_frames": False}])
def test_log_outputs_flags_equal(tmp_path, flags):
    log, names = make_log(2), make_filenames()
    writers.log_outputs(log, str(tmp_path / "port"), names, num_frames=T, view_width=VW, **flags)
    jwriters.log_outputs(log, str(tmp_path / "jax"), names, num_frames=T, view_width=VW, **flags)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_gen_nuscenes_tiles_are_the_views(tmp_path):
    """View ``i`` of the panorama lands in the folder of the ``i``-th name; a
    name without a camera part falls back to the panorama order."""
    frames = np.zeros((T, H, 6 * VW, 3), np.float32)
    for vi in range(6):
        frames[:, :, vi * VW:(vi + 1) * VW] = -1.0 + 0.4 * vi   # flat tiles survive JPEG
    names = make_filenames()
    names[-1][3] = "plainname.jpg"
    dirs = writers.save_frames_gen_nuscenes(frames, str(tmp_path / "port"), names, VW)
    jdirs = jwriters.save_frames_gen_nuscenes(frames, str(tmp_path / "jax"), names, VW)
    assert [os.path.basename(d) for d in dirs] == [os.path.basename(d) for d in jdirs]
    assert os.path.basename(dirs[3]) == "CAM_BACK_plainname"
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    for vi, d in enumerate(dirs):
        tile = decoded(os.path.join(d, "_000000.jpg"))[0]
        assert tile.shape == (H, VW, 3)
        assert abs(int(tile[0, 0, 0]) - int(writers.to_uint8(frames)[0, 0, vi * VW, 0])) <= 2


def test_save_gif_and_grid_equal(tmp_path):
    frames = make_log(3)["samples"]
    for mod, name in ((writers, "port"), (jwriters, "jax")):
        mod.save_gif(frames, str(tmp_path / name / "a" / "x.gif"), fps=4.0)
        mod.save_image_grid(frames, str(tmp_path / name / "b" / "x.png"))
        mod.save_image_grid(make_log(3)["cond_img"], str(tmp_path / name / "c" / "x.png"),
                            (0.0, 1.0))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    with Image.open(tmp_path / "port" / "a" / "x.gif") as im:
        assert im.info["duration"] == 250 and im.info.get("loop") == 0
