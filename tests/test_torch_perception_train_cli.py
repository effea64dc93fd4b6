"""The port's perception training CLI (``train_perception_torch.py``) on the
CPU: the JAX CLI's flags and defaults, the train log's keys, a bit-exact
resume in the window and the streaming recipes, the non-strict
``--load_from``, the refusal without a card and the refusals of what is not
ported. Torch and BLAS run on two threads. The CLIs are not run side by
side (the JAX one compiles the whole ResNet-50);
``tests/test_torch_perception_train.py`` compares the modules.
"""

import importlib.util
import json
import math
import os

import pytest
import torch
import yaml
from torch_parity import two_threads  # noqa: F401

from panacea_tpu_torch.configs import PERCEPTION
from panacea_tpu_torch.perception import train_cli
from panacea_tpu_torch.perception.detector import StreamPETR

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
WINDOW, STREAMING = "streampetr_r50_atss_512x256_window", "streampetr_r50_atss_512x256_nopretrain"
JAX_LOSS_KEYS = {"loss", "loss_cls", "loss_bbox", "loss_dn", "loss_atss_cls", "loss_atss_bbox",
                 "loss_atss_ctr"}


def run(tmp_path, *flags):
    return train_cli.main(["--synthetic", "--tiny", "--device", "cpu",
                           "--workdir", str(tmp_path)] + list(flags))


def test_parser_has_the_jax_clis_flags_and_defaults():
    spec = importlib.util.spec_from_file_location("jax_train_perception",
                                                  os.path.join(ROOT, "train_perception.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    want = vars(jcli.get_parser().parse_args([]))
    got = vars(train_cli.get_parser().parse_args([]))
    assert got.pop("device") is None                     # the one flag beyond the JAX CLI's
    assert got == want


def test_tiny_cli_writes_the_jax_clis_train_log(tmp_path, capsys):
    """Two steps of the window recipe (the recipe's ATSS checkpoint is not in
    the repository: a warning, then the random init): train_log.json with
    the JAX CLI's keys and loss terms, all finite, and final.pt."""
    log = run(tmp_path, "--steps", "2")
    out = capsys.readouterr().out
    assert "load_from ckpts/atss_r50_fpn_20epoch_nuim_sgd_remapped.pth not found" in out
    with open(tmp_path / WINDOW / "train_log.json") as f:
        written = json.load(f)
    assert written.keys() == {"steps", "final_metrics"} and written["steps"] == 2
    assert written["final_metrics"].keys() == JAX_LOSS_KEYS
    assert all(math.isfinite(v) for v in written["final_metrics"].values())
    assert log["state"].step == 2
    final = torch.load(tmp_path / WINDOW / "final.pt")
    assert final.keys() == log["state"].model.state_dict().keys()
    assert any(k.startswith("img_roi_head.") for k in final)


@pytest.mark.parametrize("recipe, flags", [
    (WINDOW, ["--queue_length", "2", "--final_dim", "32", "64"]),
    (STREAMING, ["--eval_every", "3", "--eval_samples", "2", "--final_dim", "32", "64"]),
])
def test_resume_continues_bit_exactly(tmp_path, recipe, flags):
    """Three steps in one run against two steps, a checkpoint and one
    resumed step: every tensor of final.pt equal, and the step count
    right. The streaming run carries its memory and the sampler's draws
    through the checkpoint, and its eval hook writes eval_log.jsonl."""
    base = ["--config", recipe, "--ckpt_every", "2"] + flags
    whole = run(tmp_path / "whole", "--steps", "3", *base)
    run(tmp_path / "cut", "--steps", "2", *base)
    assert sorted(os.listdir(tmp_path / "cut" / recipe)) == ["final.pt", "iter_2",
                                                             "train_log.json"]
    resumed = run(tmp_path / "cut", "--steps", "3", "--resume", str(tmp_path / "cut" / recipe),
                  *base)
    assert whole["steps"] == resumed["steps"] == resumed["state"].step == 3
    assert whole["final_metrics"] == resumed["final_metrics"]
    a, b = (torch.load(p / recipe / "final.pt") for p in (tmp_path / "whole", tmp_path / "cut"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    if recipe == STREAMING:
        with open(tmp_path / "whole" / recipe / "eval_log.jsonl") as f:
            assert json.loads(f.readline())["step"] == 3
        assert isinstance(resumed["state"].model, StreamPETR)


def test_load_from_takes_a_pth_non_strictly_and_freezes_the_stem(tmp_path, capsys):
    """An mmdet-style .pth (a 'state_dict' inside, one tensor of another
    shape, one name the detector lacks): the counts printed and logged as
    the JAX CLI logs them; the frozen stem and layer1 and every batch-norm
    statistic keep the loaded values through a step."""
    src = StreamPETR(**train_cli.TINY, with_atss=True)
    src.init_weights(torch.Generator().manual_seed(3), zero_init_std=0.02)
    sd = dict(src.state_dict())
    sd["pts_bbox_head.reference_points.weight"] = torch.zeros(5, 3)
    sd["img_backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "pretrain.pth"
    torch.save({"state_dict": sd}, path)
    log = run(tmp_path, "--config", STREAMING, "--steps", "1", "--load_from", str(path))
    assert log["load_from"] == {"path": str(path), "n_loaded": len(sd) - 2, "n_skipped": 2}
    assert f"merged {len(sd) - 2} pretrained tensors" in capsys.readouterr().out
    got = log["state"].model.state_dict()
    frozen = [k for k in got if k.startswith(("img_backbone.conv1", "img_backbone.bn1",
                                               "img_backbone.layer1."))
              or k.endswith(("running_mean", "running_var"))]
    assert len(frozen) > 50
    assert all(torch.equal(got[k], sd[k]) for k in frozen)
    assert not torch.equal(got["img_backbone.layer2.0.conv1.weight"],
                           sd["img_backbone.layer2.0.conv1.weight"])


def write_gen_tree(root, infos, clip_len: int, hw=(64, 128)):
    """A Gen-nuScenes frame tree as ``inference_torch.py`` writes it: for
    every sample and camera a directory ``{CAM}_{stem}`` (the stem of the
    clip's last frame) holding ``_{offset:06d}.jpg`` for each of the
    clip's frames, each image one grey level."""
    import cv2
    import numpy as np

    for info in infos:
        for cinfo in info["cams"].values():
            stem = os.path.basename(cinfo["data_path"]).rsplit(".", 1)[0]
            d = os.path.join(root, f"{stem.split('__')[-2]}_{stem}")
            os.makedirs(d, exist_ok=True)
            for off in range(clip_len):
                level = (len(stem) * 7 + int(stem[-4:]) * 13 + off * 29) % 256
                cv2.imwrite(os.path.join(d, f"_{off:06d}.jpg"),
                            np.full(hw + (3,), level, np.uint8))


def test_generated_clips_train_the_detector_and_read_as_jax(tmp_path, monkeypatch):
    """``--gen_root`` (the pseudo-pretrain recipe's generated training set):
    one step of the tiny window recipe on a tree of the CLI's synthetic
    infos reads every frame of its window (``gen_frames_missing`` 0); and
    the port's ``PerceptionTrainDataset`` reads the generated frames in the
    JAX dataset's order, the same files for the same windows, with equal
    images (random history jitter on)."""
    import cv2
    import numpy as np

    from panacea_tpu.data.nuscenes.synthetic import make_synthetic_infos as jax_infos
    from panacea_tpu.perception.train_dataset import PerceptionTrainDataset as JTrainDataset
    from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos
    from panacea_tpu_torch.perception.train_dataset import PerceptionTrainDataset

    tree = str(tmp_path / "gen-nuscenes")
    write_gen_tree(tree, make_synthetic_infos(num_frames=8, num_boxes=6, seed=0), 2)
    log = run(tmp_path, "--steps", "1", "--queue_length", "2", "--gen_root", tree)
    assert log["gen_frames_missing"] == 0 and log["gen_frames_loaded"] >= 12
    with open(tmp_path / WINDOW / "train_log.json") as f:
        assert json.load(f)["gen_frames_missing"] == 0

    reads, imread = [], cv2.imread
    monkeypatch.setattr(cv2, "imread", lambda path, *a: reads.append(path) or imread(path, *a))
    kw = dict(gen_root=tree, queue_length=2, final_dim=(64, 128), random_length=1, seed=3)
    ours = PerceptionTrainDataset(infos=make_synthetic_infos(num_frames=8, num_boxes=6, seed=0),
                                  **kw)
    ref = JTrainDataset(infos=jax_infos(num_frames=8, num_boxes=6, seed=0), **kw)
    for key in list(range(8)) * 2:
        got = ours.train_window(key)
        ours_reads, reads[:] = list(reads), []
        want = ref.train_window(key)
        assert ours_reads == reads and (got is None) == (want is None)
        reads.clear()
        if got is not None:
            for k in want[0]:
                np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    assert ours.gen_misses == ref.gen_misses == 0
    assert ours.gen_hits == ref.gen_hits == 16 * 2 * 6   # 16 windows of 2 frames of 6 cameras


def test_cli_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--synthetic", "--tiny"])


def zoo_recipe(tmp_path, **params):
    cfg = PERCEPTION[WINDOW]
    cfg = dict(cfg, perception=dict(cfg["perception"], detector=dict(
        cfg["perception"]["detector"], params=dict(cfg["perception"]["detector"]["params"],
                                                   **params))))
    path = tmp_path / "zoo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("case", ["head_motion", "backbone_vovnet", "dp_env", "world_size",
                                  "orbax_resume", "orbax_load_from"])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, case):
    flags = ["--steps", "1"]
    error, match = NotImplementedError, "Queue A item 6"
    if case == "head_motion":
        flags += ["--config", zoo_recipe(tmp_path, head_type="motion")]
    elif case == "backbone_vovnet":
        flags += ["--config", zoo_recipe(tmp_path, backbone_type="vovnet")]
    elif case in ("dp_env", "world_size"):
        monkeypatch.setenv(*(("PANACEA_PERCEPTION_DP", "1") if case == "dp_env"
                             else ("WORLD_SIZE", "2")))
        match = "Queue A item 7"
    else:
        orbax = tmp_path / "jax_run" / "iter_4"
        orbax.mkdir(parents=True)
        (orbax / "_CHECKPOINT_METADATA").write_text("{}")
        error, match = SystemExit, "Not queued"
        flags += (["--resume", str(orbax.parent)] if case == "orbax_resume"
                  else ["--load_from", str(orbax)])
    with pytest.raises(error, match=match):
        run(tmp_path, *flags)
