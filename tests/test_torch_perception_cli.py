"""The port's perception eval CLI and its host side, against the JAX package.

The parser, the metric keys the CLI prints, the VoVNet and PETR heads on
one window, EVA-02 and the proposal-query heads on one window, the
``--torch_ckpt`` load, the refusal of the JAX package's orbax trees, the
eval dataset's windows and the result collection. The CLIs are not run
side by side (the JAX one compiles the whole ResNet-50);
``tests/test_torch_perception.py`` compares the modules.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from panacea_tpu.data.nuscenes.synthetic import make_synthetic_infos as jax_infos
from panacea_tpu.perception.eval_dataset import GenNuScenesEvalDataset as JaxEvalDataset
from panacea_tpu.perception.metrics import evaluate_detections as jax_evaluate
from panacea_tpu_torch import inference
from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos
from panacea_tpu_torch.perception import eval as peval
from panacea_tpu_torch.perception.collect import collect_results_cpu
from panacea_tpu_torch.perception.detector import StreamPETRWindow
from panacea_tpu_torch.perception.eval_dataset import GenNuScenesEvalDataset
from torch_parity import two_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY_CLI = ["--synthetic", "--tiny", "--device", "cpu"]


def printed_metrics(out: str) -> dict:
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def test_parser_has_the_jax_clis_flags_and_defaults():
    spec = importlib.util.spec_from_file_location("jax_eval_perception",
                                                  os.path.join(ROOT, "eval_perception.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    want = vars(jcli.get_parser().parse_args([]))
    got = vars(peval.get_parser().parse_args([]))
    assert got.pop("device") is None                     # the one flag beyond the JAX CLI's
    assert got == want
    for flag in ("backbone", "head"):
        choices = lambda p: next(a.choices for a in p._actions if a.dest == flag)  # noqa: E731
        assert choices(peval.get_parser()) == choices(jcli.get_parser())


def test_tiny_cli_prints_the_jax_clis_metric_keys(capsys, two_threads):
    metrics = peval.main(TINY_CLI)
    printed = printed_metrics(capsys.readouterr().out)
    assert printed.keys() == metrics.keys() == jax_evaluate([], []).keys()
    assert all(math.isfinite(v) for v in printed.values())


@pytest.mark.parametrize("head", ["petr", "petr_dn", "motion"])
def test_tiny_cli_runs_the_vovnet_petr_family(capsys, two_threads, head):
    """``--backbone vovnet --head petr|petr_dn|motion``: the full VoVNet-99
    and the tiny dense-attention head on one window of 2 frames at 32 x 64,
    finite metrics."""
    metrics = peval.main(TINY_CLI + ["--backbone", "vovnet", "--head", head, "--num_samples",
                                     "1", "--queue_length", "2", "--final_dim", "32", "64"])
    assert printed_metrics(capsys.readouterr().out).keys() == metrics.keys()
    assert math.isfinite(metrics["NDS"]) and math.isfinite(metrics["mAP"])


def test_torch_ckpt_loads_mmdet_names_non_strictly(tmp_path, capsys):
    """A reference-style .pth (a ``state_dict`` inside, with BN counters the
    port has no use for and a tensor of another shape): what fits is
    copied, the rest stays, and the counts are printed as the JAX CLI
    prints them."""
    kw = dict(embed_dims=32, num_query=12, memory_len=24, topk_proposals=8, num_propagated=8,
              num_decoder_layers=2, backbone_cfg={"stage_blocks": (1, 1, 1, 1)})
    src, dst = StreamPETRWindow(**kw), StreamPETRWindow(**kw)
    src.init_weights(torch.Generator().manual_seed(1), zero_init_std=0.02)
    dst.init_weights(torch.Generator().manual_seed(2))
    sd = dict(src.state_dict())
    sd["img_backbone.bn1.num_batches_tracked"] = torch.tensor(0)
    wrong = "pts_bbox_head.reference_points.weight"
    sd[wrong] = torch.zeros(5, 3)
    path = tmp_path / "streampetr.pth"
    torch.save({"state_dict": sd, "meta": {}}, path)
    report = peval.load_reference_checkpoint(dst, str(path))
    assert report == {"restored": len(sd) - 2, "missing": 1, "unexpected": 2}
    assert "StreamPETR restore: 1 missing, 2 unexpected" in capsys.readouterr().out
    got, want = dst.state_dict(), src.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if k != wrong)
    assert not torch.equal(got[wrong], want[wrong])


@pytest.mark.parametrize("backbone, head", [("eva", "sparse"), ("eva", "petr"),
                                           ("eva", "sparse_v3"), ("r50", "sparse_v3"),
                                           ("vovnet", "sparse_v4")])
def test_tiny_cli_runs_eva_and_the_proposal_query_heads(backbone, head, capsys, two_threads):
    """``--backbone eva --num_levels 4`` (EVA-02 at the CLI's widths, its
    adapter the neck) with the sparse, PETR and v3 heads, and ``--head
    sparse_v3|sparse_v4`` (no proposals: the learned queries) on the other
    backbones: one window of 2 frames at 32 x 64, finite metrics."""
    flags = ["--num_levels", "4"] if backbone == "eva" else []
    metrics = peval.main(TINY_CLI + flags + ["--backbone", backbone, "--head", head,
                                             "--num_samples", "1", "--queue_length", "2",
                                             "--final_dim", "32", "64"])
    assert printed_metrics(capsys.readouterr().out).keys() == metrics.keys()
    assert math.isfinite(metrics["NDS"]) and math.isfinite(metrics["mAP"])


@pytest.mark.parametrize("flags, error, match", [
    (["--backbone", "eva"], ValueError, "eva neck gave 4 levels, the head takes num_levels 5"),
    (["--ckpt", "orbax_tree"], SystemExit, "Not queued"),
])
def test_cli_refuses_what_is_not_ported(flags, error, match):
    with pytest.raises(error, match=match):
        peval.main(TINY_CLI + flags)


def test_cli_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(["--synthetic", "--tiny"])


def test_eval_dataset_windows_equal_jax():
    """Windows, clip-aligned offsets and ground truth of the port's copy
    equal the JAX dataset's, array for array."""
    def loader(path):
        return np.full((32, 64, 3), float(len(path) % 255), np.float32)

    for clip_len in (None, 2):
        kw = dict(queue_length=2, final_dim=(32, 64), image_loader=loader,
                  gen_clip_len=clip_len)
        ours = GenNuScenesEvalDataset(infos=make_synthetic_infos(num_frames=6, seed=3), **kw)
        ref = JaxEvalDataset(infos=jax_infos(num_frames=6, seed=3), **kw)
        for i in range(6):
            got, want = ours.sliding_window(i), ref.sliding_window(i)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
            g, w = ours.gt_for(i, ["car", "truck"]), ref.gt_for(i, ["car", "truck"])
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_collect_results_cpu_multirank(tmp_path):
    """Three ranks with a stand-in barrier: the shards come back in dataset
    order on rank 0, the others get None, the part files are removed."""
    world = 3
    shards = {r: [(i, {"val": i}) for i in range(r, 10, world)] for r in range(world)}
    out = {r: collect_results_cpu(shards[r], str(tmp_path / "c"), r, world,
                                  barrier=lambda name: None) for r in (1, 2, 0)}
    assert out[1] is None and out[2] is None
    assert [x["val"] for x in out[0]] == list(range(10))
    assert not list((tmp_path / "c").iterdir())
    one = collect_results_cpu(shards[0], str(tmp_path / "d"), 0, 1)
    assert [x["val"] for x in one] == [0, 3, 6, 9]


@pytest.mark.slow
def test_generation_to_eval_round_trip_on_the_port(tmp_path, capsys):
    """``inference_torch.py --synthetic --tiny`` writes a Gen-nuScenes tree
    and ``eval_perception_torch.py --gen_root`` reads every frame of its
    windows back, as ``tests/test_e2e_gen_eval.py`` does for the JAX CLIs."""
    inference.main(TINY_CLI + ["--num_batches", "1", "--outdir", str(tmp_path), "--name", "e2e",
                               "--seed", "0"])
    gen_root = os.path.join(tmp_path, "e2e", "val", "gen-nuscenes")
    metrics = peval.main(TINY_CLI + ["--gen_root", gen_root, "--gen_clip_len", "2",
                                     "--queue_length", "2", "--final_dim", "16", "32",
                                     "--num_levels", "3", "--num_samples", "1"])
    assert math.isfinite(metrics["NDS"]) and math.isfinite(metrics["mAP"])
    assert metrics["gen_frames_missing"] == 0 and metrics["gen_frames_loaded"] > 0
