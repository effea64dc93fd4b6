"""Data-parallel training of the port on the CPU: the generator's trainer
and the detector's on 2 ranks under ``torchrun`` (gloo) against one process
with the same global batch, an exact resume on 2 ranks, and the detector
loss's avg-factor hook against the JAX functions' ``reduce_fn``.

The one-process trainers are held against the JAX package elsewhere
(``tests/test_torch_train.py``, ``tests/test_torch_perception_train.py``).
Tolerances: losses and loss terms within 1e-5 relative; the parameters
within 1e-5 of their norm, and the step's update (the parameters less the
random init) within 1e-4 of its norm (a rank's avg factor left out of the
ranks' mean moves it by about 1e-1); the resume exactly; the hook within
1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_parallel import WORKER, check_ranks, torchrun
from torch_parity import two_threads  # noqa: F401

from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import train as jtrain
from panacea_tpu_torch import configs, train
from panacea_tpu_torch.perception import atss, denoise
from panacea_tpu_torch.perception import train as ptrain

pytestmark = pytest.mark.usefixtures("two_threads")
GEN = ["--tiny", "--synthetic", "--device", "cpu", "--bs", "2", "--steps", "2", "--use_ema",
       "--freeze_type", "spatial"]


def rel(a, b) -> float:
    """|a - b| / |b| over dicts of tensors (their joint norm)."""
    num = sum(float((a[k].double() - b[k].double()).norm() ** 2) for k in b)
    den = sum(float(b[k].double().norm() ** 2) for k in b)
    return (num / den) ** 0.5


def update_rel(got, want, init) -> float:
    keys = [k for k in want if want[k].dtype.is_floating_point]
    return rel({k: got[k] - init[k] for k in keys}, {k: want[k] - init[k] for k in keys})


@pytest.fixture(scope="module")
def generator_runs(tmp_path_factory):
    """The 2-rank run (--dp 2, an iter_N a step), its resume from iter_1 on
    2 ranks at --dp 2 (2 ranks default to t 2 on the tiny config's 2
    frames), one process with the same global batch, and the random init
    (a run of 0 steps)."""
    root = tmp_path_factory.mktemp("gen_dp")
    two = torchrun([WORKER, "--record_saves", str(root / "saves"), "train", "--dump",
                    str(root / "ranks"), "--"] + GEN
                   + ["--dp", "2", "--ckpt_every", "1", "--ckpt_dir", str(root / "two")])
    resumed = torchrun([WORKER, "train", "--"] + GEN
                       + ["--dp", "2", "--resume", str(root / "two" / "iter_1"),
                          "--ckpt_every", "0", "--ckpt_dir", str(root / "resumed")])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = train.main(GEN + ["--ckpt_every", "0", "--ckpt_dir", str(root / "one")])
        train.main(["--tiny", "--synthetic", "--device", "cpu", "--steps", "0", "--freeze_type",
                    "spatial", "--ckpt_every", "0", "--ckpt_dir", str(root / "init")])
    finally:
        torch.set_num_threads(threads)
    return root, two, resumed, one


def test_generator_dp_step_matches_one_process(generator_runs):
    """``--dp 2 --bs 2`` on 2 ranks: each rank's losses, the parameters and
    the EMA after 2 steps (``spatial``: the temporal ones trained) are the
    one-process ``--bs 2`` run's; every rank on the CPU, without JAX."""
    root, two, _, one = generator_runs
    check_ranks(two)
    for r in (0, 1):
        losses = two[r]["losses"]
        assert len(losses) == 2
        assert np.allclose(losses, one["losses"], rtol=1e-5, atol=0), (losses, one["losses"])
        assert two[r]["allreduce_bytes_per_step"] == 4 * two[r]["trained_params"] > 0
    load = lambda *p: torch.load(os.path.join(root, *p))  # noqa: E731
    init = load("init", "final.pt")
    for name in ("final.pt", "final_ema.pt"):
        got, want = load("two", name), load("one", name)
        assert got.keys() == want.keys()
        assert rel(got, want) <= 1e-5, name
        if name == "final.pt":
            assert update_rel(got, want, init) <= 1e-4
            moved = [k for k in want if not torch.equal(want[k], init[k])]
            assert moved and all("temporal" in k for k in moved)
        else:
            assert update_rel(got, want, {k: init[k] for k in want}) <= 1e-4
    # the ranks' copies are one: rank 1's sampled parameters are rank 0's
    a, b = (torch.load(root / "ranks" / f"rank{r}.pt") for r in (0, 1))
    for k in a["final"]:
        assert torch.equal(a["final"][k], b["final"][k]) and torch.equal(a["ema"][k], b["ema"][k])


def test_generator_dp_resume_is_exact_and_rank0_alone_writes(generator_runs):
    """Resumed from iter_1 on 2 ranks, the second step's loss and the final
    parameters are the uninterrupted run's, bit for bit; rank 0 wrote every
    checkpoint and final file, rank 1 none."""
    root, two, resumed, _ = generator_runs
    check_ranks(resumed)
    for r in (0, 1):
        assert resumed[r]["losses"] == two[r]["losses"][1:]
    for name in ("final.pt", "final_ema.pt"):
        got = torch.load(root / "resumed" / name)
        want = torch.load(root / "two" / name)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    saves = {}
    for r in (0, 1):
        with open(root / "saves" / f"saves_rank{r}.json") as f:
            saves[r] = [p for p in json.load(f) if os.sep + "ranks" + os.sep not in p]
    assert saves[1] == []
    two_dir = str(root / "two")
    assert sorted(os.path.relpath(p, two_dir) for p in saves[0]) == sorted(
        ["iter_1/state.pt.tmp", "iter_2/state.pt.tmp", "final.pt", "final_ema.pt",
         "engine_final.ckpt"])
    assert sorted(os.listdir(two_dir)) == ["engine_final.ckpt", "final.pt", "final_ema.pt",
                                           "iter_1", "iter_2"]


# --------------------------------------------------------- the detector


def window_recipe(tmp_path) -> str:
    """The window recipe with GridMask, DN and the history jitter off: the
    ranks' own draws then leave the step alone."""
    cfg = configs.PERCEPTION["streampetr_r50_atss_512x256_window"]
    p = cfg["perception"]
    p = dict(p, train=dict(p["train"], use_grid_mask=False, with_dn=False, random_length=0))
    path = tmp_path / "window.yaml"
    path.write_text(yaml.safe_dump(dict(cfg, perception=p)))
    return str(path)


def test_detector_dp_step_matches_one_process(tmp_path):
    """The tiny detector on 2 ranks of ``--batch 1`` against one process of
    ``--batch 2``: the loss terms (averaged over the ranks) and the
    parameters after one step. The windows keep 1 + key % 3 of their boxes,
    so their matched counts differ and each of the avg factors (the
    detection layers', ATSS's) must be averaged over the ranks."""
    common = ["--synthetic", "--tiny", "--device", "cpu", "--steps", "1", "--ckpt_every", "0",
              "--config", window_recipe(tmp_path), "--queue_length", "2", "--final_dim", "32",
              "64", "--num_levels", "3"]
    two = torchrun([WORKER, "--uneven_gt", "perception_train", "--dump", str(tmp_path / "two"),
                    "--"] + common + ["--batch", "1", "--workdir", str(tmp_path / "w2")])
    check_ranks(two)
    one = torchrun([WORKER, "--uneven_gt", "perception_train", "--dump", str(tmp_path / "one"),
                    "--"] + common + ["--batch", "2", "--workdir", str(tmp_path / "w1")], nproc=1)
    want = one[0]["final_metrics"]
    assert {"loss_cls", "loss_bbox", "loss_atss_cls", "loss_atss_bbox",
            "loss_atss_ctr"} <= set(want)
    for r in (0, 1):
        got = two[r]["final_metrics"]
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    a, b = (torch.load(tmp_path / d / "rank0.pt") for d in ("two", "one"))
    assert all(torch.equal(a["init"][k], b["init"][k]) for k in b["init"])
    # the ranks' copies are one: rank 1's sampled parameters are rank 0's
    a1 = torch.load(tmp_path / "two" / "rank1.pt")
    assert all(torch.equal(a["final"][k], a1["final"][k]) for k in a["final"])
    assert rel(a["final"], b["final"]) <= 1e-5
    assert update_rel(a["final"], b["final"], b["init"]) <= 1e-4
    written = torch.load(tmp_path / "w2" / "window" / "final.pt")
    assert written.keys() == torch.load(tmp_path / "w1" / "window" / "final.pt").keys()


# ------------------------------------------------------ the avg-factor hook

FIXED = 7.25   # what every reduce_fn returns: another rank's count averaged in


def test_atss_loss_reduce_fn_matches_jax():
    """``atss_loss`` with a ``reduce_fn`` that returns a fixed value, at both
    of its sites (the positive count, :186; the total centerness, :199),
    against the JAX function with the same hook."""
    rng = np.random.default_rng(3)
    shapes = [(8, 16), (4, 8)]
    anchors = atss.grid_anchors(shapes)
    boxes2d, labels2d = [], []
    for _ in range(2):
        xy = rng.uniform(0, 100, (3, 2))
        boxes2d.append(np.concatenate([xy, xy + rng.uniform(10, 40, (3, 2))], 1)
                       .astype(np.float32))
        labels2d.append(rng.integers(0, 10, 3))
    outs = [tuple(rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for c in (10, 4, 1))
            for h, w in shapes]
    want = jtrain.atss_loss([tuple(jnp.asarray(x) for x in o) for o in outs], anchors,
                            jtrain.atss_targets(anchors, boxes2d, labels2d),
                            reduce_fn=lambda x: FIXED)
    got = ptrain.atss_loss([tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in o)
                            for o in outs], anchors,
                           ptrain.atss_targets(anchors, boxes2d, labels2d),
                           reduce_fn=lambda x: FIXED)
    plain = ptrain.atss_loss([tuple(torch.from_numpy(x).permute(0, 3, 1, 2) for x in o)
                              for o in outs], anchors,
                             ptrain.atss_targets(anchors, boxes2d, labels2d))
    assert got.keys() == want.keys()
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * abs(w), k
        assert abs(float(plain[k]) - w) > 1e-3 * abs(w), k     # the hook moved every term


def test_dn_loss_reduce_fn_matches_jax():
    """``dn_loss`` with a ``reduce_fn`` that returns a fixed value (num_tgt,
    :132) against the JAX function with the same hook, the same pack."""
    rng = np.random.default_rng(4)
    b, gmax, scalar = 2, 5, 4
    boxes = np.zeros((b, gmax, 9), np.float32)
    labels = np.full((b, gmax), -1, np.int64)
    for i, g in enumerate((5, 2)):
        boxes[i, :g, :2] = rng.uniform(-40, 40, (g, 2))
        boxes[i, :g, 2] = rng.uniform(-2, 0, g)
        boxes[i, :g, 3:6] = rng.uniform(0.5, 5, (g, 3))
        labels[i, :g] = rng.integers(0, 10, g)
    noise = rng.uniform(-1, 1, (b, gmax * scalar, 3)).astype(np.float32)
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    pack = denoise.prepare_dn(torch.from_numpy(boxes), torch.from_numpy(labels), num_query=12,
                              num_propagated=4, memory_len=24, pc_range=pc, scalar=scalar,
                              rand_prob=torch.from_numpy(noise))
    jpack = jdenoise.DNPack(*(jnp.asarray(t.numpy()) if torch.is_tensor(t) else t
                              for t in pack))
    cls = rng.normal(0, 2, (3, b, gmax * scalar, 10)).astype(np.float32)
    reg = rng.normal(0, 2, (3, b, gmax * scalar, 10)).astype(np.float32)
    want = float(jdenoise.dn_loss(jnp.asarray(cls), jnp.asarray(reg), jpack, pc,
                                  reduce_fn=lambda x: FIXED))
    got = float(denoise.dn_loss(torch.from_numpy(cls), torch.from_numpy(reg), pack, pc,
                                reduce_fn=lambda x: FIXED))
    plain = float(denoise.dn_loss(torch.from_numpy(cls), torch.from_numpy(reg), pack, pc))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(plain - want) > 1e-3 * abs(want)
