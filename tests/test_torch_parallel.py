"""The port's data parallelism (``panacea_tpu_torch/parallel``) on the CPU:
the process group, device and shard rules, the collectives over gloo, and
the clip-parallel inference and perception eval CLIs on 2 ranks under
``torchrun`` against one process.

The ranks run ``tests/torch_dist_worker.py`` (``scripts/dist_rank.py``)
with ``--device cpu``, torch and BLAS on two threads each; they import no
JAX. Tolerances: the shard and device rules and the file trees exactly;
each rank's sampled latents within 1e-5 of the largest latent of the same
clips sampled in this process; the eval's metrics exactly and its merged
predictions within 1e-5 of the largest value.
"""

import contextlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_parity import two_threads  # noqa: F401

from panacea_tpu_torch import inference
from panacea_tpu_torch.models.engine import DiffusionEngine3D, resolve_device
from panacea_tpu_torch.parallel import mesh
from panacea_tpu_torch.parallel import train as ptrain
from panacea_tpu_torch.perception import eval as peval
from panacea_tpu_torch.perception import metrics as pmetrics

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
TORCHRUN_VARS = mesh.RENDEZVOUS_VARS + ("LOCAL_WORLD_SIZE", mesh.BACKEND_VAR)


def torchrun(args, nproc=2, timeout=240):
    """``args`` under ``torchrun --standalone`` on ``nproc`` CPU ranks of two
    threads; the rank reports (``{"rank_report": ...}`` lines) by rank."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(nproc), *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    reports = rank_reports(out.stdout)
    return {r["rank"]: r for r in reports}


def rank_reports(text: str) -> list:
    """The ``{"rank_report": ...}`` objects in ``text``, wherever another
    rank's output left them on a line."""
    decoder, out = json.JSONDecoder(), []
    for line in text.splitlines():
        at = line.find('{"rank_report"')
        if at >= 0:
            out.append(decoder.raw_decode(line[at:])[0]["rank_report"])
    return out


def check_ranks(reports, nproc=2, backend="gloo", device="cpu"):
    """Every rank reported, in a group of ``nproc`` on ``backend``, on the
    local device, without JAX."""
    assert sorted(reports) == list(range(nproc))
    for r in reports.values():
        assert (r["world"], r["backend"], r["device"]) == (nproc, backend, device), r
        assert r["jax_modules"] == [], r["jax_modules"]


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------- the rules


def test_maybe_init_distributed_is_a_noop_without_torchruns_environment(no_torchrun_env):
    """As ``tests/test_parallel.py::test_maybe_init_distributed_noop_without_coordinator``
    for JAX: no environment, no group; the context gives rank 0 of 1."""
    assert mesh.maybe_init_distributed("cpu") is False
    assert not dist.is_initialized()
    with mesh.process_group("cpu") as group:
        assert group == mesh.Group(0, 1, None, torch.device("cpu"))
        assert not dist.is_initialized()
    assert mesh.rank_world() == (0, 1)


def test_world_size_without_a_rendezvous_raises(no_torchrun_env, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no rendezvous"):
        mesh.maybe_init_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.maybe_init_distributed("cpu") is False


def test_backend_choice(no_torchrun_env, monkeypatch):
    assert mesh.backend_for("cpu") == "gloo"
    assert mesh.backend_for(None) == mesh.backend_for("cuda") == "nccl"
    monkeypatch.setenv(mesh.BACKEND_VAR, "gloo")
    assert mesh.backend_for(None) == mesh.backend_for("cpu") == "gloo"
    monkeypatch.setenv(mesh.BACKEND_VAR, "nccl")
    assert mesh.backend_for(None) == "nccl"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mesh.backend_for("cpu")
    monkeypatch.setenv(mesh.BACKEND_VAR, "mpi")
    with pytest.raises(ValueError, match="not one of"):
        mesh.backend_for(None)


@pytest.mark.parametrize("local_world, cards, refused", [(2, 1, True), (2, 2, False)])
def test_nccl_refuses_more_local_ranks_than_cards(no_torchrun_env, monkeypatch, local_world,
                                                 cards, refused):
    """NCCL puts one rank on a card: more ranks than cards raises, naming the
    variable that lets them share a card over gloo; nothing falls back."""
    env = dict(RANK="0", WORLD_SIZE=str(local_world), LOCAL_RANK="0",
               LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="localhost", MASTER_PORT="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    made = []
    monkeypatch.setattr(dist, "init_process_group", made.append)
    if refused:
        with pytest.raises(RuntimeError, match=f"{mesh.BACKEND_VAR}=gloo"):
            mesh.maybe_init_distributed(None)
        assert made == [] and bound == []
    else:
        assert mesh.maybe_init_distributed(None) is True
        assert made == ["nccl"] and bound == [torch.device("cuda", 0)]


def test_local_device(no_torchrun_env, monkeypatch):
    """The CPU where asked; without a card anything else raises; the local
    rank's card under torchrun (modulo the cards, where gloo shares them),
    made the current one; plain cuda outside torchrun."""
    assert mesh.local_device("cpu") == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.local_device(device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    assert mesh.local_device(None) == torch.device("cuda") and bound == []
    for local, want in (("0", 0), ("1", 1), ("3", 1)):
        monkeypatch.setenv("LOCAL_RANK", local)
        assert mesh.local_device(None) == mesh.local_device("cuda") == torch.device("cuda", want)
    assert bound == [torch.device("cuda", w) for w in (0, 0, 1, 1, 1, 1)]
    assert mesh.local_device("cuda:0") == torch.device("cuda", 0)


@pytest.mark.parametrize("t, n_total, world", [(8, 6, 2), (8, 7, 3), (2, 1, 2), (4, 9, 4)])
def test_shard_indices_are_the_jax_clis_slices(t, n_total, world):
    """``indices[proc::nproc]`` of the JAX inference CLI (inference.py:243-247)
    and of the perception CLIs (eval_perception.py:211, train_perception.py:343-346):
    disjoint, together every index."""
    seq = [t - 1 + i * t for i in range(n_total)]
    shards = [mesh.shard_indices(seq, r, world) for r in range(world)]
    assert shards == [seq[r::world] for r in range(world)]
    assert sorted(sum(shards, [])) == seq
    windows = list(range(t - 1, 3 * t))
    assert mesh.shard_indices(windows, 1, world) == windows[1::world]


def test_check_dp():
    """(dp, t) for clips of 8 frames: the JAX trainer's default dp =
    max(1, processes // frames) (train.py:146), t = processes / dp frame
    ranks a clip, which must divide the frames."""
    assert mesh.check_dp(None, 1, 8) == (1, 1) and mesh.check_dp(None, 2, 8) == (1, 2)
    assert mesh.check_dp(None, 16, 8) == (2, 8)
    assert mesh.check_dp(2, 2, 8) == (2, 1) and mesh.check_dp(2, 4, 8) == (2, 2)
    with pytest.raises(SystemExit, match="needs 2 processes"):
        mesh.check_dp(2, 1, 8)
    with pytest.raises(SystemExit, match="t = 3 frame ranks .* the clip's 8 frames"):
        mesh.check_dp(None, 3, 8)
    with pytest.raises(SystemExit, match="at least 1"):
        mesh.check_dp(0, 1, 8)


def test_rank_seeds():
    """Rank 0 keeps the seed (one process draws as before); the others differ."""
    seeds = [mesh.rank_seed(7, r) for r in range(4)]
    assert seeds[0] == 7 and len(set(seeds)) == 4
    assert seeds == [mesh.rank_seed(7, r) for r in range(4)]


def test_collectives_are_the_identity_without_a_group(no_torchrun_env):
    xs = [torch.randn(3, 2), torch.randn(5).to(torch.bfloat16)]
    assert all(a is b for a, b in zip(ptrain.allreduce_mean(xs), xs))
    assert ptrain.reduce_mean(3).item() == 3.0
    assert ptrain.mean_metrics({"a": 1.5}) == {"a": 1.5}
    assert ptrain.any_rank(True) is True and ptrain.any_rank(False) is False
    before = [x.clone() for x in xs]
    ptrain.broadcast_from_rank0(xs)
    ptrain.assert_same(xs)
    ptrain.barrier()
    assert all(torch.equal(a, b) for a, b in zip(xs, before))


COLLECTIVES = '''
import os, sys, torch
sys.path.insert(0, {root!r})
from panacea_tpu_torch.parallel import mesh, train
with mesh.process_group("cpu") as g:
    r = g.rank
    xs = [torch.full((3, 5), float(r + 1)), torch.arange(7.0) * (r + 1),
          torch.full((4,), r + 1.0).to(torch.bfloat16)]
    # buckets of 64 bytes: the first and last tensors alone, a collective each
    got = train.allreduce_mean(xs, bucket_bytes=64)
    assert all(a.dtype == torch.float32 and a.shape == x.shape for a, x in zip(got, xs))
    assert torch.equal(got[0], torch.full((3, 5), 1.5))
    assert torch.equal(got[1], torch.arange(7.0) * 1.5)
    assert torch.equal(got[2], torch.full((4,), 1.5))
    assert train.reduce_mean(torch.tensor(r * 2)).item() == 1.0
    assert train.mean_metrics({{"a": float(r), "b": 4.0}}) == {{"a": 0.5, "b": 4.0}}
    assert train.any_rank(r == 1) is True and train.any_rank(False) is False
    ps = [torch.full((2, 2), float(r)), torch.tensor([r], dtype=torch.int64)]
    train.broadcast_from_rank0(ps, bucket_bytes=8)
    assert torch.equal(ps[0], torch.zeros(2, 2)) and ps[1].item() == 0
    try:
        train.assert_same([torch.full((2,), float(r))])
        raise SystemExit("assert_same passed tensors that differ")
    except RuntimeError as e:
        assert "differ" in str(e)
    train.barrier()
    os.write(1, f"collectives ok {{r}} {{g.backend}}\\n".encode())   # one write: ranks share stdout
'''


def test_collectives_over_gloo(tmp_path):
    """allreduce_mean in buckets (fp32 means), reduce_mean, mean_metrics,
    any_rank, broadcast_from_rank0 and assert_same on 2 CPU ranks."""
    script = tmp_path / "collectives.py"
    script.write_text(COLLECTIVES.format(root=os.path.abspath(ROOT)))
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", str(script)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert sorted(re.findall(r"collectives ok (\d) (\w+)", out.stdout)) == [("0", "gloo"),
                                                                           ("1", "gloo")]


# ------------------------------------------------------ clip-parallel CLIs


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_clip_parallel_inference_matches_one_process(tmp_path, monkeypatch):
    """2 ranks of the tiny CLI with --num_batches 2 write together exactly
    the files of one process over the same 4 clips; each rank's latents
    equal those this process samples for the same clips and generators
    (rank r's clips, its dataset stream and seeds from its own offset)."""
    common = ["--synthetic", "--tiny", "--device", "cpu", "--name", "dp"]
    reports = torchrun([WORKER, "inference", "--dump", str(tmp_path / "ranks"), "--"]
                       + common + ["--num_batches", "2", "--outdir", str(tmp_path / "two")])
    check_ranks(reports)
    assert [reports[r]["clips"] for r in (0, 1)] == [2, 2]

    inference.main(common + ["--num_batches", "4", "--outdir", str(tmp_path / "one")])
    assert tree(tmp_path / "two") == tree(tmp_path / "one")
    assert len(tree(tmp_path / "one")) > 4

    sampled = []
    sample = DiffusionEngine3D.sample

    def recorded(self, *a, **kw):
        out = sample(self, *a, **kw)
        sampled.append(out.detach().float())
        return out

    monkeypatch.setattr(DiffusionEngine3D, "sample", recorded)
    for r in (0, 1):
        # this process as rank r of 2, without a group
        @contextlib.contextmanager
        def as_rank(device=None, r=r):
            yield mesh.Group(r, 2, None, torch.device("cpu"))

        monkeypatch.setattr(mesh, "process_group", as_rank)
        sampled.clear()
        inference.main(common + ["--num_batches", "2", "--outdir", str(tmp_path / f"r{r}")])
        got = torch.load(tmp_path / "ranks" / f"rank{r}.pt")["latents"]
        assert len(got) == len(sampled) == 2
        for a, b in zip(got, sampled):
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-5 * scale, r


def test_clip_parallel_perception_eval_matches_one_process(tmp_path, monkeypatch):
    """2 ranks of the tiny eval: rank 0's merged predictions and metrics are
    one process's."""
    common = ["--synthetic", "--tiny", "--device", "cpu"]
    reports = torchrun([WORKER, "perception_eval", "--dump", str(tmp_path / "ranks"), "--"]
                       + common + ["--out", str(tmp_path / "two.json")])
    check_ranks(reports)
    preds = []
    evaluate = pmetrics.evaluate_detections

    def recorded(p, g, *a, **kw):
        preds.append(p)
        return evaluate(p, g, *a, **kw)

    monkeypatch.setattr(pmetrics, "evaluate_detections", recorded)
    want = peval.main(common + ["--out", str(tmp_path / "one.json")])
    with open(tmp_path / "two.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(want))
    assert reports[0]["metrics"] == {k: float(v) for k, v in want.items()}
    assert reports[1]["metrics"] == {}      # rank 1 scores nothing
    merged = torch.load(tmp_path / "ranks" / "rank0.pt")["predictions"]
    assert len(merged) == len(preds[0]) == 5
    for a, b in zip(merged, preds[0]):
        assert torch.equal(a["labels"], torch.as_tensor(b["labels"]))
        for k in ("boxes", "scores"):
            want_k = torch.as_tensor(b[k])
            assert np.allclose(a[k].numpy(), want_k.numpy(), rtol=0,
                               atol=1e-5 * max(want_k.abs().max().item(), 1.0))
