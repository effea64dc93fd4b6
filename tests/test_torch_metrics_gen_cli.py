"""The port's FID/FVD CLI (``eval_generation_torch.py``) against the JAX
package's ``eval_generation.py``: its flags and defaults, its honesty guard,
the synthetic self-test on the CPU, a frame tree scored by both CLIs with
the same tower checkpoints, and a checkpoint missing a tensor."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from panacea_tpu.metrics_gen import fid as jfid
from panacea_tpu.metrics_gen.i3d import I3D as JaxI3D
from panacea_tpu.metrics_gen.inception import InceptionV3 as JaxInceptionV3
from panacea_tpu.utils.convert import (build_i3d_mapping, build_inception_mapping,
                                       convert_state_dict, load_torch_checkpoint)
from panacea_tpu_torch.metrics_gen import eval as geval

ROOT = os.path.join(os.path.dirname(__file__), "..")
# FID and FVD of the two CLIs on the same tree and weights, relative
TREE_TOL = 1e-4
# the tree's frames at the towers' smallest inputs (the CLI's 299 and 224
# cost the same code path many times the time)
SMALL_HW = {"INCEPTION_HW": (75, 75), "I3D_HW": (32, 32)}


@pytest.fixture(autouse=True)
def two_threads():
    """Two threads for torch and BLAS. The test workers share the machine's
    cores, and there many-threaded convolutions wait on each other's threads
    at every layer: in a whole parallel run the synthetic self-test took
    156 s on every thread, against 6 s alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(threads)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_generation", os.path.join(ROOT, "eval_generation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """real/ and gen/, two clips of 8 frames each (and a short clip that
    both CLIs skip), the Gen-nuScenes layout."""
    root = tmp_path_factory.mktemp("frames")
    rs = np.random.RandomState(0)
    for name, shift in (("real", 0), ("gen", 60)):
        for clip, n in ((0, 8), (1, 8), (2, 5)):
            d = root / name / f"CAM_FRONT_clip{clip}"
            d.mkdir(parents=True)
            for i in range(n):
                arr = rs.randint(0, 196, (32, 48, 3)) + shift
                Image.fromarray(arr.astype("uint8")).save(d / f"_{i:06d}.jpg")
    return root


def test_parser_has_the_jax_clis_flags_and_defaults(monkeypatch):
    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed) as got:
        _jax_cli().main([])
    monkeypatch.undo()

    def flags(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices, a.nargs, type(a))
                for a in p._actions if a.dest != "help"}

    jax_flags, port_flags = flags(got.value.args[0]), flags(geval.get_parser())
    assert port_flags.pop("device")[1] is None
    assert port_flags == jax_flags


def test_cli_refuses_random_towers_on_directories(tree):
    out = subprocess.run(
        [sys.executable, "eval_generation_torch.py", "--real_root", str(tree / "real"),
         "--gen_root", str(tree / "gen"), "--batch", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "random-init" in out.stderr


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        geval.main(["--synthetic"])


def test_synthetic_self_test_on_the_cpu(capsys):
    res = geval.main(["--synthetic", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"fid": round(res["fid"], 4), "fvd": round(res["fvd"], 4),
                    "synthetic": True, "towers": "random-init"}
    assert np.isfinite(res["fid"]) and np.isfinite(res["fvd"])


def test_tree_scored_like_the_jax_cli(tree, tmp_path, capsys, monkeypatch):
    """Both CLIs score the same tree with the same tower checkpoints, saved
    the way torchvision / pytorch-i3d save them (a ``state_dict`` entry,
    DeepSpeed's prefix, ``AuxLogits``/``fc`` and ``num_batches_tracked``
    beside the tower): the port's ``main`` against the JAX CLI's pieces
    (its clip collection, image loading, batching, checkpoint conversion,
    towers and Frechet distances), the frames resized to SMALL_HW."""
    for name, hw in SMALL_HW.items():
        monkeypatch.setattr(geval, name, hw)
    src_inc, src_i3d = geval.build_towers("cpu", seed=5)
    inc_sd = dict(src_inc.state_dict())
    inc_sd.update({"AuxLogits.fc.weight": torch.zeros(2, 3), "fc.bias": torch.zeros(1000),
                   "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(3)})
    torch.save({"state_dict": inc_sd}, tmp_path / "inception.pth")
    torch.save({"_forward_module." + k: v for k, v in src_i3d.state_dict().items()},
               tmp_path / "i3d.pt")
    ckpts = {"inception": str(tmp_path / "inception.pth"), "i3d": str(tmp_path / "i3d.pt")}
    got = geval.main(["--real_root", str(tree / "real"), "--gen_root", str(tree / "gen"),
                      "--inception_ckpt", ckpts["inception"], "--i3d_ckpt", ckpts["i3d"],
                      "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr()
    assert "[inception] restore: 0 missing, 3 dropped" in out.err
    assert "[i3d] restore: 0 missing, 0 dropped" in out.err
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last == {"fid": round(got["fid"], 4), "fvd": round(got["fvd"], 4),
                    "real_clips": 2, "gen_clips": 2, "towers": "converted"}

    jcli = _jax_cli()
    real = jcli.collect_clips(str(tree / "real"))
    gen = jcli.collect_clips(str(tree / "gen"))
    assert real == geval.collect_clips(str(tree / "real")) and len(gen) == 2

    def jparams(name, mapping):
        params, missing, _ = convert_state_dict(load_torch_checkpoint(ckpts[name]), mapping())
        assert not missing
        return params

    inc_p = jparams("inception", build_inception_mapping)
    i3d_p = jparams("i3d", build_i3d_mapping)
    inc_fn = jax.jit(lambda x: JaxInceptionV3().apply({"params": inc_p}, x))
    i3d_fn = jax.jit(lambda x: JaxI3D().apply({"params": i3d_p}, x))

    def frames(clips):
        paths = [f for fr in clips.values() for f in fr]
        for i in range(0, len(paths), 4):
            yield np.asarray(inc_fn(np.stack([jcli.load_image(p, SMALL_HW["INCEPTION_HW"])
                                              for p in paths[i:i + 4]])))

    def videos(clips):
        vids = [np.stack([jcli.load_image(f, SMALL_HW["I3D_HW"]) for f in fr])
                for fr in clips.values()]
        for i in range(0, len(vids), 2):
            yield np.asarray(i3d_fn(jnp.asarray(np.stack(vids[i:i + 2]))))

    want = {"fid": jfid.compute_fid(frames(real), frames(gen)),
            "fvd": jfid.compute_fvd(videos(real), videos(gen))}
    for k in want:
        # the towers agree to about 1e-7 of their largest feature (fp32, two
        # backends); the distance of 16 frames or 2 clips carries that through
        assert abs(got[k] - want[k]) <= TREE_TOL * abs(want[k]), (k, got, want)


def test_tower_checkpoint_missing_a_tensor_raises(tmp_path):
    from panacea_tpu_torch.metrics_gen.inception import InceptionV3

    sd = InceptionV3().state_dict()
    del sd["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="1 inception tensors missing"):
        geval.load_tower(InceptionV3(), str(tmp_path / "short.pth"), "inception")
