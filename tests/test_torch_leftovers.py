"""The port's last small modules against the JAX package: ``.safetensors``
reading (``checkpoint.read_safetensors``, without the ``safetensors``
package), ``utils/profiling.trace`` and ``trace_summary``, and
``data/nuscenes/render_bev.py``."""

import json
import os
import struct

import numpy as np
import pytest
import torch
from torch_parity import two_threads  # noqa: F401

from panacea_tpu_torch import checkpoint
from panacea_tpu_torch.configs import TINY_CPU
from panacea_tpu_torch.registry import instantiate_from_config
from panacea_tpu_torch.utils import profiling

pytestmark = pytest.mark.usefixtures("two_threads")


# ------------------------------------------------------------- .safetensors


def test_safetensors_matches_the_jax_reader(tmp_path):
    """A file the ``safetensors`` package wrote, in F32 / F16 / I64 (and
    metadata): the port's tensors equal the JAX ``load_torch_checkpoint``'s
    arrays."""
    st = pytest.importorskip("safetensors.numpy")
    from panacea_tpu.utils.convert import load_torch_checkpoint as jax_load

    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
              "b.half": rng.standard_normal((4, 2, 3)).astype(np.float16),
              "c.index": np.arange(-3, 9, dtype=np.int64).reshape(3, 4),
              "d.scalar": np.array(2.5, dtype=np.float32),
              "e.empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "w.safetensors")
    st.save_file(arrays, path, metadata={"format": "np"})
    got, want = checkpoint.load_torch_checkpoint(path), jax_load(path)
    assert sorted(got) == sorted(want) == sorted(arrays)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v), k


def test_safetensors_bf16_matches_torch(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    x = {"w": torch.randn(7, 3, generator=torch.Generator().manual_seed(1)).bfloat16(),
         "i": torch.arange(5, dtype=torch.int32)}
    path = str(tmp_path / "b.safetensors")
    st.save_file(x, path)
    got = checkpoint.read_safetensors(path)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x["w"])
    assert got["i"].dtype == torch.int32 and torch.equal(got["i"], x["i"])


def _write(path, header: dict, data: bytes, length=None):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw) if length is None else length) + raw + data)


def test_safetensors_built_by_hand(tmp_path):
    """The format written here byte by byte, without the package."""
    a = np.arange(6, dtype="<f4").reshape(2, 3)
    b = np.array([[1, -2]], dtype="<i8")
    h = np.array([0.5, -1.25], dtype="<f2")
    data = a.tobytes() + b.tobytes() + h.tobytes()
    o1, o2 = a.nbytes, a.nbytes + b.nbytes
    path = str(tmp_path / "hand.safetensors")
    _write(path, {"__metadata__": {"k": "v"},
                  "a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, o1]},
                  "b": {"dtype": "I64", "shape": [1, 2], "data_offsets": [o1, o2]},
                  "h": {"dtype": "F16", "shape": [2], "data_offsets": [o2, len(data)]}}, data)
    got = checkpoint.read_safetensors(path)
    assert sorted(got) == ["a", "b", "h"]
    for k, v in (("a", a), ("b", b), ("h", h)):
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize("case", ["truncated", "not_json", "past_the_data"])
def test_malformed_safetensors_raises_naming_the_file(tmp_path, case):
    path = str(tmp_path / f"{case}.safetensors")
    entry = {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}
    if case == "truncated":
        _write(path, entry, b"", length=4096)
    elif case == "not_json":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 5) + b"{abc:" + bytes(16))
    else:
        _write(path, entry, bytes(8))
    with pytest.raises(ValueError, match=f"{case}.safetensors"):
        checkpoint.load_torch_checkpoint(path)


def test_tiny_engine_from_safetensors_equals_ckpt(tmp_path):
    """The same weights as ``.ckpt`` and as ``.safetensors``: the engine loads
    both into the same state."""
    st = pytest.importorskip("safetensors.torch")
    src = instantiate_from_config(TINY_CPU["model"], device="cpu")
    src.init_weights(torch.Generator().manual_seed(3), zero_init_std=0.02)
    sd = {k: v.detach().clone().contiguous() for k, v in src.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "w.ckpt")
    st.save_file(sd, str(tmp_path / "w.safetensors"))
    states = []
    for name in ("w.ckpt", "w.safetensors"):
        eng = instantiate_from_config(TINY_CPU["model"], device="cpu")
        rep = checkpoint.load_checkpoint(str(tmp_path / name), eng)
        assert rep["total_keys"] == len(sd)
        states.append(eng.state_dict())
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    assert all(torch.equal(states[1][k], sd[k]) for k in sd)


# ------------------------------------------------------------- profiling


def test_trace_writes_a_trace_and_the_cpu_has_no_device_time(tmp_path):
    """A trace of the tiny engine's training step on the CPU: a Chrome trace
    is written under the directory, and its summary is None, as the JAX
    ``hlo_stats_summary`` returns None for a bare CPU trace."""
    import torch_train_grid_checks as grid_checks

    eng, batch = grid_checks.tiny_engine("spatial"), grid_checks.global_batch()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir, enabled=False):
        pass
    assert not os.path.exists(logdir)
    with profiling.trace(logdir):
        loss, _, _, _ = grid_checks.one_step(eng, batch, None, slice(None), slice(None))
    assert np.isfinite(loss)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(logdir, files[0])) as f:
        assert json.load(f)["traceEvents"]
    assert profiling.trace_summary(logdir) is None
    assert profiling.trace_summary(str(tmp_path / "none")) is None


def test_device_summary_buckets_as_the_jax_package():
    got = profiling.device_summary([
        ("void tc::pn_flash_f32_fwd_tc<64>(Params)", 2.0), ("pn_geglu_fwd", 1.0),
        ("sm90_xmma_gemm_bf16bf16_bf16f32", 3.0), ("cudnn::nhwc_conv_fprop", 4.0),
        ("Memcpy DtoH (Device -> Pageable)", 0.5), ("reduce_kernel<512, 1>", 1.5),
        ("vectorized_elementwise_kernel<4>", 0.25), ("some_other_kernel", 0.125)])
    assert got["device_ms"] == 12.375
    assert got["bucket_ms"] == {"matmul": 7.0, "pallas": 3.0, "reduces": 1.5, "copies": 0.5,
                                "elementwise": 0.25, "other": 0.125}
    assert got["kernel_ms"] == {"pn_flash_f32_fwd_tc": 2.0, "pn_geglu_fwd": 1.0}
    assert got["port_bucket_ms"]["flash_attention"] == 2.0 and got["port_bucket_ms"]["conv"] == 4
    assert profiling.device_summary([]) is None


# ------------------------------------------------------------- render_bev


def test_render_bev_equals_the_jax_module(tmp_path):
    """The inputs of tests/test_map_extractor.py::test_render_bev_debug_outputs:
    every image and every file bit for bit."""
    pytest.importorskip("cv2")
    from panacea_tpu.data.nuscenes import render_bev as jax_bev

    from panacea_tpu_torch.data.nuscenes import render_bev as bev

    id2cat = {0: "divider", 1: "ped_crossing", 2: "boundary"}
    vectors = {0: [np.array([[0.0, 5.0], [10.0, 5.0]])],
               2: [np.array([[-10.0, -5.0], [-10.0, 5.0]])]}
    a = bev.render_bev_from_vectors(vectors, id2cat, roi_size=(60, 30), px_per_m=10)
    b = jax_bev.render_bev_from_vectors(vectors, id2cat, roi_size=(60, 30), px_per_m=10)
    assert a.shape == (300, 600, 3) and np.array_equal(a, b)
    mask = np.zeros((3, 40, 80), np.uint8)
    mask[1, 10:20, 30:50] = 1
    cats = {0: "drivable_area", 1: "divider", 2: "boundary"}
    assert np.array_equal(bev.render_bev_from_mask(mask, cats),
                          jax_bev.render_bev_from_mask(mask, cats))
    K = np.eye(4)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = 200, 256, 200, 128
    R = np.eye(4)
    R[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    l2i = K @ R
    views = bev.render_camera_views_from_vectors(vectors, [l2i] * 6, id2cat)
    want = jax_bev.render_camera_views_from_vectors(vectors, [l2i] * 6, id2cat)
    assert len(views) == 6 and all(np.array_equal(x, y) for x, y in zip(views, want))
    assert any((v != 255).any() for v in views)
    got = bev.save_bev_debug(vectors, [l2i] * 6, id2cat, str(tmp_path / "port"),
                             semantic_mask=mask)
    ref = jax_bev.save_bev_debug(vectors, [l2i] * 6, id2cat, str(tmp_path / "jax"),
                                 semantic_mask=mask)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(got) == 8
    for p, q in zip(got, ref):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read(), p
