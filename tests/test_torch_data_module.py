"""The port's clip loader and data module (``panacea_tpu_torch/data/loader.py``)
against the JAX package's grain pipeline, on the CPU.

The same synthetic scene goes through both packages' datasets (equal item
for item, ``tests/test_torch_data.py``). Unshuffled, the batches are equal;
shuffled, the port's order is its own (a permutation seeded from the seed
and the epoch) and only the set of clips is grain's; a shard is grain's
contiguous range with the remainder dropped.
"""

import numpy as np
import pytest
from test_torch_data import assert_tree_equal

from panacea_tpu.data import loader as jloader
from panacea_tpu.data.nuscenes import dataset as jdataset
from panacea_tpu.data.nuscenes import synthetic as jsynthetic
from panacea_tpu_torch.data import loader
from panacea_tpu_torch.data.nuscenes import dataset, synthetic


def flat_image(path: str) -> np.ndarray:
    """A camera frame of one grey level drawn from its path: the source
    size, at a fraction of the synthetic noise image's cost."""
    return np.full((900, 1600, 3), synthetic.path_seed(path) % 256, np.uint8)


def ds_config(mod_synthetic=synthetic, frames: int = 7, t: int = 2):
    """The reference dataset target over ``frames`` frames of one scene,
    clips of ``t``: 7 frames give 6 valid clip ends."""
    infos = mod_synthetic.make_synthetic_infos(num_frames=frames, num_boxes=3, seed=0)
    return {"target": "sgm.data.nuscenes_video.nuscenes_datasets_video.MyDataset",
            "params": dict(infos=infos, queue_length=t, final_dim=(32, 64), resize=0.04,
                           image_loader=flat_image, seed=0)}


def make_ds(mod_dataset=dataset, mod_synthetic=synthetic, frames: int = 7):
    return mod_dataset.NuScenesVideoDataset(**ds_config(mod_synthetic, frames)["params"])


@pytest.fixture
def grain_in_order(monkeypatch):
    """grain reads with one thread: the dataset draws each clip's prompt
    from its generator, so grain's 16 reading threads would draw them in
    a racy order."""
    import grain.python as grain

    real = grain.DataLoader
    monkeypatch.setattr(grain, "DataLoader", lambda **kw: real(
        read_options=grain.ReadOptions(num_threads=1, prefetch_buffer_size=1), **kw))


def first_frame_names(batch):
    return [f[0][0] for f in batch["filenames"]]


def test_unshuffled_batches_equal_jax(grain_in_order):
    """batch 4 over 6 clips: a full batch and a short one, every array,
    prompt and file name equal to grain's batches."""
    got = list(loader.make_dataloader(make_ds(), batch_size=4))
    want = list(jloader.make_dataloader(make_ds(jdataset, jsynthetic), batch_size=4))
    assert [b["jpg"].shape[0] for b in got] == [4, 2]
    assert_tree_equal(got, want)


def test_shuffled_epoch_is_a_permutation_fixed_by_the_seed():
    """Two epochs: each holds every clip once; the same seed gives the same
    order, another seed or the next epoch another one."""
    def order(seed, epochs=2):
        return [first_frame_names(b)[0]
                for b in loader.make_dataloader(make_ds(), batch_size=1, shuffle=True,
                                                seed=seed, num_epochs=epochs)]

    plain = [first_frame_names(b)[0] for b in loader.make_dataloader(make_ds(), batch_size=1)]
    a, b, c = order(5), order(5), order(6)
    assert a == b and a != c
    assert sorted(a[:6]) == sorted(a[6:]) == sorted(plain) and a[:6] != a[6:]
    assert a[:6] != plain
    np.testing.assert_array_equal(loader.epoch_records(6, 0, True, 5),
                                  np.random.default_rng([5, 0]).permutation(6))


@pytest.mark.parametrize("frames", [7, 8])
def test_two_ranks_get_disjoint_shards_with_the_remainder_dropped_as_grain(frames, monkeypatch):
    """6 or 7 clips over two stand-in ranks of a process group: each rank
    gets grain's contiguous shard of len // 2 clips (the seventh dropped),
    the two disjoint; shuffled, a rank keeps its own clips."""
    grain = pytest.importorskip("grain.python")
    n = frames - 1
    shards = []
    for rank in range(2):
        monkeypatch.setattr(loader, "process_shard", lambda r=rank: (r, 2))
        sampler = grain.IndexSampler(
            num_records=n, shuffle=False, num_epochs=1, seed=0,
            shard_options=grain.ShardOptions(shard_index=rank, shard_count=2,
                                             drop_remainder=True))
        want = sorted({sampler[i].record_key for i in range(2 * n)
                       if i % 2 == rank and i < 2 * (n // 2)})
        got = loader.epoch_records(n, 0, shard=(rank, 2))
        np.testing.assert_array_equal(got, want)
        names = [first_frame_names(b)[0] for b in loader.make_dataloader(
            make_ds(frames=frames), batch_size=1)]
        shuffled = [first_frame_names(b)[0] for b in loader.make_dataloader(
            make_ds(frames=frames), batch_size=1, shuffle=True)]
        assert len(names) == n // 2 and sorted(shuffled) == sorted(names)
        shards.append(set(names))
    assert not shards[0] & shards[1]


def test_data_module_loads_its_splits_lazily_like_jax(grain_in_order):
    """``DataModuleFromConfig`` through the registry's reference target:
    workers default to twice the batch, a split is built at its first use
    and kept, an absent split raises, and the validation batches equal the
    JAX module's."""
    from panacea_tpu.data.loader import DataModuleFromConfig as JDataModule
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg, jcfg = ds_config(frames=5), ds_config(jsynthetic, frames=5)
    dm = instantiate_from_config({"target": "sgm.data.dataset.DataModuleFromConfig",
                                  "params": {"batch_size": 2, "validation": cfg}})
    assert dm.num_workers == 4
    dm.num_workers = 0
    got = next(dm.val_dataloader())
    first = dm.datasets["validation"]
    next(dm.val_dataloader())
    assert dm.datasets["validation"] is first
    with pytest.raises(KeyError, match="no 'train' dataset"):
        dm.train_dataloader()
    want = next(JDataModule(batch_size=2, validation=jcfg, num_workers=0).val_dataloader())
    assert_tree_equal(got, want)


WORKERS = """
import sys
import numpy as np
from panacea_tpu_torch.data import loader
from panacea_tpu_torch.data.nuscenes import dataset, synthetic
infos = synthetic.make_synthetic_infos(num_frames=5, num_boxes=3, seed=0)
def make_ds():
    return dataset.NuScenesVideoDataset(
        infos=infos, queue_length=2, final_dim=(32, 64), resize=0.04, seed=0,
        image_loader=lambda p: np.full((900, 1600, 3), synthetic.path_seed(p) % 256, np.uint8))
got = list(loader.make_dataloader(make_ds(), batch_size=2, worker_count=2))
want = list(loader.make_dataloader(make_ds(), batch_size=2))
assert "jax" not in sys.modules
assert [b["filenames"] for b in got] == [b["filenames"] for b in want]
for g, w in zip(got, want):
    for k in ("jpg", "cond_img", "final_cond_zero"):
        np.testing.assert_array_equal(g[k], w[k])
print("ok", len(got))
"""


def test_worker_processes_render_the_same_clips():
    """Two worker processes render the clips, in a process without JAX (a
    fork of a process running JAX's threads may deadlock): unshuffled, the
    arrays and file names equal the in-process batches. The prompts are
    drawn by each worker's copy of the dataset's generator."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", WORKERS], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok", "2"]
