"""Clip batches for training and inference, and the config-driven data
module.

Counterpart of ``panacea_tpu/data/loader.py``, without grain: a
``torch.utils.data.DataLoader`` over the dataset's valid clip ends, with
``worker_count`` worker processes rendering the 19-channel condition
panoramas, batches collated by ``data.nuscenes.dataset.collate`` (the last
one may be short), and the records sharded by ``torch.distributed`` rank
when a process group is up: contiguous shards of ``len // world`` records,
the remainder dropped, as grain's ``ShardOptions(drop_remainder=True)``
does. A shuffled epoch permutes its shard with a generator seeded from
``seed`` and the epoch; that order cannot be grain's, which is grain's own
algorithm (ROADMAP Queue C).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


class ClipSource:
    """Random access over the valid clip end indices of a
    ``NuScenesVideoDataset``."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.valid = [i for i in range(len(dataset)) if dataset._frame_indices(i)]

    def __len__(self) -> int:
        return len(self.valid)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.dataset[self.valid[idx]]


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    from panacea_tpu_torch.parallel.mesh import rank_world

    return rank_world()


def epoch_records(num_records: int, epoch: int, shuffle: bool = False, seed: int = 0,
                  shard: Tuple[int, int] = (0, 1)) -> np.ndarray:
    """The record indices of one epoch of shard ``shard`` = (index, count)."""
    index, count = shard
    size = num_records // count
    keys = np.arange(index * size, (index + 1) * size)
    if shuffle:
        keys = keys[np.random.default_rng([seed, epoch]).permutation(size)]
    return keys


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    from panacea_tpu_torch.data.nuscenes.dataset import collate

    return collate(samples)


def make_dataloader(dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                    num_epochs: Optional[int] = 1, worker_count: int = 0,
                    shard_by_process: bool = True) -> Iterator[Dict[str, Any]]:
    """Yields collated (B, T, ...) batches over ``num_epochs`` epochs (None:
    without end), sharded across the process group's ranks."""
    from torch.utils.data import DataLoader

    source = ClipSource(dataset)
    shard = process_shard() if shard_by_process else (0, 1)

    def records():
        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            yield from (int(k) for k in epoch_records(len(source), epoch, shuffle, seed, shard))
            epoch += 1

    loader = DataLoader(source, batch_size=batch_size, sampler=records(),
                        num_workers=worker_count, collate_fn=_collate)
    return iter(loader)


class DataModuleFromConfig:
    """Config-driven data module (reference sgm/data/dataset.py:67-182):
    per-split ``{target, params}`` dataset configs, instantiated through the
    port's registry in ``setup()`` or, split by split, at first use;
    ``train/val/test/predict_dataloader`` yield collated batches (train
    shuffles, validation and test as their flags say), sharded across the
    processes of the group."""

    def __init__(self, batch_size, train=None, validation=None, test=None, predict=None,
                 wrap=False, num_workers=None, shuffle_test_loader=False,
                 use_worker_init_fn=False, shuffle_val_dataloader=False, seed: int = 0):
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None else batch_size * 2
        self.seed = seed
        self._shuffle = {"train": True, "validation": shuffle_val_dataloader,
                         "test": shuffle_test_loader, "predict": False}
        self.dataset_configs: Dict[str, Any] = {
            name: cfg for name, cfg in (("train", train), ("validation", validation),
                                        ("test", test), ("predict", predict))
            if cfg is not None}
        self.datasets: Dict[str, Any] = {}

    def setup(self, stage=None):
        from panacea_tpu_torch.registry import instantiate_from_config

        self.datasets = {k: instantiate_from_config(cfg)
                         for k, cfg in self.dataset_configs.items()}

    def _loader(self, split: str):
        if split not in self.dataset_configs:
            raise KeyError(f"no '{split}' dataset was configured "
                           f"(configured splits: {sorted(self.dataset_configs)})")
        if split not in self.datasets:
            from panacea_tpu_torch.registry import instantiate_from_config

            # only the missing split: a full setup() would rebuild the others
            self.datasets[split] = instantiate_from_config(self.dataset_configs[split])
        return make_dataloader(self.datasets[split], batch_size=self.batch_size,
                               shuffle=self._shuffle[split], seed=self.seed,
                               worker_count=self.num_workers)

    def train_dataloader(self):
        return self._loader("train")

    def val_dataloader(self):
        return self._loader("validation")

    def test_dataloader(self):
        return self._loader("test")

    def predict_dataloader(self):
        return self._loader("predict")
