"""Data parallelism of the port over ``torch.distributed`` (counterpart of
``panacea_tpu/parallel``'s ``dp`` axis): ``mesh`` sets up the process group,
the device and the shards; ``train`` holds the collectives of training."""
