"""Parallelism of the port over ``torch.distributed`` (counterpart of
``panacea_tpu/parallel``): ``mesh`` sets up the process group, the device,
the shards and the grid of one clip over several ranks; ``train`` holds the
collectives of training; ``shardctx``, ``ring_attention`` and
``comm_report`` the exchanges of one clip over several ranks and their
count."""
