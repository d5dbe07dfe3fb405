"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``svit_tpu/parallel/``): ``dist`` (the process group, host gathers),
``mesh`` (the (data, model) groups, the batch share, the MLP's sharding
rules, full checkpoints) and ``tensor`` (the tensor-parallel MLP)."""
