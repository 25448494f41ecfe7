"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``ctrlora_tpu/parallel/``): ``mesh`` (process groups, batch sharding,
replication, optimizer-state sharding, data-parallel sampling) and ``tp``
(Megatron-style attention and GEGLU sites under a call-time context)."""
