"""Tensor parallelism over `torch.distributed`: the sharding rules
(`sharding.py`, counterpart of `repro/parallel/sharding.py`) and the
collectives the models call under a grid (`tp.py`)."""
