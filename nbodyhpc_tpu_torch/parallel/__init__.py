"""Sharded pipelines on ``torch.distributed``: the slab-sharded render, the
query-sharded k-NN and the sharded kNN-CDF.

PyTorch port of :mod:`nbodyhpc_tpu.parallel` (without ``tree_sharded``).
JAX's single controller with ``shard_map`` becomes SPMD: one process per
rank, each calling the same function with the same arguments. Without a
process group every function runs as a world of one.
"""
from . import mesh, sharded, stats  # noqa: F401
