"""Per-process input sharding (counterpart of
cppf_tpu/parallel/input_pipeline.py).

Each process renders a disjoint shard of the sample stream: its round-robin
share of the model list and a generator of its own.  Only the sample stream
is split; no rendered array crosses between processes.  The process index
and count are ``torch.distributed``'s rank and world size when a group is
initialised, else 0 and 1.

The index is that of this process among the processes that render, as in
JAX: ``jax.process_index()`` counts processes, not devices or hosts, and a
rank of the port is one process.  A JAX run with one process a GPU and the
port's run with one rank a GPU therefore render the same streams at the
same seed (``tests/test_torch_parallel.py::
test_shard_dataset_in_two_processes`` holds two real ranks to JAX's two
processes).  A JAX process that drives several devices renders one stream
for all of them; the port, one rank a card, renders one a card: the two
runs then have different numbers of processes, not different indices.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def _process(process_index: Optional[int], process_count: Optional[int]) -> Tuple[int, int]:
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return pi, pc


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> list:
    """This process's round-robin share of ``items``."""
    pi, pc = _process(process_index, process_count)
    return list(items[pi::pc])


def shard_dataset(dataset, seed: int = 0, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Split a render dataset over the processes, in place: this process's
    share of its model list and a generator of its own,
    ``default_rng(seed · 1000003 + process_index)``.  As in JAX, the
    generator is replaced on a single process too, so the stream depends on
    ``seed`` and not on the dataset's own seed.  ``train/loop.py::train``
    applies it to the dataset it builds."""
    pi, pc = _process(process_index, process_count)
    dataset.rng = np.random.default_rng(seed * 1000003 + pi)
    if pc <= 1:
        return dataset
    if getattr(dataset, "model_names", None):
        dataset.model_names = host_shard(dataset.model_names, pi, pc)
    return dataset


def sharded_sample_stream(dataset, seed: int = 0) -> Iterator:
    """This process's endless stream of samples of ``dataset``."""
    shard_dataset(dataset, seed)
    while True:
        yield dataset.sample()


def global_batch_size(per_host_batch: int) -> int:
    """The batch over every process."""
    return per_host_batch * _process(None, None)[1]
