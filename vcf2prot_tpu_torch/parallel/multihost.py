"""Multi-host execution of the port: one process per host, each on its
own block of samples.

The twin of ``vcf2prot_tpu/parallel/multihost.py``. Every host reads the
shared VCF, compiles and executes only its contiguous balanced block of
samples (``host_sample_shard``) on its local mesh, and writes that block's
files to ``outdir/shard_<rank>/``; the merge is a directory union. No
tensor crosses a process, so ``torch.distributed`` serves for the rank
and the world size alone, over the ``gloo`` backend.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = ["count_samples", "host_sample_shard", "initialize_distributed",
           "run_multihost_pipeline"]


def initialize_distributed(coordinator_address: str = None,
                           num_processes: int = None,
                           process_id: int = None) -> None:
    """Join the process group (``gloo``); nothing if one exists.

    ``coordinator_address`` (``host:port``) becomes ``tcp://host:port``;
    without it the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as torchrun sets them).
    Call once per host, before :func:`run_multihost_pipeline`.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group("gloo", init_method=init, **kwargs)


def _rank_and_size() -> tuple:
    """This process's rank and the world size: the process group's, or 0
    and 1 without one (as ``jax.process_index()`` reads alone)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_sample_shard(n_samples: int, process_index: int = None,
                      process_count: int = None) -> list:
    """The sample indices this host owns: a contiguous block, sizes
    balanced to within one (the reference's blocks). Contiguity lets the
    native column walk skip the columns before the block and stop after
    it."""
    rank, size = _rank_and_size()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    base, extra = divmod(n_samples, pc)
    start = pi * base + min(pi, extra)
    return list(range(start, start + base + (1 if pi < extra else 0)))


def count_samples(vcf_path) -> int:
    from ..frontend.vcf_reader import read_vcf

    return len(read_vcf(vcf_path).probands)


def run_multihost_pipeline(cfg):
    """Run the port's pipeline on this host's sample block, writing to
    ``cfg.outdir/shard_<rank>/``."""
    from ..pipeline import run_pipeline

    rank, _size = _rank_and_size()
    shard_dir = os.path.join(cfg.outdir, f"shard_{rank}")
    os.makedirs(shard_dir, exist_ok=True)
    return run_pipeline(dataclasses.replace(
        cfg, outdir=shard_dir,
        sample_indices=host_sample_shard(count_samples(cfg.vcf_path)),
    ))
