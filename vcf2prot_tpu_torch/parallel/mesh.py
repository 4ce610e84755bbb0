"""Device meshes of the port.

The twin of ``vcf2prot_tpu/parallel/mesh.py``. There a mesh is a 1-D
``dp`` ``jax.sharding.Mesh`` over the host's local devices; here it is a
tuple of ``torch.device``s, one per shard, driven by one process. A mesh
may name a device more than once: ``(torch.device("cpu"),) * 4`` runs the
sharded paths on the CPU, ``(torch.device("cuda", 0),) * 2`` on one card.
"""
from __future__ import annotations

import torch


def make_mesh(n_devices: int = 0) -> tuple:
    """The first ``n_devices`` local CUDA devices (all of them when 0), as
    a tuple of ``torch.device``; empty when there is no CUDA device.

    Multi-host runs shard the samples across hosts
    (``parallel/multihost.py``) and each host spreads its shard over its
    own local mesh, as in the reference.
    """
    if not torch.cuda.is_available():
        return ()
    devices = tuple(torch.device("cuda", i)
                    for i in range(torch.cuda.device_count()))
    return devices[:n_devices] if n_devices else devices
