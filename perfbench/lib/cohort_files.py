"""A chain cohort's files, made in a process of their own.

    python3 -m perfbench.lib.cohort_files TRAFFIC_JSON COHORT_SEED DIR

from the root of a checkout writes the cohort of ``COHORT_SEED`` under the
traffic's parameters (a JSON object) into ``DIR``: ``cohort.vcf``,
``proteome.fasta``, ``planted.json`` (the reference proteome, each
transcript's pool of bundles and the bundles redrawn) and ``carried.npz``
(which bundle each sample's haplotype carries). The chain kind runs it as
a child, so that the process which runs the program holds no heap of the
generator's and reads the cohort as a run from the cache does, whether
the cohort was made just now or before.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from perfbench.lib import cohort as gen


def write(traffic: dict, cohort_seed: int, part: str) -> None:
    cohort = gen.shared_cohort(
        cohort_seed, int(traffic["samples"]), int(traffic["transcripts"]),
        int(traffic["bundles_per_txp"]),
        float(traffic.get("carrier_p", 0.35)),  # unused with af_classes
        int(traffic["min_len"]), int(traffic["max_len"]),
        accept=gen.qc_accepts,
        **{k: traffic[k] for k in gen.MIX if k in traffic})
    gen.write_vcf(os.path.join(part, "cohort.vcf"), cohort)
    gen.write_fasta(os.path.join(part, "proteome.fasta"), cohort.ref)
    with open(os.path.join(part, "planted.json"), "w") as fh:
        json.dump({"ref": list(cohort.ref.items()), "pools": cohort.pools,
                   "redrawn": cohort.redrawn}, fh)
    np.savez(os.path.join(part, "carried.npz"), carried=cohort.carried)


if __name__ == "__main__":
    write(json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
