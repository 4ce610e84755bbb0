"""The benchmark of ``vcf2prot_tpu_torch`` on one NVIDIA H100 (see
``README.md``)."""
