"""The neoantigen paths of the port: peptide windows, the scoring head and
its first-layer kernel (K3), cohort batch scoring and the device-resident
chain."""
