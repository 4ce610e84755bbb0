"""Multi-device and multi-host execution of the port: a mesh of
``torch.device``s, the sharded executor and neoantigen chain, per-host
sample shards."""
