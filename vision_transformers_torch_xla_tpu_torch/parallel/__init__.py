"""Data parallelism over torch.distributed: the process group and mesh
(mesh.py), DDP and FSDP2 around the model and the step's exchanges
(sharding.py)."""
