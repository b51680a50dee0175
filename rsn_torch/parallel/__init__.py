"""Data parallelism of the port: one rank per device over
torch.distributed (rsn_torch.parallel.mesh)."""
