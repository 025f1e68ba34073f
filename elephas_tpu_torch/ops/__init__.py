"""Hand-written Hopper kernels of the port, each beside its plain version.

The modules are imported by name (``from elephas_tpu_torch.ops import
flash_attention``), so each module's launch counter stays reachable.
"""
