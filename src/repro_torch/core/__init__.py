"""SAC core of the port (``repro/core``).

- pool:      KV pool, single-device read (gather) and write (scatter)
- hisparse:  hierarchical device buffer (miss-id / LRU / page table)
- sac:       per-layer decode assembly + host-level pool system
- metadata, placement, traffic, transfer, fabric: host modules, copied
  from the reference
"""
