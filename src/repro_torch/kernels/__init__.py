"""Hand-written Hopper kernels of the port and their plain versions.

Each TPU kernel of ``repro/kernels/`` becomes a CUDA C++ kernel for
``sm_90a`` (sources in ``repro_torch/csrc/``, built and loaded by
``_lib.py``), wrapped by a module of the same name:

- gather_kv:   sparse KV row gather (the SAC read path)
- scatter_kv:  in-place KV row scatter (the SAC write path)
- indexer:     lightning-indexer scoring
- sparse_attn: top-k sparse attention, online softmax (MLA form)

``ops.py`` dispatches a batch: CPU tensors go to the plain versions in
``ref.py``, CUDA tensors to the kernels (or the call raises), ``meta``
tensors through the wrappers' checks with no launch (the dry-run).
``cost.py`` holds each kernel's analytic FLOPs and bytes (the bounds of
chip_smoke.py, the dry-run's counts).
"""
