"""The distributed layer (``repro/distributed``): logical-dim sharding
rules as DTensor placements (``sharding.py``) and the elastic re-mesh
(``elastic.py``).  The sharded KV pool itself is ``core/pool.py``'s
``make_pooled_fetch``; the hierarchical top-k is ``core/topk.py``."""
