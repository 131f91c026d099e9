"""The distributed layer (``repro/distributed``): logical-dim sharding
rules as DTensor placements and a rank's blocks of the weights
(``sharding.py``), tensor and expert parallelism of the serving path
(``tp.py``) and the elastic re-mesh (``elastic.py``).  The sharded KV pool
itself is ``core/pool.py``'s ``make_pooled_fetch``; the hierarchical top-k
is ``core/topk.py``."""
