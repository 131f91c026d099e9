"""The serving control plane: ONE implementation of each policy
decision the engine/simulator/replay trio used to twin by hand.

Every module here holds a pure, side-effect-explicit policy object
consumed by all three serving layers (``serving/engine.py``,
``simulate()`` and ``replay_engine_timeline`` in
``serving/simulator.py``).  Parity between the layers is therefore a
matter of object identity — the parity suite asserts the three resolve
to the *same class* (or the same instance) instead of re-proving float
agreement between re-implementations:

  - :mod:`.admission` — arrival gate, queue ordering (FCFS / radix /
    EDF) and load shedding;
  - :mod:`.replication` — the hot-prefix replication trigger;
  - :mod:`.locality` — the radix locality bonus (affinity seconds);
  - :mod:`.seeding` — warm-up pressure seeding + the pressure feed;
  - :mod:`.prefill` — prefill schedule selection (monolithic /
    chunked / disaggregated).

Each module declares the ``SACConfig`` knobs it consumes in a
module-level ``CONSUMED_KNOBS`` tuple; sacheck's twin-coverage pass
reads those to exempt policy-routed knobs from the same-named
``SimConfig`` twin requirement (the policy object IS the shared
implementation, so a hand-written twin would be the exact duplication
this package removes).
"""
from repro_torch.serving.policy.admission import (ARRIVAL_EPS, AdmissionPolicy,
                                            EDFAdmission, FCFSAdmission,
                                            RadixAdmission, arrived,
                                            make_admission)
from repro_torch.serving.policy.locality import LocalityBonus
from repro_torch.serving.policy.prefill import PrefillSchedule
from repro_torch.serving.policy.replication import ReplicationPolicy
from repro_torch.serving.policy.seeding import PressureFeed, WarmupPressureSeed

__all__ = [
    "ARRIVAL_EPS", "AdmissionPolicy", "FCFSAdmission", "RadixAdmission",
    "EDFAdmission", "arrived", "make_admission", "LocalityBonus",
    "PrefillSchedule", "ReplicationPolicy", "PressureFeed",
    "WarmupPressureSeed",
]
