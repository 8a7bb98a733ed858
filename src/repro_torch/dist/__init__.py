"""Distribution layer of the port, over ``torch.distributed``: logical-axis
sharding rules on a ``DeviceMesh`` (:mod:`.sharding`), parameter / batch /
cache sharding assignment (:mod:`.params`), the fault-tolerant gradient
collectives — the paper's numerical entanglement on the data-parallel
gradient sum (:mod:`.collectives`) — and pipeline parallelism
(:mod:`.pipeline`).

Kept import-light, as the reference's: importing :mod:`repro_torch.dist`
imports none of its modules and never creates a process group.
"""
