"""Tensor and data parallelism over ``torch.distributed``: the mesh,
sharded GEMMs and collectives (``sharding``), the multi-process bootstrap
(``multihost``) and the heartbeat (``health``)."""
