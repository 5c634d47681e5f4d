"""Sharding of state and work over a device mesh, and supervision and
liveness for long jobs (counterpart of ``repro.distributed``)."""

from repro_torch.distributed.fault_tolerance import Heartbeat, StepTimer, run_with_restarts

__all__ = ["Heartbeat", "StepTimer", "run_with_restarts"]
