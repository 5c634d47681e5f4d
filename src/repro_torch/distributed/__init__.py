"""Supervision and liveness for long jobs (counterpart of
``repro.distributed``; sharding is not ported yet)."""

from repro_torch.distributed.fault_tolerance import Heartbeat, StepTimer, run_with_restarts

__all__ = ["Heartbeat", "StepTimer", "run_with_restarts"]
