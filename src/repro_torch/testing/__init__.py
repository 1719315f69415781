"""Deterministic fault injection for resilience tests and chaos runs."""

from repro_torch.testing.faults import (ALL_FAULT_KINDS, FaultError,
                                        FaultInjector, FaultPlan)

__all__ = ["ALL_FAULT_KINDS", "FaultError", "FaultInjector", "FaultPlan"]
