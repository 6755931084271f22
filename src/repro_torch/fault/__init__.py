"""Deterministic fault injection + the typed failure-path exceptions
(DESIGN.md §11).  See :mod:`repro_torch.fault.plan` for the fault model
and the list of runtime injection sites.  A copy of ``repro.fault``: the
port imports nothing of the JAX package."""
from repro_torch.fault.errors import (EngineOverloadedError,
                                      FormatVersionError, InjectedKill,
                                      SnapshotCorruptError,
                                      SnapshotDigestError,
                                      StaleGenerationError)
from repro_torch.fault.plan import (FaultPlan, FaultSpec, active, fire,
                                    install)

__all__ = ["FaultPlan", "FaultSpec", "install", "active", "fire",
           "SnapshotCorruptError", "SnapshotDigestError",
           "FormatVersionError", "StaleGenerationError",
           "EngineOverloadedError", "InjectedKill"]
