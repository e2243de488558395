"""Always-on invariants for the port's allocator and lifecycle code."""

from repro_torch.analysis.invariants import InvariantError, invariant

__all__ = ["InvariantError", "invariant"]
