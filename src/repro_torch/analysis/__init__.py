"""Always-on invariants and the page-lifecycle sanitizer of the port.

* :mod:`repro_torch.analysis.invariants` -- :class:`InvariantError` /
  :func:`invariant`;
* :mod:`repro_torch.analysis.sanitizer` -- :class:`PageSanitizer`, the
  shadow-state model behind ``ServeEngine(sanitize=True)`` and the
  offline ``pages.jsonl`` replay;
* :mod:`repro_torch.analysis.interleave` -- the bounded lifecycle
  interleaving explorer.  NOT imported here (it imports the engine,
  which imports ``invariants``); import it explicitly.
"""

from repro_torch.analysis.invariants import InvariantError, invariant
from repro_torch.analysis.sanitizer import (PageSanitizer, SanitizerError,
                                            Violation, load_jsonl)

__all__ = ["InvariantError", "invariant", "PageSanitizer",
           "SanitizerError", "Violation", "load_jsonl"]
