"""Shared helper for the legacy entry-point shims.

Every deprecated callable warns with a message starting with its fully
qualified ``repro_torch.`` name, so
``-W "error:repro_torch.:DeprecationWarning"`` escalates exactly the
port's deprecations to errors without tripping over third-party warnings.
"""

from __future__ import annotations

import warnings


def warn_deprecated(old: str, new: str, stacklevel: int = 3) -> None:
    """Emit a DeprecationWarning pointing at the typed-API replacement."""
    warnings.warn(f"{old} is deprecated; use {new} instead "
                  f"(see the repro_torch.core.study module docstring for "
                  f"the migration table)",
                  DeprecationWarning, stacklevel=stacklevel)
