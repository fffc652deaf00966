"""Online adaptive control — port of ``repro.control`` (DESIGN.md §13).

Only the Engine-A state migration (``migrate``) is ported: the fault-tolerant
training loop resumes a crashed engine through ``resume_with_migration``.
The control loop itself (``bound``, ``drift``, ``telemetry``, ``window``,
``controller``, ``replay`` and the API's ``mode="control"``) comes with
ROADMAP A11b; Engine B's migration with A12.
"""
from .migrate import (
    migrate_params_a,
    migrate_state,
    migrate_state_a,
    resume_with_migration,
)

__all__ = [
    "migrate_params_a",
    "migrate_state",
    "migrate_state_a",
    "resume_with_migration",
]
