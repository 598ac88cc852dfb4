"""Precision classes and the default refresh/reuse schedule (paper §6) —
the serving subset of ``repro.core.planner``.

    Strict       — exact coarsening, all-refresh schedule
    Reuse-only   — exact coarsening, refresh/reuse schedule
    Approx-only  — approximate coarsening, all-refresh
    Approx+Reuse — approximate coarsening + refresh/reuse schedule

The profile-guided planner (``Profile``, ``RuntimePlanner``,
``BatchPlanner``) comes with the batched-serving slice.
"""
from __future__ import annotations

from typing import Tuple

PRECISION_CLASSES = ("Strict", "Reuse-only", "Approx-only", "Approx+Reuse")


def class_constraints(precision_class: str) -> Tuple[str, bool]:
    """-> (group_mode, reuse_allowed)."""
    return {
        "Strict": ("exact", False),
        "Reuse-only": ("exact", True),
        "Approx-only": ("approx", False),
        "Approx+Reuse": ("approx", True),
    }[precision_class]


def default_schedule(num_layers: int) -> Tuple[int, ...]:
    """Alternating refresh/reuse (paper §7.2 evaluation schedule): odd layers
    reuse. Layer 0 is always a refresh."""
    return tuple(i for i in range(1, num_layers, 2))
