"""The grid's canonical combo key — the part of
``h2o3_tpu/persist/recovery.py`` the orchestration layer needs.

:func:`combo_key` is the one spelling of a hyperparameter point shared by
grid model ids (``md5(combo_key(combo))[:8]``) and, once persistence is
ported, recovery's skip detection. :class:`Recovery`, the resumable
search's checkpoint directory, waits for the persist slice: it raises by
name, so ``GridSearch(recovery_dir=...)`` is refused, not ignored.
"""

from __future__ import annotations

import json


def combo_key(combo: dict) -> str:
    """Canonical form of a hyperparameter point (sorted keys, JSON)."""
    return json.dumps(combo, sort_keys=True, default=str)


class Recovery:
    """A resumable search's checkpoint directory (reference:
    ``Recovery<Grid>``); not ported yet."""

    def __init__(self, recovery_dir: str):
        raise NotImplementedError(
            f"recovery_dir={recovery_dir!r}: resumable grids need the "
            "persist slice (saved frames and models), which the port does "
            "not have yet")
