"""Training checkpoints: not ported yet.

The JAX package's ``dl/checkpoint.py`` saves and restores train states with
orbax (``CheckpointManager``). The port's counterpart comes with the rest
of the training slice (ROADMAP.md §1 item 7); until then it raises.
"""

from __future__ import annotations

LATER_CHECKPOINT = ("training checkpoints (CheckpointManager) come with the "
                    "rest of the training slice (ROADMAP.md §1 item 7)")


class CheckpointManager:
    """Not ported yet: raises ``NotImplementedError`` naming its item."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(LATER_CHECKPOINT)
