"""Checkpoint and resume for training state.

The port of ``mmlspark_tpu/dl/checkpoint.py``'s ``CheckpointManager``:
step-numbered directories (``step_%010d``) with retention. The on-disk
format is the port's own, not orbax: each step directory holds one
``state.pt`` (``torch.save`` of the model's and the optimizer's
``state_dict``s and the step), so the optimizer's moments come back with the
weights. It does not read the JAX package's checkpoints.

Crash safety, as in the reference: a save writes into a ``.tmp-*`` sibling
and ``os.replace``-renames it into ``step_NNN``, so a crash mid-write leaves
an invisible orphan (swept by the next save), never a half-written step.
Listing skips an empty step directory (a torn copy from a non-atomic
writer) and a resume-latest ``restore`` skips one that does not load; both
are counted in ``resilience_checkpoint_skipped_total`` (reason ``partial``
or ``corrupt``) in the port's registry. The reference's
``checkpoint.write`` fault-injection point comes with the port's
``resilience/`` (ROADMAP.md §1 item 9).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import uuid

import torch

from ..obs import registry as _obs
from .train import TrainState

_LOG = logging.getLogger("mmlspark_torch.dl.checkpoint")
STATE_FILE = "state.pt"

_m_skipped = _obs.counter(
    "resilience_checkpoint_skipped_total",
    "checkpoint step dirs skipped at restore/listing, by reason "
    "(partial | corrupt)")


def _write(payload: dict, path: str) -> None:
    torch.save(payload, path)


class CheckpointManager:
    """Step-numbered checkpoints of a :class:`TrainState` with retention
    (the newest ``max_to_keep`` steps stay)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # partial dirs already counted and warned about: the counter
        # measures skipped checkpoints, not how often the store was listed
        # (all_steps runs on every save)
        self._partial_counted: set[str] = set()
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if not m:
                continue
            # an empty step dir is a torn write (or a crash between mkdir
            # and content): listing it would make latest_step() and
            # restore() chase a ghost. A dir with content but no loadable
            # state is listed, and a resume-latest restore skips it.
            path = os.path.join(self.directory, name)
            if os.path.isdir(path) and not os.listdir(path):
                if name not in self._partial_counted:
                    self._partial_counted.add(name)
                    _m_skipped.inc(1, reason="partial")
                    _LOG.warning("checkpoint %s is empty (torn write) — "
                                 "skipped", path)
                continue
            out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int | None = None) -> str:
        """Atomic save of ``state`` (its model's and optimizer's
        ``state_dict``s and ``step``) as ``step_NNN`` (``state.step`` by
        default). Returns the step directory."""
        step = int(state.step) if step is None else int(step)
        final = self._step_dir(step)
        tmp = os.path.join(self.directory,
                           f".tmp-step_{step:010d}-{uuid.uuid4().hex[:8]}")
        try:
            os.makedirs(tmp)
            _write({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": step}, os.path.join(tmp, STATE_FILE))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()
        return final

    def restore(self, step: int | None = None,
                target: TrainState | None = None) -> TrainState:
        """Load a checkpoint into ``target`` (a :class:`TrainState` with a
        freshly built model and optimizer of the saved run's structure) and
        return it, its ``step`` set to the saved one. A torch module carries
        its parameters, so there is nothing to restore without a target: the
        JAX version's plain-dict return has no counterpart, and
        ``target=None`` raises.

        With ``step=None`` (resume the latest), a step that fails to load is
        skipped, counted in ``resilience_checkpoint_skipped_total``, and the
        next older one tried (a failed load may leave part of that step in
        ``target``; the older step then overwrites all of it); an explicit
        step that fails to load raises."""
        if target is None:
            raise ValueError("restore needs target=TrainState(model, "
                             "optimizer) to load the checkpoint into")
        if step is not None:
            return self._restore_one(step, target)
        candidates = self.all_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        last_err: Exception | None = None
        for s in reversed(candidates):
            try:
                return self._restore_one(s, target)
            except Exception as e:  # unreadable content: fall back
                last_err = e
                _m_skipped.inc(1, reason="corrupt")
                _LOG.warning("checkpoint step %d failed to restore (%s: %s) "
                             "— falling back to an older step",
                             s, type(e).__name__, e)
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.directory} "
            f"({len(candidates)} corrupt)") from last_err

    def _restore_one(self, step: int, target: TrainState) -> TrainState:
        dev = next(target.model.parameters()).device
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location=dev, weights_only=True)
        target.model.load_state_dict(payload["model"])
        target.optimizer.load_state_dict(payload["optimizer"])
        target.step = int(payload["step"])
        return target

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # sweep .tmp-* orphans from crashed saves
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-step_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
