"""Model registry: checkpoint-backed model versions behind an atomic
hot-swap.

Port of ``repro.serving.registry``.  The registry owns the serve path's
*state* axis the way the :class:`~repro_torch.serving.runner.
PredictRunner` owns its *shape* axis: it loads checkpoints through
:class:`~repro_torch.checkpoint.CheckpointManager`'s sha256 validation
(a corrupt step is refused as the training restore refuses it), accepts
both layouts (a bare state tree, or the Trainer's v2 ``{"model": state,
"merge_*": ...}``, whose model subtree is selected by manifest name) and
publishes each version as a fresh ``(version, PredictRunner)`` pair
swapped under a lock.  The format is the JAX package's, so a checkpoint
either package wrote loads the same way.

Swap semantics — **no in-flight request is ever dropped**: callers take
an atomic snapshot with :meth:`ModelRegistry.current` and serve a whole
micro-batch from it.  A swap replaces the registry's pointer, not the
snapshot; the superseded runner and its state stay alive until their
last holder finishes.  A runner's graphs key on the workload's
configuration and the state's *shapes*, never its values, so a swap to a
same-shaped version on a shared grid captures nothing.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.serving.runner import DEFAULT_BUCKETS, PredictRunner
from repro_torch.tree import tree_flatten_with_names, tree_unflatten


class ModelRegistry:
    """Versioned models for one workload; versions come from a
    checkpoint directory (:meth:`refresh` / :meth:`load_step`) or are
    pushed directly (:meth:`publish`).  Restored leaves take the
    template's leaves' dtypes and devices."""

    def __init__(self, workload, template: Any, *,
                 ckpt_dir: Optional[str] = None,
                 grid=None, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.workload = workload
        self.template = template
        self.grid = grid
        self.buckets = tuple(buckets)
        self._mgr = (CheckpointManager(ckpt_dir, async_save=False)
                     if ckpt_dir is not None else None)
        self._lock = threading.Lock()
        self._current: Optional[tuple] = None   # (version, runner)

    # -- the swap ------------------------------------------------------

    def publish(self, state, version: int) -> PredictRunner:
        """Build a runner for ``state`` and atomically make it the
        current version.  In-flight holders of the previous runner keep
        serving from it."""
        runner = PredictRunner(self.workload, state, grid=self.grid,
                               buckets=self.buckets)
        with self._lock:
            self._current = (int(version), runner)
        return runner

    def current(self) -> tuple:
        """Atomic ``(version, runner)`` snapshot — take it once per
        micro-batch so a mid-batch swap cannot split the batch across
        model versions."""
        with self._lock:
            if self._current is None:
                raise RuntimeError(
                    "registry has no published version — call refresh() "
                    "or publish() first")
            return self._current

    @property
    def version(self) -> Optional[int]:
        with self._lock:
            return self._current[0] if self._current else None

    # -- checkpoint loading --------------------------------------------

    def _restore_state(self, step: int):
        """Model subtree of checkpoint ``step``, via the manager's
        sha256 validation.  Accepts the bare (v1) layout and the
        Trainer's v2 ``{"model": ..., "merge_*": ...}`` wrapping."""
        mgr = self._mgr
        if not mgr.validate(step):
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed checksum/readability "
                f"validation")
        path = mgr._step_path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        names = meta["names"]
        tnames, tleaves = tree_flatten_with_names(self.template)
        if names == tnames:
            idxs = list(range(len(names)))
        else:
            prefixed = [f"['model']{n}" for n in tnames]
            if all(p in names for p in prefixed):
                idxs = [names.index(p) for p in prefixed]
            else:
                raise ValueError(
                    f"checkpoint step {step} holds neither the bare "
                    f"state layout nor a ['model'] subtree matching the "
                    f"template: {names} vs {tnames}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [torch.as_tensor(data[f"a{i}"], dtype=t.dtype,
                                      device=t.device)
                      for i, t in zip(idxs, tleaves)]
        return tree_unflatten(self.template, leaves), meta.get("extra", {})

    def load_step(self, step: int) -> PredictRunner:
        """Load one checkpoint step and publish it as that version."""
        if self._mgr is None:
            raise RuntimeError("registry was built without a ckpt_dir")
        state, extra = self._restore_state(step)
        runner = self.publish(state, version=step)
        runner.extra = extra
        return runner

    def refresh(self) -> Optional[int]:
        """Publish the newest valid checkpoint if it is newer than the
        current version; corrupt steps are skipped (the manager's
        newest-valid semantics).  Returns the published version, or the
        unchanged current version when there is nothing newer."""
        if self._mgr is None:
            raise RuntimeError("registry was built without a ckpt_dir")
        cur = self.version
        for step in reversed(self._mgr.steps()):
            if cur is not None and step <= cur:
                break
            try:
                self.load_step(step)
                return step
            except CheckpointCorruptError:
                continue
        return cur
