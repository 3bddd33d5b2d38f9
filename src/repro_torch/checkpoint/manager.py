"""Async, crash-consistent checkpoints of trees of tensors.

Port of ``repro.checkpoint.manager``, with the same format on disk, so a
checkpoint that either package writes restores in the other.  One
directory a step, ``step_%010d/``, holds

  * ``arrays.npz``    — the leaves as ``a0 … an``, in the tree's leaf
    order (``tree.tree_flatten_with_names``: dicts by sorted key);
  * ``manifest.json`` — ``step``, ``names`` (each leaf's path as
    ``jax.tree_util.keystr`` spells it), ``extra`` (the caller's
    JSON-able metadata), ``time`` and ``checksums`` (the sha256 of
    ``arrays.npz``).

Leaves are stored whole (unsharded), so a restore places each one where
its template leaf lives, or where ``placer(name, host_array)`` puts it.

Crash consistency, as in the JAX package:

* a step is written into a ``.tmp`` sibling and published with one
  ``os.replace``, so a crash leaves no partial ``step_*`` directory;
* ``restore`` checks the checksums and raises
  :class:`CheckpointCorruptError` (a ``RuntimeError``); a tree that does
  not match the template raises ``ValueError``, so layout drift and disk
  rot stay apart;
* ``restore_latest`` quarantines a corrupt step (renamed to
  ``*.corrupt``) and falls back to the newest valid one;
* a failed background write is parked and re-raised at the next
  ``wait()`` or ``save()``; it is never published;
* under an armed ``resilience.faults.FaultPlan`` a ``torn_ckpt`` event
  truncates the payload of its save ordinal (the saves this manager has
  made, from 0) after the publish, which the checksums then catch.

The host copy.  ``save`` copies every leaf to host memory before it
returns (``.to("cpu", copy=True)``; on the card the one synchronising
read), and only the file write runs in the background: a CPU tensor's
``.numpy()`` would share the live tensor's memory, which the next step
may update in place.

bf16 leaves.  numpy has no bf16, and the JAX package's writer stores a
bf16 leaf as its raw two-byte bit patterns, an npz array of dtype
``V2``; the manifest records no dtype.  The port writes the same bytes
under the same dtype (:func:`host_copy`) and reads a ``V2`` array back
through its template leaf's dtype, so its bf16 checkpoints are
byte-compatible with JAX's.  (JAX's own ``restore`` cannot cast a
``V2`` array back: only the port reads such a leaf.)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten_with_names, tree_unflatten

# the dtypes a leaf may have besides bf16 (BF16_BITS): a save refuses a
# tensor whose dtype is not here, and a restore a stored array whose dtype
# is not
NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed validation (checksum mismatch, unreadable
    manifest or payload).  Not a ``ValueError``: a structure mismatch
    (template drift) raises ``ValueError`` and must stay apart from disk
    corruption."""


# the npz dtype of a bf16 leaf: its bit patterns, as JAX's writer stores them
BF16_BITS = np.dtype("V2")


def host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory; a bf16 tensor as its
    bit patterns, of dtype :data:`BF16_BITS`."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16_BITS)
        if host.dtype not in NUMPY_TO_TORCH.values():
            raise TypeError(
                f"cannot checkpoint a {leaf.dtype} leaf: the npz format "
                f"holds numpy dtypes and bf16 bit patterns only")
        return host.numpy()
    return np.array(leaf, copy=True)


def _leaf_from_host(name: str, host: np.ndarray, tmpl) -> torch.Tensor:
    """A stored array as a tensor of its template leaf's dtype, on the
    template's device; a ``V2`` array is taken as bf16 bit patterns."""
    if not isinstance(tmpl, torch.Tensor):
        raise TypeError(f"template leaf {name!r} is a "
                        f"{type(tmpl).__name__}, not a tensor: a restore "
                        f"places each leaf on its template's device")
    if host.dtype == BF16_BITS:
        if tmpl.dtype != torch.bfloat16:
            raise TypeError(f"checkpoint leaf {name!r} holds bf16 bit "
                            f"patterns, its template is {tmpl.dtype}")
        bits = torch.from_numpy(np.ascontiguousarray(host).view(np.int16))
        return bits.view(torch.bfloat16).to(tmpl.device)
    if host.dtype not in NUMPY_TO_TORCH:
        raise TypeError(f"checkpoint leaf {name!r} has dtype {host.dtype}, "
                        f"which the port does not restore")
    return torch.as_tensor(host, dtype=tmpl.dtype, device=tmpl.device)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Checkpoints under ``directory``: the newest ``keep`` steps stay,
    and with ``keep_every`` every step that is a multiple of it too."""

    def __init__(self, directory: str, *, keep: int = 3,
                 keep_every: int = 0, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._pending_exc: Optional[BaseException] = None
        self._save_ordinal = 0   # torn-write fault events key on this
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Snapshot ``state`` (a tree of tensors) at ``step``.

        The copy to the host happens here; the write runs in a
        background thread when ``async_save``.  A failure of the previous
        background write surfaces here (through ``wait``) first."""
        self.wait()
        names, leaves = tree_flatten_with_names(state)
        host = [host_copy(x) for x in leaves]
        meta = {
            "step": step,
            "names": names,
            "extra": extra or {},
            "time": time.time(),
        }
        ordinal = self._save_ordinal
        self._save_ordinal += 1

        def write():
            path = self._step_path(step)
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            arrays = os.path.join(tmp, "arrays.npz")
            np.savez(arrays, **{f"a{i}": h for i, h in enumerate(host)})
            meta["checksums"] = {"arrays.npz": _sha256(arrays)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)      # atomic publish
            self._maybe_tear(path, ordinal)
            self._retain()

        if self.async_save:
            def guarded():
                try:
                    write()
                except BaseException as exc:  # parked, raised at wait()
                    self._pending_exc = exc

            self._pending = threading.Thread(target=guarded, daemon=True)
            self._pending.start()
        else:
            write()

    def _maybe_tear(self, path: str, ordinal: int) -> None:
        """The torn-write fault: truncate the published payload to half
        when an armed ``FaultPlan`` schedules a ``torn_ckpt`` for this
        save ordinal.  One check when nothing is armed."""
        from repro_torch.resilience import faults

        plan = faults.active()
        if plan is None or not plan.saves_at(ordinal):
            return
        arrays = os.path.join(path, "arrays.npz")
        size = os.path.getsize(arrays)
        with open(arrays, "r+b") as f:
            f.truncate(size // 2)

    def wait(self):
        """Block until the write in flight has finished; re-raise its
        failure here, at the first wait/save boundary."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_exc is not None:
            exc = self._pending_exc
            self._pending_exc = None
            raise exc

    # -- restore --------------------------------------------------------------

    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:   # quarantined (*.corrupt) and others
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def validate(self, step: int) -> bool:
        """Whether the step's bytes are intact: a readable manifest, the
        payload present and its checksums equal (a manifest without
        checksums, from before they were written, is checked by
        unzipping the payload)."""
        path = self._step_path(step)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                meta = json.load(f)
            sums = meta.get("checksums")
            if sums is not None:
                for fname, digest in sums.items():
                    if _sha256(os.path.join(path, fname)) != digest:
                        return False
            else:
                with np.load(os.path.join(path, "arrays.npz")):
                    pass
            return True
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return False

    def quarantine(self, step: int) -> None:
        """Move a corrupt step out of ``steps()``' sight (renamed, not
        deleted: its bytes are kept for a post-mortem)."""
        path = self._step_path(step)
        dest = path + ".corrupt"
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = f"{path}.corrupt{n}"
        os.replace(path, dest)
        warnings.warn(
            f"checkpoint step {step} failed validation — quarantined "
            f"to {os.path.basename(dest)}", RuntimeWarning)

    def restore(self, step: int, template: Any,
                placer: Optional[Callable[[str, np.ndarray], Any]] = None
                ) -> Any:
        """``(tree, extra)``: the step restored into ``template``'s
        structure.  Each leaf takes its template leaf's dtype and device,
        or is what ``placer(name, host_array)`` returns.  Raises
        :class:`CheckpointCorruptError` when the bytes fail validation,
        ``ValueError`` when the structure does not match."""
        if not self.validate(step):
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed checksum/readability "
                f"validation")
        path = self._step_path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        names, leaves = tree_flatten_with_names(template)
        if names != meta["names"]:
            raise ValueError(
                "checkpoint/template structure mismatch: "
                f"{set(meta['names']) ^ set(names)}")
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, (name, tmpl) in enumerate(zip(names, leaves)):
                host = data[f"a{i}"]
                if placer is not None:
                    out.append(placer(name, host))
                    continue
                out.append(_leaf_from_host(name, host, tmpl))
        return tree_unflatten(template, out), meta["extra"]

    def restore_latest(self, template: Any, placer=None):
        """``(step, tree, extra)`` of the newest valid checkpoint, or
        None: corrupt steps are quarantined and skipped, a structure
        mismatch propagates (a caller's fault, not disk rot)."""
        for step in reversed(self.steps()):
            if not self.validate(step):
                self.quarantine(step)
                continue
            state, extra = self.restore(step, template, placer)
            return step, state, extra
        return None

    # -- retention ------------------------------------------------------------

    def _retain(self):
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        for s in steps[: -self.keep]:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self._step_path(s), ignore_errors=True)
