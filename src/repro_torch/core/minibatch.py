"""On-device minibatch sampling for the PimGrid engine.

Port of ``repro.core.minibatch``.  The paper trains full-batch; PIM-Opt
(arXiv 2404.07164) trains minibatch SGD with a local update cadence:
each vDPU samples a batch of its resident rows, takes a local step, and
the host merges at cadence k.  Minibatching is a transformation of the
engine triple ``(local_fn, update_fn, init_state)``, so the engine runs
it unchanged at any cadence.

The schedule, as in the JAX package:

* **a function of (seed, step) only** — a float32 step counter rides
  next to the model state (cadence averaging keeps it an exact integer:
  every lane advances it alike), and each step reads its batch from the
  counter on the device.  Nothing is read back to the host;
* **epoch-exact coverage** — an epoch is ``E = ceil(per / b)`` steps over
  a fresh permutation of the ``per`` resident row slots; when ``b`` does
  not divide ``per`` the last batch repeats leading slots under a zero
  schedule mask, so every slot counts exactly once an epoch;
* **unbiased scaling** — a batch's partials are scaled by
  ``per / n_valid``, an unbiased estimate of the full partition's, so
  ``update_fn``'s normalisation by the row count stays as it is;
* **one schedule for every vDPU** — all lanes take the same slots; the
  rows behind the slots differ per lane.  On a mesh every rank draws the
  same schedule, since it depends on nothing else.

The permutation.  JAX draws ``jax.random.permutation(fold_in(PRNGKey(
seed), epoch), per)``, which torch cannot replay.  Here it is a function
``permutation(seed, epoch, per)`` that a caller may inject (the parity
tests inject JAX's).  The default, :func:`hashed_permutation`, is a
stable argsort of a 32-bit hash of ``(seed, epoch, slot)`` computed on
the epoch's device: no host value a step, and the same permutation bit
for bit on the CPU and the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

Permutation = Callable[[int, torch.Tensor, int], torch.Tensor]
_M32 = 0xFFFFFFFF


def epoch_steps(rows_per_vdpu: int, batch_size: int) -> int:
    """Steps per epoch window: ``ceil(rows_per_vdpu / batch_size)``."""
    return -(-rows_per_vdpu // batch_size)


def _mix32(x):
    """A bijection of [0, 2^32) (xor-shifts and odd multipliers) on a
    Python int or an int64 tensor: each product of a 32-bit value by a
    multiplier below 2^31 stays below 2^63 and is cut back to 32
    bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def hashed_permutation(seed: int, epoch: torch.Tensor,
                       per: int) -> torch.Tensor:
    """The default per-epoch permutation of ``per`` slots: the stable
    argsort of ``mix(slot ^ key)``, ``key = mix(mix(seed) + epoch)``.
    ``mix`` is a bijection, so the hashes are distinct and the order is
    the same on every device.  ``epoch``: an int64 tensor (0-dim) on the
    device the permutation is wanted on."""
    key = _mix32((_mix32(seed & _M32) + epoch) & _M32)
    slots = torch.arange(per, dtype=torch.int64, device=epoch.device)
    return torch.argsort(_mix32(slots ^ key), stable=True)


def batch_indices(rows_per_vdpu: int, batch_size: int, seed: int, step, *,
                  permutation: Optional[Permutation] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The schedule: ``(indices (b,) int32, valid mask (b,) float32)`` for
    local step ``step`` (an int, or an integer tensor on the device the
    batch is wanted on: no host sync)."""
    per, b = rows_per_vdpu, batch_size
    permutation = permutation or hashed_permutation
    E = epoch_steps(per, b)
    pad = E * b - per
    step = torch.as_tensor(step, dtype=torch.int64)
    perm = permutation(seed, torch.div(step, E, rounding_mode="floor"),
                       per).to(torch.int32)
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    slot = (step % E) * b + torch.arange(b, device=step.device)
    return perm.index_select(0, slot), (slot < per).float()


def host_schedule(rows_per_vdpu: int, batch_size: int, seed: int,
                  step: int, *, shuffle: bool = True,
                  permutation: Optional[Permutation] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`batch_indices` as numpy arrays, on the host.
    ``shuffle=False`` takes the identity for the permutation (sequential
    tiling of the slots)."""
    per, b = rows_per_vdpu, batch_size
    if shuffle:
        idx, mask = batch_indices(per, b, seed, step,
                                  permutation=permutation)
        return idx.cpu().numpy(), mask.cpu().numpy()
    E = epoch_steps(per, b)
    pad = E * b - per
    perm = np.arange(per, dtype=np.int32)
    if pad:
        perm = np.concatenate([perm, perm[:pad]])
    valid = (np.arange(E * b) < per).astype(np.float32)
    pos = int(step) % E
    return perm[pos * b:(pos + 1) * b], valid[pos * b:(pos + 1) * b]


def minibatch_fns(local_fn: Callable, update_fn: Callable, init_state: Any,
                  *, rows_per_vdpu: int, batch_size: int, seed: int = 0,
                  permutation: Optional[Permutation] = None):
    """Wrap an engine triple so that each local step sees a sampled batch.

    Returns ``(local_fn', update_fn', init_state', unwrap)``: the wrapped
    state is ``(state, counter)``, the counter a float32 scalar (``(L,)``
    inside a cadence round, every lane equal), and ``unwrap`` gives the
    caller's state back.  The batch is ``index_select`` on dim 1 (the
    rows) of every resident tensor, and the schedule mask multiplies
    into the row mask ``"w"``, so pad slots count as shard padding does.
    """
    per, b = rows_per_vdpu, batch_size
    if not 1 <= b <= per:
        raise ValueError(
            f"batch_size must be in [1, rows_per_vdpu={per}], got {b}")

    def sample_local_fn(carry, sl):
        state, t = carry
        # the counter holds exact integers; read on the device, rounded
        # before the int conversion as the JAX package does
        step = torch.round(t.reshape(-1)[0]).to(torch.int64)
        idx, mask = batch_indices(per, b, seed, step,
                                  permutation=permutation)
        batch = {k: v.index_select(1, idx) for k, v in sl.items()}
        batch["w"] = batch["w"] * mask
        part = local_fn(state, batch)
        # per / n_valid: n_valid = b except on an epoch's padded batch
        scale = torch.full((), float(per), device=mask.device) \
            / torch.clamp(mask.sum(), min=1.0)
        return {k: v * scale for k, v in part.items()}

    def sample_update_fn(carry, merged):
        state, t = carry
        new_state, metrics = update_fn(state, merged)
        return (new_state, t + 1.0), metrics

    counter = torch.zeros((), dtype=torch.float32, device=init_state.device)
    return (sample_local_fn, sample_update_fn, (init_state, counter),
            lambda carry: carry[0])
