"""Deterministic fault injection: seeded, round-indexed, replayable.

Port of ``repro.resilience.faults``.  A ``FaultPlan`` is a host-side
schedule: the resilient driver (``resilience.runtime``) asks it for the
events of a round between dispatches and applies each one to values the
host holds (the merged state, the lane mask, the checkpoint's bytes).
The round's code is the fault-free engine's; an armed plan with no
events costs one lookup per dispatched chunk.

The fault kinds and where they bite:

``nan_lane``
    One lane's local gradient goes non-finite.  The merge averages the
    lanes, so one NaN lane NaNs the merged state: the injection poisons
    the merged state and metrics, which recovery must detect.
``wire_bitflip``
    A corrupted word on the slow ``pod`` hop lands in the merged state:
    one bit of one element of the state tree is flipped (high exponent
    bits model the blow-ups real transfer faults cause).
``dead_lane`` / ``dead_pod``
    A vDPU (or a slow-hop participant's block of them) stops
    responding.  The event zeroes entries of the survivor mask that
    rides the resilient carry; the merge renormalises by the surviving
    lane count (``resilience.survivor``).
``timeout``
    A dispatch hangs: the driver sleeps ``duration_s`` (at most 50 ms)
    and raises :class:`DispatchTimeout`, a transient fault retried after
    backoff.
``torn_ckpt``
    A checkpoint write is torn: ``CheckpointManager`` truncates the
    published arrays file of the matching save ordinal (``round`` counts
    saves for this kind), which the checksums must catch on restore.

Determinism: :meth:`FaultPlan.generate` draws every event from
``numpy.random.RandomState(seed)`` in the JAX package's order, so one
seed gives the same plan in both packages, and a fit replayed with the
same seed, data and recovery policy replays the same failures.

>>> p = FaultPlan.generate(seed=7, rounds=20, n_lanes=8,
...                        rates={"nan_lane": 0.2})
>>> p == FaultPlan.generate(seed=7, rounds=20, n_lanes=8,
...                         rates={"nan_lane": 0.2})
True
>>> all(e.kind == "nan_lane" and 0 <= e.lane < 8 for e in p.events)
True
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

FAULT_KINDS = ("nan_lane", "wire_bitflip", "dead_lane", "dead_pod",
               "timeout", "torn_ckpt")


class DispatchTimeout(RuntimeError):
    """A (simulated) hung dispatch: transient, so recovery retries it
    after backoff without stepping down the degradation ladder."""


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled failure.  ``round`` is the dispatch round (for
    ``torn_ckpt`` the save ordinal since arming); the other fields are
    read only by their kind."""

    round: int
    kind: str
    lane: int = -1          # nan_lane / dead_lane target
    pod: int = -1           # dead_pod target (slow-hop participant)
    leaf: int = 0           # wire_bitflip: float-leaf index (mod #leaves)
    index: int = 0          # wire_bitflip: element within the leaf
    bit: int = 30           # wire_bitflip: bit of the f32 word to flip
    duration_s: float = 0.0  # timeout: simulated hang before the raise

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}: one of {FAULT_KINDS}")
        if self.round < 0:
            raise ValueError(f"FaultEvent.round must be >= 0, got "
                             f"{self.round}")

    def describe(self) -> dict:
        """The JSON-able form recovery traces hold."""
        d = {"round": self.round, "kind": self.kind}
        for f in ("lane", "pod"):
            if getattr(self, f) >= 0:
                d[f] = getattr(self, f)
        if self.kind == "wire_bitflip":
            d.update(leaf=self.leaf, index=self.index, bit=self.bit)
        if self.kind == "timeout":
            d["duration_s"] = self.duration_s
        return d


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of :class:`FaultEvent`, kept sorted.
    ``pods`` groups the lanes of a grid without a mesh for ``dead_pod``;
    a mesh's slow hop wins when it has more participants."""

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None
    pods: int = 1

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(sorted(self.events)))

    @classmethod
    def generate(cls, seed: int, *, rounds: int, n_lanes: int,
                 pods: int = 1, rates: Dict[str, float],
                 saves: Optional[int] = None) -> "FaultPlan":
        """A Bernoulli schedule from one ``RandomState(seed)``: ``rates``
        maps a kind to its probability a round (``torn_ckpt`` is drawn
        over ``saves`` ordinals, default ``rounds``)."""
        rng = np.random.RandomState(seed)
        events = []
        for kind in FAULT_KINDS:  # a fixed order: the same draws always
            rate = rates.get(kind, 0.0)
            if rate <= 0.0:
                continue
            horizon = saves if (kind == "torn_ckpt" and
                                saves is not None) else rounds
            for r in range(horizon):
                if rng.random_sample() >= rate:
                    continue
                if kind in ("nan_lane", "dead_lane"):
                    events.append(FaultEvent(
                        r, kind, lane=int(rng.randint(n_lanes))))
                elif kind == "dead_pod":
                    events.append(FaultEvent(
                        r, kind, pod=int(rng.randint(max(pods, 1)))))
                elif kind == "wire_bitflip":
                    events.append(FaultEvent(
                        r, kind, leaf=int(rng.randint(1 << 16)),
                        index=int(rng.randint(1 << 16)),
                        bit=int(rng.randint(23, 31))))
                elif kind == "timeout":
                    events.append(FaultEvent(
                        r, kind,
                        duration_s=float(0.01 * rng.random_sample())))
                else:  # torn_ckpt
                    events.append(FaultEvent(r, kind))
        return cls(events=tuple(events), seed=seed, pods=max(pods, 1))

    # -- queries the driver uses ---------------------------------------

    def events_at(self, round_i: int) -> Tuple[FaultEvent, ...]:
        """The dispatch events of round ``round_i`` (never ``torn_ckpt``)."""
        return tuple(e for e in self.events
                     if e.round == round_i and e.kind != "torn_ckpt")

    def saves_at(self, ordinal: int) -> Tuple[FaultEvent, ...]:
        """``torn_ckpt`` events for one save ordinal."""
        return tuple(e for e in self.events
                     if e.kind == "torn_ckpt" and e.round == ordinal)

    def next_event_round(self, start: int) -> Optional[int]:
        """The earliest dispatch-event round >= ``start`` (``torn_ckpt``
        counts saves and never bounds a chunk)."""
        rounds = [e.round for e in self.events
                  if e.kind != "torn_ckpt" and e.round >= start]
        return min(rounds) if rounds else None

    def clear_between(self, a: int, b: int) -> "FaultPlan":
        """A copy without dispatch events in ``[a, b)``."""
        return dataclasses.replace(self, events=tuple(
            e for e in self.events
            if e.kind == "torn_ckpt" or not a <= e.round < b))

    def describe(self) -> dict:
        return {"seed": self.seed, "pods": self.pods,
                "events": [e.describe() for e in self.events]}


# -- arming ------------------------------------------------------------

_ARMED: Optional[tuple] = None   # (plan, recovery, ckpt, ckpt_every)


def arm(plan: FaultPlan, *, recovery=None, ckpt=None,
        ckpt_every_rounds: int = 4) -> None:
    """Arm ``plan`` for the process: the next ``PimGrid.fit`` of a
    static plan runs under the resilient driver and injects its events,
    with ``recovery`` (a ``RecoveryPolicy``) and ``ckpt`` (a
    ``CheckpointManager`` or a directory)."""
    global _ARMED
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"arm() takes a FaultPlan, got {plan!r}")
    _ARMED = (plan, recovery, ckpt, int(ckpt_every_rounds))


def disarm() -> None:
    global _ARMED
    _ARMED = None


def active() -> Optional[FaultPlan]:
    """The armed plan, or None."""
    return _ARMED[0] if _ARMED is not None else None


def armed_context() -> Optional[tuple]:
    """``(plan, recovery, ckpt, ckpt_every_rounds)`` or None: the
    engine's one check when nothing is armed."""
    return _ARMED


@contextlib.contextmanager
def armed(plan: FaultPlan, *, recovery=None, ckpt=None,
          ckpt_every_rounds: int = 4):
    """``with faults.armed(plan): grid.fit(...)``: arming that always
    restores the previous context, so uses nest."""
    global _ARMED
    prev = _ARMED
    arm(plan, recovery=recovery, ckpt=ckpt,
        ckpt_every_rounds=ckpt_every_rounds)
    try:
        yield plan
    finally:
        _ARMED = prev


# -- injectors (applied to values after a dispatch) ----------------------


def poison_tree(tree):
    """What a non-finite lane leaves after an averaging merge: every
    float leaf NaN, integer leaves as they were."""
    return tree_map(lambda x: torch.full_like(x, float("nan"))
                    if x.dtype.is_floating_point else x, tree)


def bitflip_tree(tree, *, leaf: int, index: int, bit: int):
    """Flip ``bit`` of one element of one float leaf, through a host
    copy viewed as ``uint32`` (a non-float32 leaf as its float32 value),
    back on the leaf's device in its dtype.  ``leaf`` and ``index`` wrap
    so a generated event always lands somewhere."""
    flat = tree_leaves(tree)
    float_ix = [i for i, x in enumerate(flat)
                if x.dtype.is_floating_point and x.numel()]
    if not float_ix:
        return tree
    i = float_ix[leaf % len(float_ix)]
    x = flat[i]
    host = x.detach().to("cpu", torch.float32, copy=True).numpy()
    words = host.view(np.uint32).reshape(-1)
    words[index % words.size] ^= np.uint32(1) << np.uint32(bit % 32)
    flat = list(flat)
    flat[i] = torch.from_numpy(host).to(device=x.device, dtype=x.dtype)
    return tree_unflatten(tree, flat)


def kill_lanes(mask: np.ndarray, event: FaultEvent, *, pods: int
               ) -> np.ndarray:
    """Apply a ``dead_lane`` / ``dead_pod`` event to a host survivor mask
    of shape ``(n_vdpus,)`` (a new array).  A pod is a block of
    ``n_vdpus // pods`` lanes: a slow-hop participant's lanes on a mesh,
    the plan's grouping without one."""
    mask = np.array(mask, copy=True)
    n = mask.shape[0]
    if event.kind == "dead_lane":
        mask[event.lane % n] = 0.0
    elif event.kind == "dead_pod":
        pods = max(pods, 1)
        per = max(n // pods, 1)
        p = event.pod % pods
        mask[p * per:(p + 1) * per] = 0.0
    else:
        raise ValueError(f"not a lane-kill event: {event.kind!r}")
    return mask
