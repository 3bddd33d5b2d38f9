"""The resilient fit driver: injection, detection, rollback, the ladder.

Port of ``repro.resilience.runtime``.  ``PimGrid.fit`` routes a static
plan here whenever a ``FaultPlan`` is armed (``faults.arm``).  The
driver owns the round loop on the host: the rounds
(``survivor.survivor_runners``) are the fault-free masked merge, and
every fault and recovery decision happens between dispatches.

DESIGN — chunks and one host synchronisation each
-------------------------------------------------
An armed plan with no events must train near the unarmed rate, so the
driver does not fall back to one dispatch a round: every clean round
before the next unfired event runs as one chunk (at most ``scan_chunk``
rounds), and only a round with events runs alone.  A chunk ends in one
transfer to the host: the all-finite flag of the merged state, its
squared norm and the chunk's stacked metrics, packed into one tensor.
The history and the loss the detector watches are read from that host
copy, never by a per-step ``.item()``.

DESIGN — the recovery loop
--------------------------
Each dispatched chunk is validated on the host (every float leaf of the
state finite, no jump of the squared norm past ``spike_factor²``, the
``DivergenceDetector`` on the last loss) before its metrics enter the
history or a checkpoint is written, so every checkpoint is a validated
one.  On a failure the driver backs off, rolls back to the newest valid
checkpoint (``CheckpointManager.restore_latest`` checks and quarantines)
or to the fit's start, and after ``degrade_after`` failures in a row
steps the plan down the ladder (``RecoveryPolicy.degrade``).  An event
fires once (the ``fired`` set), so a replayed window is clean and the
loop always makes progress.  The lane mask is monotone: a rollback
restores the state and the error buffer, never a dead lane.

Every decision is appended to a JSON-able trace, kept in
``merge_state["tuning_trace"]["recovery"]``; ``recovery.replay_trace``
folds it back into the plan sequence.

On a mesh every rank runs the driver on the same replicated state, so
each decision (finite, norm, loss, events) is the same on every rank.
A checkpoint directory is refused there (ROADMAP item 12b): every rank
would write the same directory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import merge_plan as mp
from repro_torch.resilience import faults as flt
from repro_torch.resilience import survivor
from repro_torch.resilience.recovery import RecoveryPolicy
from repro_torch.runtime.trainer import snapshot, to_host
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _host_sync(state, stacked) -> tuple:
    """``(all finite, squared norm, stacked metrics on the host)`` of a
    chunk, in one device-to-host transfer (``trainer.to_host``).  The
    flag and the norm cover the state's float leaves; the norm is in
    float32, where a flipped exponent bit that stays finite shows as a
    jump."""
    floats = [x for x in tree_leaves(state) if x.dtype.is_floating_point]
    if floats:
        finite = torch.stack([torch.isfinite(x).all() for x in floats]).all()
        sq = sum((x.float() ** 2).sum() for x in floats)
    else:
        finite, sq = True, 0.0
    host = to_host([finite, sq] + tree_leaves(stacked))
    return (bool(host[0]), float(host[1]),
            tree_unflatten(stacked, [torch.from_numpy(h) for h in host[2:]]))


def _round_loss(metrics) -> Optional[float]:
    """The scalar the divergence detector watches: the mean of the
    ``loss`` entry of a dict that has one, else of the first float
    leaf, else None."""
    leaf = None
    if isinstance(metrics, dict) and "loss" in metrics:
        leaf = metrics["loss"]
    else:
        for x in tree_leaves(metrics):
            if x.dtype.is_floating_point:
                leaf = x
                break
    if leaf is None:
        return None
    return float(leaf.mean())


def _normalise_plan(plan: mp.MergePlan) -> mp.MergePlan:
    """The survivor merge covers cadence × compression with the plain
    average commit; overlap and stateful outer optimizers are dropped
    with a warning, and controller plans are refused."""
    if plan.adaptive or plan.auto:
        raise ValueError(
            "fault injection does not drive controller plans "
            "(adaptive/auto) — arm a static MergePlan instead")
    if plan.overlap:
        mp.warn_fallback("resilience", "overlap_merge",
                         "the resilient driver dispatches per round; "
                         "running without overlap")
        plan = dataclasses.replace(plan, overlap=False)
    if type(plan.outer) is not mp.AverageCommit:
        mp.warn_fallback("resilience", f"outer={plan.outer!r}",
                         "survivor merges commit the plain average; "
                         "running without the outer optimizer")
        plan = dataclasses.replace(plan, outer=mp.AverageCommit())
    return plan


def drive_fit(grid, *, init_state: Any, local_fn, update_fn, data,
              steps: int, plan: mp.MergePlan,
              fault_plan: Optional[flt.FaultPlan] = None,
              recovery: Optional[RecoveryPolicy] = None,
              ckpt: "CheckpointManager | str | None" = None,
              ckpt_every_rounds: int = 4, scan_chunk: int = 8,
              callback=None, merge_state: Optional[dict] = None):
    """Run ``steps`` local steps under fault injection.

    Returns ``(state, history, report)``: the state and the history as
    ``PimGrid.fit`` returns them (one dict of 0-dim CPU tensors a local
    step), and the JSON-able report (``restarts``, ``rounds``,
    ``survivors``, ``fired``, ``trace``, ``start_plan``, ``final_plan``,
    and ``host_syncs``, one a dispatched chunk).  A checkpoint is saved
    after every ``ckpt_every_rounds`` clean dispatches.  With
    ``recovery=None`` a fault propagates as the exception it causes."""
    if grid.mesh is not None and ckpt is not None:
        raise NotImplementedError(
            "the resilient driver with a checkpoint directory on a mesh "
            "of ranks is not ported yet (ROADMAP queue A, item 12b): "
            "every rank would write the same directory; rank 0 must "
            "write and every rank restore")
    plan = _normalise_plan(plan)
    fp = fault_plan if fault_plan is not None else \
        (flt.active() or flt.FaultPlan())
    if isinstance(ckpt, str):
        # synchronous writes: the torn-write fault keys on the save
        # ordinal, and a rollback must see the bytes the schedule says
        ckpt = CheckpointManager(ckpt, keep=4, async_save=False)

    state = init_state
    mask_host = np.ones((grid.n_vdpus,), np.float32)
    mask = survivor.place_mask(grid, mask_host)
    ef = None
    if merge_state is not None and plan.compression is not None:
        ef = merge_state.get("error")
    if ef is None:
        # state-shaped for every wire: the carry (and the checkpoint
        # layout) keeps its shape as the ladder drops compression
        ef = mp.init_merge_error(grid, state)

    # the rollback target when no checkpoint exists yet
    origin = ((snapshot(state), snapshot(ef))
              if recovery is not None else None)

    cur = plan
    detector = recovery.detector() if recovery is not None else None
    history: list = []
    trace: list = []
    fired: set = set()
    pods = max(mp.hop_size(grid), fp.pods)
    done = 0
    round_i = 0
    restarts = 0
    consec_div = 0
    rounds_since_ckpt = 0
    host_syncs = 0
    prev_sq_norm: Optional[float] = None

    def wrapped():
        return {"model": state, "mask": mask, "ef": ef}

    def emit(stacked_host, hold, k):
        nonlocal done
        for r in range(hold):
            for j in range(k):
                m = tree_map(lambda x, r=r, j=j: x[r, j], stacked_host)
                history.append(m)
                if callback is not None:
                    callback(done, state, m)
                done += 1

    def save_boundary():
        nonlocal rounds_since_ckpt
        rounds_since_ckpt += 1
        if ckpt is None or rounds_since_ckpt < max(ckpt_every_rounds, 1):
            return
        rounds_since_ckpt = 0
        # fp armed around the synchronous save, so its torn writes fire
        # when it came in as an argument rather than through faults.arm
        with flt.armed(fp):
            ckpt.save(done, wrapped(),
                      extra={"done": done, "round": round_i,
                             "plan": cur.describe(),
                             "restarts": restarts})

    def rollback():
        nonlocal state, mask, ef, done, prev_sq_norm
        prev_sq_norm = None   # the norm re-bases after a restore
        restored = None
        if ckpt is not None:
            restored = ckpt.restore_latest(wrapped())
        if restored is not None:
            step_r, tree_r, _extra = restored
            state, ef = tree_r["model"], tree_r["ef"]
            done = int(step_r)
        else:
            state = snapshot(origin[0])
            ef = snapshot(origin[1])
            done = 0
        # dead hardware stays dead, whatever the snapshot says
        mask = survivor.place_mask(grid, mask_host)
        del history[done:]
        if detector is not None:
            detector.reset()
        return done

    while done < steps:
        k = min(cur.cadence, steps - done)
        rs = survivor.survivor_runners(
            grid, local_fn, update_fn, merge_every=k,
            compression=cur.compression)
        full_rounds = max((steps - done) // k, 1)
        pending = [e.round for e in fp.events
                   if e.kind != "torn_ckpt" and e not in fired
                   and e.round >= round_i]
        nxt = min(pending) if pending else None
        if nxt is not None and nxt <= round_i:
            hold = 1
        elif nxt is None:
            hold = min(scan_chunk, full_rounds)
        else:
            hold = min(scan_chunk, full_rounds, nxt - round_i)
        events = [e for e in fp.events_at(round_i) if e not in fired] \
            if hold == 1 else []
        try:
            for e in events:
                if e.kind == "timeout":
                    fired.add(e)
                    time.sleep(min(e.duration_s, 0.05))
                    raise flt.DispatchTimeout(
                        f"dispatch hung at round {round_i} "
                        f"(injected, {e.duration_s:.3f}s)")
            for e in events:
                if e.kind in ("dead_lane", "dead_pod"):
                    fired.add(e)
                    mask_host = flt.kill_lanes(mask_host, e, pods=pods)
                    mask = survivor.place_mask(grid, mask_host)

            (state, mask, ef), stacked = rs["runner"](
                (state, mask, ef), data, length=hold)
            round_i += hold

            for e in events:
                if e.kind == "nan_lane":
                    fired.add(e)
                    state = flt.poison_tree(state)
                    stacked = flt.poison_tree(stacked)
                elif e.kind == "wire_bitflip":
                    fired.add(e)
                    state = flt.bitflip_tree(
                        state, leaf=e.leaf, index=e.index, bit=e.bit)

            # the chunk's one host synchronisation: validation and the
            # history below read this copy
            ok, sq, stacked_host = _host_sync(state, stacked)
            host_syncs += 1
            if not ok:
                raise FloatingPointError(
                    f"non-finite state after round {round_i}")
            if detector is not None and detector.factor > 0.0 and \
                    prev_sq_norm is not None and \
                    sq > detector.factor ** 2 * max(prev_sq_norm, 1.0):
                raise FloatingPointError(
                    f"state norm blow-up ({prev_sq_norm:.3g} -> "
                    f"{sq:.3g} sq) after round {round_i}")
            loss = _round_loss(
                tree_map(lambda x: x[-1, -1], stacked_host))
            if detector is not None and loss is not None and \
                    detector.observe(loss):
                raise FloatingPointError(
                    f"divergent loss {loss} after round {round_i}")
            prev_sq_norm = sq

            emit(stacked_host, hold, k)
            consec_div = 0
            if not events:
                # a dispatch with injected events never checkpoints: a
                # corruption under the thresholds must not become the
                # state a rollback trusts; the next clean one saves
                save_boundary()
        except (FloatingPointError, flt.DispatchTimeout) as exc:
            t_fail = time.perf_counter()
            if recovery is None:
                raise
            restarts += 1
            if restarts > recovery.max_restarts:
                raise
            transient = isinstance(exc, flt.DispatchTimeout)
            backoff = recovery.backoff_s(restarts)
            time.sleep(backoff)
            to_step = rollback()
            trace.append({
                "action": "rollback", "round": round_i,
                "restarts": restarts, "error": type(exc).__name__,
                "detail": str(exc), "to_step": to_step,
                "backoff_s": backoff, "transient": transient,
                "latency_s": time.perf_counter() - t_fail,
            })
            if not transient:
                consec_div += 1
                if consec_div >= recovery.degrade_after:
                    nxt_plan = recovery.degrade(cur)
                    if nxt_plan is not None:
                        trace.append({
                            "action": "degrade", "round": round_i,
                            "from": cur.describe(),
                            "to": nxt_plan.describe(),
                            "to_cadence": nxt_plan.cadence,
                            "to_overlap": nxt_plan.overlap,
                            "to_compression": "none"
                            if nxt_plan.compression is None
                            else repr(nxt_plan.compression),
                        })
                        cur = nxt_plan
                        consec_div = 0

    if ckpt is not None:
        ckpt.wait()
    report = {
        "restarts": restarts,
        "rounds": round_i,
        "survivors": int(mask_host.sum()),
        "n_vdpus": grid.n_vdpus,
        "start_plan": plan.describe(),
        "final_plan": cur.describe(),
        "fault_plan": fp.describe(),
        "fired": [e.describe() for e in sorted(fired)],
        "trace": trace,
        "host_syncs": host_syncs,
    }
    if merge_state is not None:
        merge_state["resilience_report"] = report
        ts = merge_state.setdefault("tuning_trace", {})
        if isinstance(ts, dict):
            ts["recovery"] = trace
        if cur.compression is not None:
            merge_state["error"] = mp.gather_merge_error(grid, ef)
    return state, history, report
