"""The port's kill-and-resume setup, shared by
``tests/test_torch_trainer.py`` and the process it kills.

    python tests/torch_trainer_ref.py CKPT_DIR

runs ``Trainer.for_program`` at cadence 4 with minibatches and SIGKILLs
itself inside its ``KILL_DISPATCH``-th round, after the round has
computed and before the trainer records or checkpoints it.  The setup
is ``tests/test_resilience_restart.py``'s, on the port: a merge-state
holder seeded by a prior ``PimGrid.fit`` segment under int8 EF and
SlowMo at cadence 2, whose buffers ride the trainer's checkpoints.
Imports neither JAX nor the JAX package.
"""

import os
import signal
import sys

import numpy as np

from repro_torch.core import make_cpu_grid
from repro_torch.core.mlalgos import LinReg
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.distributed.merge_plan import MergePlan, SlowMo
from repro_torch.runtime import Trainer, TrainerConfig

STEPS = 24          # cadence 4: checkpoints at steps 7, 11, 15, 19, 23
KILL_DISPATCH = 3   # dies inside the round of steps 8-11


def setup():
    """``(program, merge_state)``: the data from a numpy seed and the
    holder seeded by 8 steps of a compressed SlowMo fit."""
    r = np.random.default_rng(0)
    X = r.standard_normal((256, 6)).astype(np.float32)
    y = (X @ r.standard_normal(6).astype(np.float32)
         + 0.1 * r.standard_normal(256)).astype(np.float32)
    grid = make_cpu_grid(4)
    seg = LinReg(lr=0.1).bind(grid, X, y)
    ms: dict = {}
    grid.fit(init_state=seg.state0, local_fn=seg.local_fn,
             update_fn=seg.update_fn, data=seg.data, steps=8,
             merge_state=ms,
             merge_plan=MergePlan(
                 cadence=2,
                 compression=CompressionConfig(bits=8, error_feedback=True),
                 outer=SlowMo()))
    ms["tuning_trace"] = {"note": ["segment-done"]}
    return LinReg(lr=0.05).bind(grid, X, y), ms


def config(ckpt_dir) -> TrainerConfig:
    return TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=4,
                         log_every=4, merge_every=4, batch_size=8)


def crash(ckpt_dir) -> None:
    """The victim: the same run, killed inside dispatch KILL_DISPATCH."""
    program, ms = setup()
    tr = Trainer.for_program(program, config(ckpt_dir), merge_state=ms)
    orig = tr.step_fn
    calls = {"n": 0}

    def sabotaged(state, batch):
        out = orig(state, batch)
        calls["n"] += 1
        if calls["n"] == KILL_DISPATCH:
            # the step-7 save is asynchronous: let it land, so the crash
            # tests the resume and not the writer's timing
            tr.ckpt.wait()
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    tr.step_fn = sabotaged
    tr.run(STEPS)
    print("UNREACHABLE")


if __name__ == "__main__":
    crash(sys.argv[1])
