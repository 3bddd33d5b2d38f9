#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's training and serving paths once on the card.

    python3 chip_smoke.py              # one CUDA card, full size
    python3 chip_smoke.py --rehearse   # CPU, small size, plain versions

Phases, each printed as one JSON line:

  1. device   — the card, and its name and power limit from nvidia-smi;
  2. build    — the five CUDA libraries built from
                src/repro_torch/kernels/csrc, in parallel
                (flash_attention.cu also holds the backward);
  3. compare  — each kernel's wrapper against its plain PyTorch version
                on the card at the training paths' shapes (256 lanes x
                65,536 rows) and on ragged shapes: fxp_matmul (the whole
                hybrid dot, both routes, every workload layout),
                lut_activation and split_hist bit for bit; kmeans_assign's
                assignments and counts bit for bit, its sums and sse
                within 1e-5 of their mass, and two launches bit-equal;
                hybrid_matmul past one launch's 16 columns (int16 and
                int8 a and b, N up to 20, per-lane b) and the exp table
                through lut_activation bit for bit;
                flash_attention within float32 2e-5 / bf16 1e-2 (and
                >= 99 % of bf16 outputs bit-equal) at qwen2-0.5b's
                prefill shape (4 x 14 heads, 2 KV heads, S = 4096, D =
                64), ragged S, D = 32, D = 128, a packed view, and
                whisper-tiny's encoder (16 x 6 heads, S = 1,500, D = 64,
                full), llava's backbone (32 heads, 8 KV heads, S =
                4,096, D = 128, causal) and the MoE backbones (4 x 32
                heads over 8 and 4 x 64 heads over 4, S = 4,096, D = 128,
                causal: GQA groups 4 and 16) on ``wgmma`` in bf16, two
                launches bit-equal; then their times (the median over
                runs of launches enqueued back to back, CUDA events;
                the single-call reading beside it) and bounds,
                split_hist at the tree's uint8 bins and at int32;
  4. train    — ``api.fit`` on 256 vDPUs x 2^24 rows made on the card
                from --seed: LogReg(int8, LUT sigmoid) at d=64, 50 steps
                at cadence 1 and 48 at cadence 8, against fp32 + exact
                sigmoid, then LinReg int8 for 20 steps (and its steps/s);
                KMeans k=8 d=16
                for 10 iterations at fp32 and int16 (cadence 1 and 8);
                DecisionTree depth 6, 32 bins, 4 classes, d=16 (uint8
                resident bins), against its ``use_kernels(False)`` twin,
                with profiles of a tree and of its binning.  The launch
                counters are set to 0 before each run and must show the
                launches the design implies; small fits must equal (K-means: within
                atol 1e-4, rtol 1e-5) their ``use_kernels(False)`` twins;
  5. predict  — each trained workload answers requests of 1, 7 and 512
                rows through ``Workload.predict``, equal to the plain
                path; the fp32 predict of LogReg, LinReg, LinearSVM and
                MultinomialLogReg on 7 rows equals the same rows padded
                with zero rows to 16;
 5b. serve_pim — the trained LogReg(int8, LUT) state and six other
                configurations (LogReg fp32 + exact, LinReg and LinearSVM
                int8, MultinomialLogReg int8 + LUT at C = 4 and 10,
                KMeans int16 k=8 d=16; seeded states) served through
                ``serving.PredictRunner``, one CUDA graph a bucket (8 /
                32 / 128 / 512), on held-out labelled rows: (b) requests
                of 1, 7, 8, 100, 512 and 1,300 rows from the card and the
                host bit-equal to the eager predict (K-means off the
                near-ties); (c) 4 captures a configuration, none after,
                none for an equal configuration, and 20 replays a
                bucket launching the port's kernels (the bucket graph's
                kernel nodes times its replays), with no pageable copy
                (profiler); (d) rows/s of run_stream against the eager loop
                (512- and 8-row batches) and one 8-row request's latency,
                in turns, the idle share; (e) MicroBatchQueue bursts of
                4,096 single rows at 2,000, 8,000 and 32,000/s: fp32
                tickets bit-equal, int8 + LUT accuracy within 0.01 of
                fp32's; (f) ModelRegistry over a Trainer.for_program run
                (32 steps, cadence 8, checkpoints every 8): refresh
                bit-equal, two swaps under traffic, a torn step skipped;
                (g) ``launch.serve.main`` on the card;
  6. serve_lm — qwen2-0.5b at its full config (24 layers, bf16, random
                weights from --seed): ``Model.prefill`` of 4 x 4096 tokens
                (one flash launch per layer, last logits within 3e-2 x
                max|logit| of the ``use_kernels(False)`` twin), its
                tokens/s and a profile; ``generate`` on 8 requests of 64
                prompt + 32 greedy tokens (one captured decode step a
                token), its step against the eager decode in lockstep
                (logits bit for bit, tokens equal), decode tokens/s graph
                against eager in turns, idle shares and host launch calls
                a token, and a profile of 8 eager decode steps; in float32
                at full width, the
                prefill against its twin (1e-4 x max|logit|) and against
                the replay through ``decode_step`` (1e-3 x max|logit|);
 6b. train_lm — qwen2-0.5b trained at full width (24 layers, bf16 params,
                a float32 master, AdamW at lr 3e-4): (a) the backward
                kernel ``flash_attention_bwd`` against its plain version
                in bf16 and float32 at D = 32, 64, 128, G = 1, 2, 7,
                causal and full, a ragged S and the training shape (4 x
                14 heads, 2 KV heads, S = 2048, D = 64), and whisper's
                encoder's and llava's shapes: float32 within
                2e-5 and bf16 within 1e-2 of max|grad| (the bit-equal
                share printed), two launches bit-equal, the forward with
                lse bit-equal to the forward without it; (b) its times,
                bound, plain version and float32 / bf16 SDPA backward;
                (c) 20 steps of 4 x 2048 tokens from ``TokenStream``
                through ``launch.train``'s step and the ``Trainer``: 24
                forward and 24 backward flash launches a step, finite
                losses falling (the last five below the first), tokens/s,
                a profile of one step by kernel class and its parts
                (forward, backward, cross entropy, AdamW) apart; (d) 10
                steps saved and resumed by a new Trainer, bit-equal to
                (c) in every leaf; (e) one bf16 step against its
                ``use_kernels(False)`` twin (loss within 1e-2, gradients'
                relative L2 under 5e-2), and float32 at full width cut to
                2 layers and 2 x 512 tokens (every leaf within 1e-4 x
                max|g|);
 6c. lm_recurrent — mamba2-370m and recurrentgemma-2b at their full
                configs (bf16, random weights from --seed), through the
                port's entry points, each launching none of the port's
                kernels (every count 0): (a) ``Model.prefill`` of 4 x
                4096 tokens, finite last logits, tokens/s, peak memory
                and a profile by kernel class; (b) ``generate`` on 8
                requests of 64 + 32 tokens, its captured decode step
                against the eager decode in lockstep (logits bit for
                bit, tokens equal), decode tokens/s graph against eager
                in turns; (c) float32 at full width, one request of 2,176
                tokens: the prefill's last logits against the replay
                through the captured ``decode_step`` (1e-3 x max|logit|),
                and the graph against the eager decode bit for bit over
                16 positions on each side of recurrentgemma's ring wrap
                (position 2,048; mamba2 at the request's middle); (d) 10
                training steps of batch x 2048 tokens through
                ``launch.train``'s step and the ``Trainer`` (REC_TRAIN:
                the batch that fits, recurrentgemma cut in depth): finite
                losses, the last below the first, tokens/s, peak memory
                and one step's profile by kernel class;
 6d. lm_encdec — whisper-tiny at its full config (4 + 4 layers, bf16,
                random weights and frames from --seed), both flash kernels
                timed at its encoder's shape (16 x 6 heads, S = 1,500, D =
                64, full) against bf16 SDPA: (a) ``Model.prefill`` of 16 x
                (1,500 frames + 448 tokens), 8 flash launches (the encoder
                alone: 4, full), within 3e-2 x max|logit| of its twin,
                frames/s and tokens/s, peak memory and a profile; (b)
                ``generate`` on 8 requests of 64 + 32 tokens over 1,500
                frames each, 4 launches (the encoder once, none in the
                decode replays), the captured step against the eager
                decode in lockstep (logits bit for bit), decode tokens/s in
                turns; (c) float32 at full width, one request's prefill
                against its replay through ``decode_step`` after
                ``encdec_build_cross`` (1e-3 x max|logit|); (d) 10 training
                steps of 16 x 448 tokens with zero frames through
                ``launch.train``'s step, batch function and the Trainer, 8
                forward and 8 backward launches a step, the last loss below
                the first, tokens/s, peak memory, a profile; (e) one step's
                gradients with random frames against its
                ``use_kernels(False)`` twin (loss 1e-2, gradients' relative
                L2 5e-2);
 6e. lm_vlm  — llava-next-mistral-7b at its full config (32 layers, bf16,
                random weights and prefix embeddings from --seed), both
                flash kernels timed at its shape (32 heads, 8 KV heads, S =
                4,096, D = 128, causal): (a) ``Model.prefill`` of 4 x
                (2,880 prefix embeddings + 1,216 tokens), 32 launches,
                positions/s and tokens/s, peak memory, a profile, and the
                prefill of embedded tokens as the prefix bit-equal to the
                token prefill of the whole sequence; (b) ``generate`` on 8
                requests of 64 + 32 tokens (tokens only, as JAX decodes),
                no launch, the captured step against the eager decode; (c)
                10 training steps of 1 x (2,880 zero prefix embeddings +
                1,216 tokens), cut to VLM_TRAIN's layers, a forward and a
                backward launch a layer a step, the last loss below the
                first, peak memory;
 6f. lm_moe  — phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b at full width
                (bf16, random weights from --seed), cut in depth
                (MOE_SERVE_LAYERS: neither fits the card whole), both
                flash kernels timed at their prefill shapes (GQA groups 4
                and 16): (a) ``Model.prefill`` of 4 x 4096 tokens, a
                launch a layer, tokens/s, peak memory, a profile, the
                share of (token, choice) pairs dropped by capacity (1.25)
                and one MoE layer's routing, dispatch, expert GEMMs and
                combine timed apart; (b) ``generate`` on 8 requests of 64
                + 32 tokens, no launch, the captured step against the
                eager decode in lockstep, and the decode's drop share (one
                slot an expert at 8 tokens); (c) float32 cut to 3 layers
                at capacity_factor = n_experts (no drop): one request's
                prefill against its replay through the captured
                ``decode_step`` (1e-3 x max|logit|), the graph against the
                eager decode bit for bit, the share of experts flipped
                between the prefill and an eager replay; (d) phi3.5-moe
                only: 10 training steps at MOE_TRAIN (one layer), a
                forward and a backward launch a step, the last loss below
                the first, two gradients of one batch bit-equal, the
                routers' gradients finite and non-zero;
  7. train_more — the slice's other workloads at 256 vDPUs x 2^24 rows,
                d=64, each run with its launches, accuracy and steps/s
                (median of 5 fits): LinearSVM int8 against fp32 (accuracy
                within 0.02); MultinomialLogReg(int8, LUT softmax) against
                (fp32, exact) at C = 4 and 10 (within 0.03; C = 10 takes
                one fxp_matmul launch a dot); minibatch fits on 1,024
                rows a lane a step of LogReg(int8, LUT) at cadence 1 and
                8 (within 0.02 of fp32 full batch) and KMeans(int16)
                (SSE at most 1.05 x fp32 full batch); the default
                minibatch permutation drawn on the card and on the CPU,
                bit-equal;
  8. train_plans — the main path (LogReg int8 + LUT, 256 vDPUs x 2^24
                rows, d=64, 48 steps) under merge plans: the default at
                cadence 1 and 8, SlowMo at 1 and 8, Nesterov at 8, each
                with its launches (the commit launches no kernel of the
                port) and accuracy (an outer plan within 0.01 of the
                default at its cadence), steps/s the median of 5 fits
                timed in turns; SlowMo(beta=0, outer_lr=1) within 1e-5 x
                max|w| of the default at cadence 8, and fit(24) + fit(24)
                with one merge_state equal to fit(48) bit for bit;
  9. train_wire — the main path (48 steps, as train_plans) under the
                compressed and overlapped merges: int8 EF at cadence 1 and
                8, int8 without EF at 1 (printed only), top-k 0.25 at int8
                at 8 (the delta wire), overlap at 1 and 8, overlap + int8
                EF + SlowMo at 8, each with its launches (the overlap's
                prologue is one more phase: 49 and 56 local steps),
                accuracy within 0.01 of the default plan at its cadence
                and wire bytes against the exact wire; steps/s in turns;
                fit(24) + fit(24) = fit(48) under int8 EF at 8 and python
                = scan under overlap + int8 EF at 1 and 8, bit for bit; a
                profile of int8 EF at cadence 1; KMeans(int16) under
                overlap + int8 EF at cadence 1 (its last SSE at most 1.2 x
                the default's + 1e-3);
 10. train_auto — the main path (as train_plans) under the plan
                controller: "auto" at 48 steps (the prior keeps the exact
                wire), AutoTune() at its 96 min_steps_to_explore (every
                candidate probed) and AdaptiveCadence(k_max=8) at 48 (the
                cadence trace replayed through a fresh PlanController),
                each with its launches as its trace implies (the cost
                model's counted round is one more local step), accuracy
                within 0.01 of the default plan's fit of as many steps
                and every measured round at or above its prior (the H100
                roofline of the counted round), printed per candidate;
                steps/s of auto and AdaptiveCadence in turns with the
                default at cadence 1 and 8; a second auto fit of one
                program counts no round;
 11. train_mesh — the main path (LogReg int8 + LUT, 256 vDPUs x 2^24
                rows, d=64) on a mesh of ranks (``make_mesh_grid``): (a)
                a world of one process over NCCL, a (1, 1) mesh: the
                default plan at cadence 1 (50 steps) and 8 (48), int8 EF
                at cadence 1 (50) and "auto" (48), each bit-equal to the
                same fit on ``make_grid`` with the same launches, steps/s
                of the two grids in turns, a profile of 5 steps with
                the NCCL kernels by name and a host trace of one
                cadence-8 fit on each grid in turns (host time by op,
                the ops that differ most); (b) two spawned ranks, pods=2
                and data=1, sharing the card over gloo, each making the
                same data from --seed and keeping 128 lanes: exact at
                cadence 1 and 8, int8 EF at 1 and 8, top-k 0.25 at 8,
                KMeans(int16) and the tree; the ranks bit-equal, exact
                cells within 1e-5 x max|w| of (a)'s make_grid fits,
                compressed accuracy within 0.01 of the exact cell's, the
                tree equal to make_grid's, K-means' SSE at most 1.05 x
                make_grid's; each cell's wire bytes, launches and steps/s;
                and phase 13's dead pod on the real hop (exact and int8
                EF at cadence 8);
 12. train_ckpt — the main path (LogReg int8 + LUT, 256 vDPUs x 2^24
                rows, d=64) through the fault-tolerant
                ``Trainer.for_program``: (a) at cadence 1 (50 steps,
                checkpoints every 10) and 8 (48, every 16), each bit-equal
                to ``Program.fit`` of as many steps with its launches
                (100 / 50, 96 / 48), no restart, every checkpoint on a
                merge boundary; (b) the cadence-1 run with a NaN loss at
                step 23, in line, with ``async_metrics`` and under
                ``RecoveryPolicy(backoff_base_s=0.0)``: one restart from
                the step-20 checkpoint, 50 history entries in order, the
                end bit-equal to (a); (c) a child process (this script
                with ``--ckpt-child DIR``) at cadence 8 on 1,024 rows a
                lane a step, its holder seeded by 8 steps of int8 EF +
                SlowMo at cadence 2, SIGKILLed inside its third round and
                resumed here bit-equal to an uninterrupted run (state,
                counter, EF buffer, momentum, history); (d) steps/s of the
                trainer (also with ``async_metrics``) against
                ``Program.fit`` at cadence 1 and 8 in turns, and one
                save's synchronous and background ms;
 13. train_faults — the main path (LogReg int8 + LUT, 256 vDPUs x 2^24
                rows, d=64) through ``Program.fit`` under an armed
                ``FaultPlan`` (``resilience.runtime.drive_fit``): (a) an
                empty plan at cadence 8 (48 steps) and 1 (50) against the
                unarmed fit, with the same launches (96 / 48, 100 / 50),
                within 1e-6 and 1e-5 x max|w| (bit-equality reported),
                accuracy within 0.01, one host sync a dispatched chunk,
                steps/s of both in turns (5 fits each) and the overhead;
                (b) at cadence 8 on the exact and int8 EF wires, a
                checkpoint every dispatch and RecoveryPolicy(max_restarts
                =10, degrade_after=2, spike_factor=50, backoff_base_s=0):
                a dead lane, a dead pod (pods=4), a NaN lane, a flipped
                wire bit, a 2 ms timeout and torn checkpoints (every save,
                then a NaN lane): 48 finite history entries, the trace
                replayed to the final plan, launches 2 / 1 a step run
                (replays included), 255 / 192 / 256 survivors, a replayed
                rollback bit-equal to the idle fit, dead hardware within
                0.01 accuracy, a quarantined ``*.corrupt`` step, each
                rollback's latency; (c) KMeans(int16) with a dead lane
                (SSE at most 1.05 x fp32's, a launch an iteration); (d) a
                dead lane on the (1, 1) NCCL mesh bit-equal to
                ``make_grid``; train_mesh's two-rank world also runs a
                dead pod at round 2 (exact and int8 EF, 128 survivors,
                the exact cell within 1e-5 x max|w| of ``make_grid``'s);
 14. train_stream — the main path (LogReg int8 + LUT, 256 vDPUs, d=64)
                trained from host rows (``data.StreamingDataset``: X
                float32 (2^24, 64) and y, 4 GiB made on the card from
                --seed and copied to the host once) through ``api.fit``:
                one window's gather, numpy quantization, ``window_host``
                and H2D timed alone; (a) one window of every row
                (``shuffle=False``) at cadence 8, 48 steps, bit-equal to
                the resident full-batch fit with its launches (96 / 48);
                (b) rotations of 2^20 rows (4,096 slots a lane, 16 windows
                an epoch), 8 steps a window, two prefetched, at cadence 8
                and 1 and under int8 EF at 8 (48 steps, 6 windows)
                bit-equal to the windowed resident reference (the same
                windows taken on the card by ``index_select`` with the
                sampler's schedule; the EF buffer too), and one step a
                window for an epoch (16 steps) bit-equal to the resident
                minibatch fit at ``batch_size=4096``, each with its
                launches; (c) steps/s of the rotation at depth 0 and 2 and
                of the resident minibatch fit, 3 fits each in turns, with
                ingest, stall and overlap from ``last_run_stats`` and the
                residency tax; (d) the device memory at every window at or
                under the fit's baseline + 4 staged windows; (e)
                ``Trainer.for_program`` over the ``StreamProgram`` at
                cadence 8, checkpoints every 16 steps, bit-equal to (b)'s
                cadence-8 rotation, every manifest with ``stream_tag`` and
                ``rotation_window``, a fresh trainer resumed from the first
                checkpoint bit-equal; (f) KMeans(int16) at d=16 (1 GiB of
                host rows), one window an iteration, 10 iterations,
                bit-equal to the resident minibatch fit, 10 launches;
 15. train_graph — the compiled engine (``core.graphs``) at 256 vDPUs x
                2^24 rows: LogReg int8 + LUT at cadence 1 and 8, LogReg
                fp32 + exact, LinearSVM int8, LinReg int8, MultinomialLogReg
                int8 + LUT at C = 4, minibatch LogReg at cadence 1 and 8
                and minibatch KMeans (1,024 rows a lane a step), KMeans
                int16 at cadence 1 and 8, and the plans SlowMo at 1 and 8,
                Nesterov at 8, int8 EF at 1 and 8, top-k 0.25 at 8, overlap
                at 1 and 8, overlap + int8 EF + SlowMo at 8 (48 steps, 10
                K-means iterations), each bound once: (a) the scan fit,
                replaying captured chunks, bit-equal to engine="python" in
                the state and every history entry (or within the eager
                fit's own repeat spread, printed); (b) the captures of a
                first fit (a graph a chunk length, and one for a trailing
                round) and 0 for a second fit of the program, and two
                ``api.fit`` calls capturing again each (new closures); (c)
                the port's kernels the replays launch, counted from the
                captured graphs' kernel nodes times their replays
                (``Graph.kernel_nodes``; the profiler lost events in a
                long process), equal to the eager rounds' (2 fxp_* and 1
                lut_kernel a step on the main path); (d) steps/s of the
                graph, engine="python" and the eager chunk loop that scan
                ran before the graphs (``merge_plan.run_rounds`` on the
                eager round), in turns, with idle shares; (e) the graphs'
                pool bytes.  Phases 4-14 count a captured chunk's warm-up
                round and capture in the wrappers' counters, never a
                replay (:func:`fit_expect`);
 15b. autotune — the launch layouts (``tuning.autotune``) with
                ``$REPRO_TORCH_AUTOTUNE_CACHE`` at a temp file for the
                whole phase (the default path is never written): every
                candidate of fxp_matmul (LogReg's forward and gradient
                dots and the multinomial's at C = 10, 256 lanes x 65,536
                rows x 64, int8), kmeans_assign (int16, K = 8, D = 16) and
                split_hist (uint8, 32 bins, 4 classes, at 1, 8 and 32
                nodes) against its plain version (fxp_matmul and
                split_hist bit for bit, kmeans_assign's counts bit for
                bit and sums and sse within 1e-5 of their mass), each
                one's ms (a call: the median of its 10 runs of 20, the
                candidates in turns, forward and back), the
                heuristic's and the winner, the winners stored; then the
                main path under the tuned table against the heuristic, a
                fresh grid each, in turns: LogReg int8 + LUT at cadence 1
                and 8 (steps/s; accuracy within 0.01 of fp32), KMeans
                int16 (iterations/s; SSE at most 1.05 x fp32's) and the
                tree (seconds per tree; equal to the heuristic's);
 15c. ops    — each ``kernels.ops`` entry point against its plain
                version: fxp_matmul's int32 product equal to ``a.int() @
                b.int()`` (K > 4,096 and N > 16 too), split_hist and
                lut_activation bit for bit, kmeans_assign within 1e-5 of
                its mass, flash_attention within its tolerances;
 15d. shard  — the logical sharding rules (``distributed.sharding``,
                ``launch.shardings``): (a) qwen2-0.5b's training step, 4 x
                2048 tokens, 3 steps on a (1, 1) ``("data", "model")``
                NCCL mesh under ``make_rules`` with the state as DTensors,
                the losses and every state leaf bit-equal to the plain
                steps from the same seed, 24 + 24 flash launches a step
                (counters and profiler), the step's ms against the plain
                step's in turns; (b) phi3.5-moe at full width, one layer,
                a float32 prefill of 4 x 4096 with its experts over
                ``model`` = 2 on two spawned ranks over gloo: routes equal
                to the one-rank ``moe_ffn``'s, the logits within 1e-5 of
                max|y|, and bf16 at its bar where gloo takes bf16; (c)
                ``launch.dryrun`` cells (qwen2-0.5b train_4k on both
                production meshes, phi3.5-moe prefill_32k, qwen1.5-110b
                decode_32k and mamba2-370m long_500k on (16, 16)) each
                ``OK``, and (a)'s cell on a (1, 1) fake mesh: its state
                bytes equal (a)'s on the card, its predicted peak beside
                (a)'s; (d) ``launch.dryrun_pim`` logreg at cadence 1 and
                8, one merge collective a round;
 16. the ``kernels`` line (the tuned kernels' entries add ``tuned``, each
     case's winner with its ms and the heuristic's; fxp_matmul's entry also times the
     multinomial's two dots at C = 4 and 10, with their byte bound; the
     main path's replayed launches from train_graph; the flash kernels'
     entries their times at whisper's and llava's shapes and the two
     archs' launches a prefill, a ``generate`` and a train step), the
     nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

Any mismatch, missing launch or exception (a rank's included) ends the
run with a non-zero exit code and without the ``ok`` line.  Without CUDA (and without
--rehearse) it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import pickle
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.pim_ml import CONFIG  # noqa: E402
from repro_torch.core import datasets, make_grid, make_mesh_grid  # noqa: E402
from repro_torch.core import lut as lut_mod  # noqa: E402
from repro_torch.core import minibatch as mb  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, KMeans,  # noqa: E402
                                      LinearSVM, LinReg, LogReg,
                                      MultinomialLogReg, accuracy, api,
                                      multinomial_accuracy, svm_accuracy)
from repro_torch.core.mlalgos.dtree import (bin_dtype,  # noqa: E402
                                            bin_features)
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig, wire_bytes)
from repro_torch.core.graphs import Graph  # noqa: E402
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch.distributed.merge_plan import (  # noqa: E402
    AdaptiveCadence, MergePlan, Nesterov, SlowMo)
from repro_torch.kernels import build, dispatch, ops, ref  # noqa: E402
from repro_torch.kernels import split_hist as split_hist_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_BLOCK_ROWS, BWD_TILE_ROWS, bwd_route, bwd_scratch, flash_attention,
    flash_attention_bwd, route)
from repro_torch.kernels.fxp_matmul import fxp_matmul  # noqa: E402
from repro_torch.kernels.fxp_matmul import route as fxp_route  # noqa: E402
from repro_torch.kernels.kmeans_assign import kmeans_assign  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from repro_torch.kernels.split_hist import split_hist  # noqa: E402
from repro_torch.distributed.sharding import make_rules, use_rules  # noqa: E402
from repro_torch.launch import dryrun, dryrun_pim  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch.mesh import (init_world, make_host_mesh,  # noqa: E402
                                     make_pim_mesh)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.serve_lm import (DecodeStep,  # noqa: E402
                                         Generation, generate)
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as lm_tfm  # noqa: E402
from repro_torch.models.common import LOCAL_ATTN  # noqa: E402
from repro_torch.models.encdec import encdec_build_cross  # noqa: E402
from repro_torch.models.encdec import encode as encdec_encode  # noqa: E402
from repro_torch.models.transformer import padded_vocab  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import StreamingDataset, TokenStream  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.resilience import (FaultEvent, FaultPlan,  # noqa: E402
                                    RecoveryPolicy, faults, replay_trace)
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serving import (MicroBatchQueue, ModelRegistry,  # noqa: E402
                                 PredictRunner)
from repro_torch.tree import (tree_flatten_with_names,  # noqa: E402
                              tree_leaves, tree_map)
from repro_torch.tuning import AutoTune, PlanController  # noqa: E402
from repro_torch.tuning import autotune as at  # noqa: E402

# PimMLConfig's workloads at a size the card holds for real (its reg_rows,
# km_rows and dt_rows were cut to fit the JAX package's CPU container):
# 2^24 rows, a 1 GiB int8 regression set at d=64, a 512 MiB int16 K-means
# set and 256 MiB of uint8 tree bins at d=16
FULL_ROWS = 2 ** 24
LINREG_STEPS = 20
TIMING_ITERS = 20
TIMING_RUNS = 5
KM_RATE_FITS = 5
# the slice's other workloads: the multinomial's class counts (the
# config's 4, and 10 as MNIST-style data has, which takes column groups),
# the minibatch as 1/64 of a lane's rows, the int-vs-fp32 accuracy bars
# of the JAX package's tests (SVM 0.02, multinomial 0.03) and the
# minibatch bar (0.02 of the full-batch fit)
MN_CLASSES = (4, 10)
# fxp_matmul launches of a regression step: the forward and the gradient,
# each a hybrid_matmul of one column
FXP_STEP = 2 * dispatch.hybrid_launches(1)
MB_FRACTION = 64
SVM_ACC_TOL, MN_ACC_TOL, MB_ACC_TOL = 0.02, 0.03, 0.02
PERM_CASES = ((0, 0), (0, 7), (5, 3), (2 ** 40 + 1, 12))
DT_TIMED_TREES = 3
# train_plans: 48 steps (a multiple of the config's cadence 8); an outer
# optimizer's accuracy at most 0.01 below the default plan's at its
# cadence (the card's form of the JAX package's "SlowMo converges no
# worse than the average"); SlowMo(beta=0, outer_lr=1) within 1e-5 of
# max|w| of the default plan (float association only)
PLAN_STEPS = 48
PLAN_ACC_TOL = 0.01
PLAN_BETA0_TOL = 1e-5
# train_wire: the top-k fraction of the delta wire, and K-means under
# overlap + int8 EF held to JAX's test_overlap_kmeans_converges bar (last
# SSE at most 1.2 x the default's + 1e-3)
WIRE_TOP_K = 0.25
KM_WIRE_SSE = 1.2
# kmeans_assign's sums and sse against the plain version's: another
# summation order, so each may differ by 1e-5 of its mass (Σ w·|x| of the
# cell; |sse| + 1 for the sse)
KM_REL_TOL = 1e-5
# train_auto: the plan controller on the main path.  "auto" at 48 steps
# (short: the prior picks, the exact wire by the prior margin), AutoTune()
# at its min_steps_to_explore (96: it probes every candidate), and
# AdaptiveCadence up to cadence 8; accuracy within PLAN_ACC_TOL of the
# default plan's fit of as many steps
AUTO_ADAPTIVE_K_MAX = 8
# the serving path: qwen2-0.5b at its published widths and depth
# train_mesh: the second part's world (pods=2, data=1, both ranks on the
# one card over gloo) and how long a join may take
MESH_RANKS = 2
MESH_JOIN_S = 300.0
# train_ckpt: the main path through Trainer.for_program.  (a) checkpoints
# every 10 steps at cadence 1 and every 16 at the config's cadence, logs
# every 10; (b) a NaN loss at step 23 of the cadence-1 run, which the
# boundary rule rolls back to the step-20 checkpoint; (c) the holder
# seeded by 8 steps of int8 EF + SlowMo at cadence 2, then 48 steps at
# the config's cadence on 1/64 of a lane's rows, checkpoints every 8, the
# child killed inside its third round (and a second process on the card
# takes ~8-10 s to start); (d) rates in turns and one save's cost
CKPT_EVERY, CKPT_EVERY_K, CKPT_LOG_EVERY = 10, 16, 10
CKPT_NAN_STEP, CKPT_NAN_RESTORES = 23, 20
KILL_SEGMENT_STEPS, KILL_STEPS, KILL_EVERY, KILL_DISPATCH = 8, 48, 8, 3
KILL_JOIN_S = 300.0
CKPT_SAVES = 10
# train_faults: the main path under an armed FaultPlan.  (a) an empty plan
# at the config's cadence (48 steps) and at 1 (50) against the unarmed
# fit: within 1e-6 x max|w| at cadence 8 (the survivor merge computes
# state + (S - n·state)/n where the unarmed round computes S·(1/n)) and
# 1e-5 at 1 (states merged where the unarmed step merges partials),
# accuracy within PLAN_ACC_TOL, steps/s of both in turns over 5 fits;
# (b) one fault a cell at the config's cadence on the exact and int8 EF
# wires, test_resilience.py's policy, a checkpoint every clean dispatch
# (a dispatch runs every clean round before the next event, so the
# rounds before round 3 are one dispatch and one save: the faults at
# round 3 restore it); a dead pod is a quarter of the lanes; (c) K-means
# with a dead lane (SSE within the int16 bar); (d) a dead lane on the
# (1, 1) NCCL mesh against make_grid, bit for bit, and (in train_mesh's
# two-rank world) a dead pod at round 2 on the real hop
FAULT_IDLE_TOL_K, FAULT_IDLE_TOL_1 = 1e-6, 1e-5
FAULT_POLICY = RecoveryPolicy(max_restarts=10, degrade_after=2,
                              spike_factor=50.0, backoff_base_s=0.0)
FAULT_PODS = 4
FAULT_TORN_SAVES = 64
FAULT_MESH_POD_ROUND = 2
FAULT_KM_SSE = 1.05
# train_stream: the main path trained from host rows (data.pipeline).  A
# partition of 1/16 of the rows (2^20 of 2^24: 4,096 slots a lane, 16
# windows an epoch), 8 steps a window, two windows prefetched; three
# fits of each in turns for the rates; the trainer checkpoints every 16
# steps
STREAM_PARTS = 16
STREAM_SPW = 8
STREAM_DEPTH = 2
STREAM_RATE_FITS = 3
STREAM_CKPT_EVERY = 16
# serve_pim: the trained main path served through serving.PredictRunner
# (one CUDA graph a bucket), MicroBatchQueue and ModelRegistry.  Request
# sizes of the ladder check (1,300 = 2 x 512 + 276 padded to 512), the
# held-out labelled rows, replays a bucket in the profile, the rate
# batches (64 top-bucket batches, 1,024 of 8 rows), 8-row latency calls,
# the queue's bursts and deadline, and the registry's trainer run
SERVE_PIM_SIZES = (1, 7, 8, 100, 512, 1300)
SERVE_PIM_HELD_OUT = 4096
SERVE_PIM_REPLAYS = 20
SERVE_PIM_TOP_BATCHES, SERVE_PIM_SMALL_BATCHES = 64, 1024
SERVE_PIM_LATENCY_CALLS = 200
SERVE_PIM_RATES = (2000, 8000, 32000)
SERVE_PIM_MAX_BATCH, SERVE_PIM_MAX_WAIT_MS = 32, 2.0
SERVE_PIM_SWAP_REQUESTS, SERVE_PIM_SWAP_RATE = 2000, 8000
SERVE_PIM_TRAIN_STEPS, SERVE_PIM_CKPT_EVERY = 32, 8
# K-means: a row whose two nearest centroids are within this squared
# distance may go either way under another GEMM's summation order
KM_NEAR_TIE = 1e-4
LM_ARCH = "qwen2-0.5b"
LM_BATCH, LM_SEQ = 4, 4096            # prefill: 4 x 4096 tokens
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 64, 32
LM_RATE_REPS = 5
# flash_attention against its plain version (the same online softmax, p
# in float32): float32 within 2e-5 (summation order); bf16 within atol =
# rtol = 1e-2, one bf16 ulp of the output, with at least FLASH_BIT_EQUAL of
# the outputs bit-equal (summation order, tile width and p carried to
# 2^-16 as two bf16 terms move an output across a rounding boundary now
# and then)
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
FLASH_BIT_EQUAL = 0.99
# last logits, as a share of max|logit|: the kernel path against its
# use_kernels(False) twin (float32: summation order through 24 layers;
# bf16: one-ulp differences re-rounded through 24 layers), and the
# float32 prefill against the replay through decode_step (other kernels
# and shapes for every product)
PREFILL_TWIN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CROSS_PATH_TOL = 1e-3
SOURCES = {
    "fxp_matmul": ("src/repro_torch/kernels/csrc/fxp_matmul.cu",
                   "src/repro/kernels/fxp_matmul.py:48"),
    "lut_activation": ("src/repro_torch/kernels/csrc/lut_activation.cu",
                       "src/repro/kernels/lut_activation.py:41"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:61"),
    "split_hist": ("src/repro_torch/kernels/csrc/split_hist.cu",
                   "src/repro/kernels/split_hist.py:58"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    # no TPU kernel: the gradient of the one above
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:73"),
}
LIBRARY_NOTES = {
    "fxp_matmul": "no one PyTorch call computes hybrid_dot: "
                  "torch._int_mm takes int8 x int8 only, has no unsigned "
                  "low limb, and returns no chunked sum",
    "lut_activation": "the lookup is an index computation plus a gather, "
                      "two PyTorch calls (see PERF.md)",
    "kmeans_assign": "no single PyTorch call computes the fused distance, "
                     "argmin and weighted one-hot sums",
    "split_hist": "torch.bincount(flat, weights, minlength) on the combined "
                  "(lane, node, feature, bin, class) index, computed outside "
                  "the timed region (the index is excluded)",
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True) on float32 copies "
                       "of q, k and v: the same function (p in float32), "
                       "timed outside the path; library_bf16_ms is the "
                       "same call on the bf16 views, which rounds p to "
                       "bf16",
    "flash_attention_bwd": "not a TPU kernel: the gradient of "
                           "flash_attention (the JAX package trains through "
                           "jax.grad of its plain attention).  torch.autograd"
                           ".grad of scaled_dot_product_attention(is_causal="
                           "True, enable_gqa=True) on the bf16 views of q, k "
                           "and v: the same function at the same precision "
                           "(its fused backward, like this kernel, rounds p "
                           "and ds to bf16 as product operands), timed "
                           "outside the path; library_fp32_ms is the same "
                           "on float32 copies",
}
PER = {
    "fxp_matmul": "one logreg training step: forward (L,R,d)x(d,1) + "
                  "gradient (L,d,R)x(L,R,1), int8 X, int16 w and r, float32 "
                  "out (multinomial: the same at N = C)",
    "lut_activation": "one training step: sigmoid of z (L,R)",
    "kmeans_assign": "one Lloyd iteration: int16 rows (L,R,16), shared "
                     "centroids (8,16)",
    "split_hist": "one depth-6 tree: the six level passes and the leaf pass "
                  "(1, 2, ..., 64 nodes), (L,R,16) uint8 bins (the tree's "
                  "resident bins; int32_bins: the same at int32), 32 bins, "
                  "4 classes",
    "flash_attention": "one layer's causal self-attention in qwen2-0.5b's "
                       "prefill: q (4, 14, 4096, 64), k and v (4, 2, 4096, "
                       "64), bf16, on the wgmma kernel",
    "flash_attention_bwd": "one layer's attention gradient in qwen2-0.5b's "
                           "training step: q, o, dO (4, 14, 2048, 64), k and "
                           "v (4, 2, 2048, 64), bf16, causal; four launches "
                           "(delta, dQ, dK/dV, the group sum) on wgmma + TMA",
}
PORT_KERNELS = re.compile(r"(fxp_\w+?_kernel|lut_kernel|km_partials|km_reduce"
                          r"|hist_kernel|flash_\w+?_kernel)")
GEMM_KERNELS = re.compile(r"gemm|cutlass|xmma|cublas|nvjet", re.IGNORECASE)


class SmokeFailure(Exception):
    pass


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


WRAPPERS = (fxp_matmul, lut_activation, kmeans_assign, split_hist,
            flash_attention, flash_attention_bwd)


def reset_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def expected(**launches) -> dict:
    """Every wrapper's expected count: those named, and 0 for the rest."""
    return {fn.__name__: launches.get(fn.__name__, 0) for fn in WRAPPERS}


# PimGrid.fit's default chunk of rounds
SCAN_CHUNK = 32


def fit_plan(kw: dict) -> MergePlan:
    """The merge plan of a fit's keyword arguments."""
    return MergePlan.resolve(kw.get("merge_plan"),
                             merge_every=kw.get("merge_every", 1))


def replays_chunks(grid, plan: MergePlan) -> bool:
    """Whether a scan fit of ``plan`` on ``grid`` replays captured chunk
    runners (``core.graphs``): no mesh, no armed fault plan, a static
    plan.  Otherwise its rounds run eagerly."""
    return (grid.mesh is None and faults.armed_context() is None
            and not (plan.adaptive or plan.auto))


def eager_local_steps(steps: int, plan: MergePlan) -> int:
    """Local steps the eager rounds of a fit run: the overlap's prologue
    is one more phase of ``cadence`` steps."""
    return steps + (plan.cadence if plan.overlap and steps >= plan.cadence
                    else 0)


def graph_local_steps(steps: int, plan: MergePlan,
                      chunk: int = SCAN_CHUNK) -> int:
    """Local steps the kernel wrappers' counters see in a scan fit that
    captures its chunk runners anew (``api.fit`` binds new data and
    closures): each graph (the full chunk, the last chunk, a trailing
    short round) counts its warm-up round and its captured rounds once,
    a replay nothing; the overlap's eager prologue counts its phase."""
    k = plan.cadence
    rounds, rem = divmod(steps, k)
    lengths = {min(chunk, rounds)} | ({rounds % chunk} if rounds > chunk
                                      and rounds % chunk else set())
    n = sum((length + 1) * k for length in lengths if rounds)
    return n + 2 * rem + (k if plan.overlap and rounds else 0)


def fit_expect(want: dict, steps: int, grid, **kw) -> dict:
    """``want``, the launches a fit's eager rounds make, as the counters
    see them when the fit captures its chunk runners anew
    (:func:`graph_local_steps`); unchanged where the fit runs eagerly."""
    plan = fit_plan(kw)
    if not replays_chunks(grid, plan) or not steps:
        return want
    eager = eager_local_steps(steps, plan)
    graph = graph_local_steps(steps, plan)
    return {name: n * graph // eager for name, n in want.items()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn, dev: torch.device, iters: int,
              runs: int = TIMING_RUNS) -> float:
    """Median over ``runs`` runs of the time one ``fn()`` takes in a run
    of ``iters`` calls enqueued back to back, after two warm-up calls:
    CUDA events around the run, divided by ``iters``, on the card (so a
    short kernel is not charged its wrapper's host latency); the host
    clock on the CPU."""
    fn()
    fn()
    sync(dev)
    times = []
    for _ in range(runs):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def single_call_ms(fn, dev: torch.device, iters: int) -> float:
    """Median time of one ``fn()`` call, each between its own pair of
    events (the earlier reading, which adds the wrapper's host latency to
    a short kernel), after two warm-up calls."""
    fn()
    fn()
    sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_ms(fn, dev: torch.device, iters: int,
            runs: int = TIMING_RUNS) -> float:
    """Median over ``runs`` runs of the host's time for one ``fn()`` call
    in a run of ``iters`` calls enqueued back to back, after two warm-up
    calls: the host clock from the first call to the return of the last,
    before the card is waited on (what a caller's thread spends in the
    wrapper while the card works)."""
    fn()
    fn()
    sync(dev)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
        sync(dev)
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: int, ops_per_s: float):
    """The least time (ms) for ``n_bytes`` and ``n_ops`` at the card's
    data-sheet rates (``roofline.hw``), and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / hw.HBM_BW, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rand_int(gen, shape, lo, hi, dtype):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int64).to(dtype)


def int16s(gen, shape):
    return rand_int(gen, shape, -32768, 32768, torch.int16)


# -- phase 3 ---------------------------------------------------------------


def compare_fxp(gen, lanes: int, rows: int, d: int) -> list:
    """Kernel == plain (``hybrid_dot``), bit for bit, on a few lanes at
    every layout a workload gives it (each must be read in whole pieces,
    never element by element) and on shapes that reach the rest: both
    routes, N from 1 to 16, int8 and int16 a and b, K over several chunks
    (the gradient's 65,536 rows), ragged M and K, an unaligned view."""
    few = min(lanes, 4)
    X = rand_int(gen, (few, rows, d), -128, 128, torch.int8)
    X16 = int16s(gen, (few, 1000, d))
    batch = X[:, :1024]
    Xr = rand_int(gen, (3, 5000, 77), -128, 128, torch.int8)
    workload = [
        ("logreg forward, shared w", X, int16s(gen, (d, 1))),
        ("logreg forward, per-lane w", X, int16s(gen, (few, d, 1))),
        ("logreg gradient, transposed view", X.transpose(-1, -2),
         int16s(gen, (few, rows, 1))),
        ("multinomial forward, C=4", X, int16s(gen, (d, 4))),
        ("multinomial gradient, C=10", X.transpose(-1, -2),
         int16s(gen, (few, rows, 10))),
        ("multinomial per-lane W, C=10", X, int16s(gen, (few, d, 10))),
        ("request rows, 2-D", X[0, :7], int16s(gen, (d, 10))),
        ("minibatch forward", batch, int16s(gen, (d, 1))),
        ("minibatch gradient", batch.transpose(-1, -2),
         int16s(gen, (few, 1024, 4))),
        ("int16 rows forward", X16, int16s(gen, (d, 1))),
        ("int16 rows gradient", X16.transpose(-1, -2),
         int16s(gen, (few, 1000, 1))),
    ]
    other = [
        ("int8 b, N=16", X, rand_int(gen, (d, 16), -128, 128, torch.int8)),
        ("int16 a, int8 b, gradient, N=8", X16.transpose(-1, -2),
         rand_int(gen, (few, 1000, 8), -128, 128, torch.int8)),
        ("cols, M=77 element loads, K=5000 in two chunks",
         Xr.transpose(-1, -2), int16s(gen, (3, 5000, 16))),
        ("rows, K=77 element loads, N=5", Xr, int16s(gen, (3, 77, 5))),
        ("unaligned view", X[..., 1:], int16s(gen, (d - 1, 4))),
        ("unaligned transposed view", X[..., 1:].transpose(-1, -2),
         int16s(gen, (few, rows, 2))),
    ]
    out = []
    for i, (name, a, b) in enumerate(workload + other):
        got = fxp_matmul(a, b)
        want = ref.fxp_matmul_ref(a, b, k_chunk=4096)
        equal = bool(torch.equal(got, want))
        out.append({"case": name, "a": list(a.shape), "b": list(b.shape),
                    "b_dtype": str(b.dtype)[6:], "route": fxp_route(a),
                    "equal": equal})
        require(equal, f"fxp_matmul != plain version: {name}")
        if i < len(workload) and gen.device.type == "cuda":
            require(not fxp_route(a).endswith("elements"),
                    f"fxp_matmul {name}: a workload layout read element by "
                    f"element ({fxp_route(a)})")
    routes = {o["route"] for o in out}
    require(gen.device.type != "cuda" or routes == {
        "rows/16B", "rows/elements", "cols/8B", "cols/elements"},
        f"fxp_matmul compare reached the routes {sorted(routes)} only")
    return out


def lut_probe(table: lut_mod.LutTable, dev) -> torch.Tensor:
    """Exact midpoints between entries (and their float32 neighbours),
    the end points, values far outside [x_min, x_max], and NaN."""
    step = torch.tensor(table.step, dtype=torch.float32)
    mids = (torch.arange(table.n_entries - 1, dtype=torch.float32) + 0.5) \
        * step + table.x_min
    near = torch.cat([mids, torch.nextafter(mids, mids + 1),
                      torch.nextafter(mids, mids - 1)])
    edge = torch.tensor([table.x_min, table.x_max, -100.0, 100.0, 0.0,
                         -math.inf, math.inf, -1e30, 1e30, math.nan])
    return torch.cat([near, edge]).to(dev)


def compare_lut(gen, lanes: int, rows: int) -> dict:
    table = lut_mod.sigmoid_lut(device=gen.device)
    probe = lut_probe(table, gen.device)
    pos = qz.div_scalar(probe - table.x_min, table.step)
    ties = int((pos - torch.floor(pos) == 0.5).sum())
    z = torch.randn((min(lanes, 4), rows), generator=gen,
                    device=gen.device) * 6
    out = {"ties_in_probe": ties}
    for name, x in (("probe", probe), ("z, few lanes", z)):
        got = lut_activation(x, table.table, x_min=table.x_min,
                             x_max=table.x_max)
        equal = bool(torch.equal(
            got, ref.lut_activation_ref(x, table.table, table.x_min,
                                        table.x_max)))
        out[name] = equal
        require(equal, f"lut_activation != plain version: {name}")
    require(ties > 0, "the LUT probe holds no exact tie")
    return out


def compare_hybrid(gen, lanes: int, rows: int, d: int) -> list:
    """``hybrid_matmul`` with kernels on against ``use_kernels(False)``
    (``hybrid_dot``), bit-equal, up to and past the 16 columns one launch
    takes: int16 b of 1, 4, 10, 16 and 20 columns, int8 b of 9 and 20,
    an int16 a and a per-lane ``(L, K, N)`` b, as the forward and as the
    gradient's transposed view; each with the launches
    ``dispatch.hybrid_launches`` names."""
    few = min(lanes, 4)
    X8 = rand_int(gen, (few, rows, d), -128, 128, torch.int8)
    X16 = rand_int(gen, (few, rows, d), -32768, 32768, torch.int16)
    lo = {torch.int8: -128, torch.int16: -32768}

    def b_of(shape, dtype):
        return rand_int(gen, shape, lo[dtype], -lo[dtype], dtype)

    cases = []
    for X, bdt, widths in ((X8, torch.int16, (1, 4, 10, 16, 20)),
                           (X8, torch.int8, (9, 20)),
                           (X16, torch.int16, (10,))):
        for n in widths:
            what = f"{str(X.dtype)[6:]} a, {str(bdt)[6:]} b, N={n}"
            cases.append((f"forward, {what}", X, b_of((d, n), bdt)))
            cases.append((f"gradient, {what}", X.transpose(-1, -2),
                          b_of((few, rows, n), bdt)))
    cases.append(("forward, per-lane (L, K, N) b, N=10", X8,
                  b_of((few, d, 10), torch.int16)))
    out = []
    for name, a, b in cases:
        before = fxp_matmul.launches
        got = dispatch.hybrid_matmul(a, b)
        launches = fxp_matmul.launches - before
        with dispatch.use_kernels(False):
            want = dispatch.hybrid_matmul(a, b)
        n_launch = dispatch.hybrid_launches(b.shape[-1])
        equal = bool(torch.equal(got, want))
        out.append({"case": name, "a": list(a.shape), "b": list(b.shape),
                    "launches": launches, "expected_launches": n_launch,
                    "equal": equal})
        require(equal, f"hybrid_matmul != hybrid_dot: {name}")
        if a.device.type == "cuda":
            require(launches == n_launch, f"hybrid_matmul {name}: "
                    f"{launches} launches, expected {n_launch}")
    return out


def compare_exp_lut(gen, lanes: int, rows: int) -> dict:
    """The multinomial's one-sided exp table on [-16, 0] through
    ``lut_activation``: the probe (midpoints, -16, 0, values below -16
    and above 0, NaN) and shifted logits of the path's (L, R, C) shape,
    bit-equal to the plain version."""
    table = lut_mod.exp_lut(device=gen.device)
    probe = lut_probe(table, gen.device)
    require(bool((probe == -16).any() and (probe == 0).any()
                 and (probe < -16).any() and probe.isnan().any()),
            "the exp probe lacks -16, 0, a value below -16 or NaN")
    z = torch.randn((min(lanes, 4), rows, max(MN_CLASSES)), generator=gen,
                    device=gen.device) * 6
    out = {}
    for name, x in (("probe", probe),
                    ("shifted logits, few lanes", z - z.amax(-1, True))):
        got = lut_activation(x, table.table, x_min=table.x_min,
                             x_max=table.x_max)
        equal = bool(torch.equal(
            got, ref.lut_activation_ref(x, table.table, table.x_min,
                                        table.x_max)))
        out[name] = equal
        require(equal, f"lut_activation (exp table) != plain: {name}")
    return out


def time_fxp(a, b, dev, iters: int, single: bool = False) -> dict:
    """One ``fxp_matmul`` launch of ``a`` by ``b`` against its plain
    version: bit-equal, its time, the plain version's, its route and its
    bound (each input read once, the float32 output written once; the
    operations: a multiply-add of every limb pair)."""
    got = fxp_matmul(a, b)
    want = ref.fxp_matmul_ref(a, b, k_chunk=4096)
    run = lambda: fxp_matmul(a, b)                             # noqa: E731
    plain = lambda: ref.fxp_matmul_ref(a, b, k_chunk=4096)    # noqa: E731
    p = {"route": fxp_route(a), "equal": bool(torch.equal(got, want)),
         "max_abs_err": max_abs_err(got, want),
         "ms": median_ms(run, dev, iters),
         "plain_ms": median_ms(plain, dev, max(1, iters // 5)),
         "bytes": nbytes(a, b, got),
         "ops": 2 * a.numel() * b.shape[-1] * a.element_size()
                * b.element_size()}
    if single:
        p["single_call_ms"] = single_call_ms(run, dev, iters)
    p["bound_ms"], p["bound_by"] = bound(p["bytes"], p["ops"],
                                         hw.PEAK_OPS_INT8)
    return p


def time_dots(parts: dict, dev, iters: int, single: bool = False) -> dict:
    """A training step's dots (``parts``: name -> (a, b)), each one launch,
    timed by :func:`time_fxp` and summed; fails unless every one is
    bit-equal to the plain version."""
    out = {name: time_fxp(a, b, dev, iters, single)
           for name, (a, b) in parts.items()}
    for name, p in out.items():
        require(p["equal"], f"fxp_matmul != plain at full size: {name}")
    keys = ["ms", "plain_ms", "bytes", "ops"] + ["single_call_ms"] * single
    total = {k: sum(p[k] for p in out.values()) for k in keys}
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"],
                                                 hw.PEAK_OPS_INT8)
    total["max_abs_err"] = max(p["max_abs_err"] for p in out.values())
    total["parts"] = out
    return total


def time_fxp_multinomial(gen, lanes: int, rows: int, d: int, C: int,
                         iters: int) -> dict:
    """The multinomial step's two dots at C classes, one ``fxp_matmul``
    launch each (C <= 16): the forward X·W (int16 W (d, C), float32 logits
    (L, R, C)) and the gradient Xᵀ·R (int16 R (L, R, C), 16 K-chunks)."""
    X = rand_int(gen, (lanes, rows, d), -128, 128, torch.int8)
    W, R = int16s(gen, (d, C)), int16s(gen, (lanes, rows, C))
    out = time_dots({"forward": (X, W), "gradient": (X.transpose(-1, -2), R)},
                    gen.device, iters)
    out["launches_per_step"] = 2 * dispatch.hybrid_launches(C)
    return out


def time_kernels(gen, lanes: int, rows: int, d: int, iters: int) -> dict:
    """Kernel, plain and bound times of one logreg training step's work
    at the path's full shapes (and one more exact comparison there)."""
    dev = gen.device
    X = rand_int(gen, (lanes, rows, d), -128, 128, torch.int8)
    fxp = time_dots({"forward": (X, int16s(gen, (d, 1))),   # cadence 1
                     "gradient": (X.transpose(-1, -2),
                                  int16s(gen, (lanes, rows, 1)))},
                    dev, iters, single=True)
    del X
    table = lut_mod.sigmoid_lut(device=dev)
    z = torch.randn((lanes, rows), generator=gen, device=dev) * 6
    lut_fn = lambda: lut_activation(z, table.table, x_min=table.x_min,  # noqa
                                    x_max=table.x_max)
    lut_ref = lambda: ref.lut_activation_ref(z, table.table,  # noqa: E731
                                             table.x_min, table.x_max)
    lut_err = max_abs_err(lut_fn(), lut_ref())
    require(lut_err == 0.0, f"lut_activation != plain at full size "
            f"({lut_err})")
    lut = {"ms": median_ms(lut_fn, dev, iters),
           "single_call_ms": single_call_ms(lut_fn, dev, iters),
           "plain_ms": median_ms(lut_ref, dev, iters),
           "bytes": 2 * nbytes(z) + nbytes(table.table),
           "ops": 4 * z.numel(),            # subtract, divide, round, clamp
           "max_abs_err": lut_err}
    lut["bound_ms"], lut["bound_by"] = bound(lut["bytes"], lut["ops"],
                                             hw.PEAK_FLOPS_FP32)
    return {"fxp_matmul": fxp, "lut_activation": lut}


def km_inputs(gen, lanes: int, rows: int, d: int, k: int, dtype,
              per_lane: bool) -> tuple:
    """K-means kernel inputs as the path makes them: blobs, quantized per
    feature to int16/int8 (with their scales) or kept float32, sharded
    into (lanes, rows, d); centroids drawn from the rows, shared or one
    per lane; every tenth row masked out."""
    dev = gen.device
    X, _, _ = datasets.blobs(gen, lanes * rows, d, k)
    scale = None
    if dtype != torch.float32:
        q = qz.quantize_symmetric(X, bits=8 * dtype.itemsize, axis=0)
        X, scale = q.values, q.scale
    x = X.reshape(lanes, rows, d)
    xf = x.float() * scale if scale is not None else x
    c = xf[0, :k].clone()
    if per_lane:
        c = c + 0.1 * torch.randn((lanes, k, d), generator=gen, device=dev)
    w = (torch.arange(rows, device=dev) % 10 != 9).float().expand(
        lanes, rows).contiguous()
    return x, c, w, scale, xf


def km_check(name: str, x, c, w, scale, xf) -> dict:
    """kmeans_assign against its plain version: assignments and counts
    bit-equal, sums within KM_REL_TOL of their mass, sse within
    KM_REL_TOL of |sse| + 1, and a second launch bit-equal."""
    got = kmeans_assign(x, c, w, scale, return_assign=True)
    want = ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
    again = kmeans_assign(x, c, w, scale, return_assign=True)
    K = want[0].shape[-2]
    onehot = (want[3].long()[..., None] == torch.arange(K, device=x.device)
              ).double() * w.double()[..., None]
    mass = onehot.transpose(-1, -2) @ xf.abs().double()
    del onehot
    d_sums = (got[0].double() - want[0].double()).abs()
    d_sse = (got[2].double() - want[2].double()).abs()
    out = {"case": name, "x": list(x.shape), "dtype": str(x.dtype),
           "centroids": list(c.shape),
           "assign_equal": bool(torch.equal(got[3], want[3])),
           "counts_equal": bool(torch.equal(got[1], want[1])),
           "sums_max_abs_err": float(d_sums.max()),
           "sums_max_err_over_mass": float((d_sums / mass.clamp(
               min=1e-30)).max()),
           "sse_max_abs_err": float(d_sse.max()),
           "deterministic": all(bool(torch.equal(a, b))
                                for a, b in zip(got, again))}
    require(out["assign_equal"] and out["counts_equal"],
            f"kmeans_assign assignments/counts != plain: {name}")
    require(bool((d_sums <= KM_REL_TOL * mass + 1e-30).all()),
            f"kmeans_assign sums beyond {KM_REL_TOL} of their mass: {out}")
    require(bool((d_sse <= KM_REL_TOL * (want[2].double().abs() + 1)).all()),
            f"kmeans_assign sse beyond tolerance: {out}")
    require(out["deterministic"], f"kmeans_assign not deterministic: {name}")
    return out


def compare_km(gen, lanes: int, rows: int, d: int, k: int) -> list:
    """At the path's shapes (every lane, shared and per-lane centroids,
    float32, int16 and int8 rows), on ragged ones, with every row in one
    cluster, and on rows off the 16-byte grid."""
    out = []
    for dtype in (torch.float32, torch.int16, torch.int8):
        for per_lane in (False, True):
            name = (f"path, {str(dtype)[6:]}, "
                    f"{'per-lane' if per_lane else 'shared'} centroids")
            out.append(km_check(name, *km_inputs(gen, lanes, rows, d, k,
                                                 dtype, per_lane)))
    for L, R, D, K, dtype in ((3, 1001, 5, 3, torch.float32),
                              (2, 777, 33, 17, torch.int8),
                              (5, 300, 16, 1, torch.int16)):
        out.append(km_check(f"ragged L={L} R={R} D={D} K={K}",
                            *km_inputs(gen, L, R, D, K, dtype, True)))
    few = min(lanes, 4)
    # every row of a lane in one cluster (the others far off), int8: the
    # longest chain into one cell, of values that repeat thousands of times
    x, c, w, scale, xf = km_inputs(gen, few, rows, d, k, torch.int8, True)
    c = xf.mean(1, keepdim=True) + torch.zeros_like(c)
    c[:, 1:] += 1e3
    out.append(km_check("int8, one cluster", x, c, w, scale, xf))
    require(bool((ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
                  [3] == 0).all()), "one-cluster case: a row left cluster 0")
    # rows d + 1 elements apart from a base off the 16-byte grid: the
    # element-by-element loads
    x, c, w, scale, xf = km_inputs(gen, few, rows, d + 1, k, torch.int16,
                                   False)
    out.append(km_check("int16, unaligned rows", x[..., 1:],
                        c[:, 1:].contiguous(), w,
                        scale.reshape(-1)[1:].contiguous(), xf[..., 1:]))
    return out


def sh_inputs(gen, lanes: int, rows: int, F: int, nodes: int, bins: int,
              classes: int, dtype=torch.int32) -> tuple:
    dev = gen.device
    node = rand_int(gen, (lanes, rows), 0, nodes, torch.int32)
    xbin = rand_int(gen, (lanes, rows, F), 0, bins, dtype)
    y = rand_int(gen, (lanes, rows), 0, classes, torch.int32)
    w = (torch.arange(rows, device=dev) % 10 != 9).float().expand(
        lanes, rows).contiguous()
    return node, xbin, y, w


def compare_sh(gen, lanes: int, rows: int, F: int, bins: int,
               classes: int) -> list:
    """Bit-equal at depth 0 (every row in one node: the contended pass)
    and at the full tree's final pass (64 nodes), every lane, with the
    path's uint8 bins and with int32; a histogram larger than one block,
    out-of-range indices, int16 bins on a lane-strided view, F = 1, 7 and
    17, uint8 rows off the 16-byte grid, rows narrower than the one
    16-byte load that reads them (views of 7 of 16 uint8 columns and of 5
    of 8 int16 columns, int16 rows of 8 bins), rows not a multiple of a
    block's, few lanes (rows cut into chunks) and weights other than 0/1
    (the float path; dyadic, so any order of the adds is exact); two
    launches equal.  Each case says whether its rows took the 16-byte
    load (``row_vectors``)."""
    cases = []
    for nodes in (1, 64):
        for dtype in (torch.uint8, torch.int32):
            cases.append((f"path, {nodes} node(s), {dtype}", sh_inputs(
                gen, lanes, rows, F, nodes, bins, classes, dtype), nodes,
                bins, classes))
    node, xbin, y, w = sh_inputs(gen, 6, 5000, 40, 96, 16, 3)
    node[0, :3], xbin[1, :3, 0], y[2, 3:6] = 96, 16, -1
    cases.append(("ragged, larger than a block, out-of-range indices",
                  (node, xbin, y, w), 96, 16, 3))
    cases.append(("int16 bins, lane stride 2",
                  (node[::2], xbin[::2].to(torch.int16), y[::2], w[::2]),
                  96, 16, 3))
    for f in (40, 200):
        cases.append((f"{f} features of uint8 bins, 96 nodes, every lane "
                      f"one block a tile (4 and 19 tiles)", sh_inputs(
                          gen, 160, 3001, f, 96, 16, 3, torch.uint8), 96, 16,
                      3))
    node, xbin, y, w = sh_inputs(gen, 3, 1001, 7, 3, 9, 5)
    cases.append(("uint8 bins, 7 features",
                  (node, xbin.to(torch.uint8), y, w), 3, 9, 5))
    for f in (1, 17):
        cases.append((f"uint8 bins, F = {f}", sh_inputs(
            gen, 160, 3001, f, 8, bins, classes, torch.uint8), 8, bins,
            classes))
    node, xbin, y, w = sh_inputs(gen, 160, 3001, F + 1, 4, bins, classes,
                                 torch.uint8)
    cases.append(("uint8 rows off the 16-byte grid ([..., 1:])",
                  (node, xbin[..., 1:], y, w), 4, bins, classes))
    for f, width, dtype in ((7, 16, torch.uint8), (5, 8, torch.int16),
                            (8, 8, torch.int16)):
        node, xbin, y, w = sh_inputs(gen, 160, 3001, width, 8, bins + 2,
                                     classes, dtype)
        cases.append((f"{dtype} rows of {f} of {width} columns (bins up to "
                      f"{bins + 1}), one 16-byte load",
                      (node, xbin[..., :f], y, w), 8, bins, classes))
    cases.append(("few lanes, R not a multiple of a block's rows",
                  sh_inputs(gen, 3, 100003, F, 16, bins, classes,
                            torch.uint8), 16, bins, classes))
    node, xbin, y, w = sh_inputs(gen, lanes, 3001, F, 2, bins, classes,
                                 torch.uint8)
    scale = torch.tensor([0.0, 0.5, 1.0, 2.0], device=gen.device)
    w = scale[rand_int(gen, w.shape, 0, 4, torch.int64)]
    cases.append(("weights 0, 0.5, 1, 2 (the float path)",
                  (node, xbin, y, w), 2, bins, classes))
    out = []
    for name, args, nodes, nb, nc in cases:
        kw = {"n_nodes": nodes, "n_bins": nb, "n_classes": nc}
        got = split_hist(*args, **kw)
        equal = bool(torch.equal(got, ref.split_hist_ref(*args, **kw)))
        again = bool(torch.equal(got, split_hist(*args, **kw)))
        out.append({"case": name, "xbin": list(args[1].shape),
                    "row_vectors": split_hist_mod.row_vectors(args[1]),
                    "nodes": nodes, "equal": equal, "deterministic": again})
        require(equal and again, f"split_hist != plain version: {name}")
    return out


def time_km(gen, lanes: int, rows: int, d: int, k: int, iters: int) -> dict:
    """One Lloyd iteration of the main K-means path: int16 rows, shared
    centroids.  ops = rows x (2KD + 2K distances, 2D |x|^2, D dequantize,
    2D + 2 accumulation)."""
    x, c, w, scale, xf = km_inputs(gen, lanes, rows, d, k, torch.int16,
                                   False)
    check = km_check("timed shapes", x, c, w, scale, xf)
    fn = lambda: kmeans_assign(x, c, w, scale)                  # noqa: E731
    plain = lambda: ref.kmeans_assign_ref(x, c, w, scale)       # noqa: E731
    outs = kmeans_assign(x, c, w, scale)
    n = lanes * rows
    t = {"ms": median_ms(fn, gen.device, iters),
         "single_call_ms": single_call_ms(fn, gen.device, iters),
         "plain_ms": median_ms(plain, gen.device, max(1, iters // 5)),
         "bytes": nbytes(x, c, w, scale, *outs),
         "ops": n * (2 * k * d + 2 * k + 5 * d + 2),
         "max_abs_err": check["sums_max_abs_err"],
         "sse_max_abs_err": check["sse_max_abs_err"],
         "library_ms": None}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_FP32)
    return t


def time_sh(gen, lanes: int, rows: int, F: int, depth: int, bins: int,
            classes: int, iters: int) -> dict:
    """The histograms of one depth-``depth`` tree: one pass per level and
    the leaf pass (1, 2, ..., 2^depth nodes), at the path's uint8 bins
    and, under ``int32_bins``, at int32 bins (what the tree kept resident
    before its bins became uint8).  Bytes: what each reading reads and
    writes; ops = one add per (row, feature) element of weight 1."""
    dev = gen.device
    parts, wide = {}, {}
    for level in range(depth + 1):
        nodes = 2 ** level
        node, xbin, y, w = sh_inputs(gen, lanes, rows, F, nodes, bins,
                                     classes)
        x8 = xbin.to(torch.uint8)
        kw = {"n_nodes": nodes, "n_bins": bins, "n_classes": classes}
        fn = lambda: split_hist(node, x8, y, w, **kw)           # noqa: E731
        fn32 = lambda: split_hist(node, xbin, y, w, **kw)       # noqa: E731
        plain = lambda: ref.split_hist_ref(node, x8, y, w, **kw)  # noqa
        H, want = fn(), plain()
        err = max(max_abs_err(H, want), max_abs_err(fn32(), want))
        require(err == 0.0, f"split_hist != plain at {nodes} nodes ({err})")
        size = H.numel()
        lane = torch.arange(lanes, device=dev)[:, None, None]
        flat = (((((lane * nodes + node.long()[..., None]) * F
                   + torch.arange(F, device=dev)) * bins + xbin.long())
                 * classes + y.long()[..., None])).reshape(-1)
        wf = w[..., None].expand(lanes, rows, F).reshape(-1)
        lib = lambda: torch.bincount(flat, weights=wf,           # noqa: E731
                                     minlength=size)
        require(bool(torch.equal(lib().float(), H.reshape(-1))),
                f"bincount != split_hist at {nodes} nodes")
        ops = int(w.sum()) * F
        parts[f"{nodes} nodes"] = {
            "ms": median_ms(fn, dev, iters),
            "single_call_ms": single_call_ms(fn, dev, iters),
            "plain_ms": median_ms(plain, dev, max(1, iters // 5)),
            "library_ms": median_ms(lib, dev, max(1, iters // 5)),
            "bytes": nbytes(node, x8, y, w, H), "ops": ops,
            "max_abs_err": err}
        wide[f"{nodes} nodes"] = {
            "ms": median_ms(fn32, dev, iters),
            "single_call_ms": single_call_ms(fn32, dev, iters),
            "bytes": nbytes(node, xbin, y, w, H), "ops": ops}
        del flat, wf, node, xbin, x8, y, w, H, want
    t = {key: sum(p[key] for p in parts.values())
         for key in ("ms", "single_call_ms", "plain_ms", "library_ms",
                     "bytes", "ops", "max_abs_err")}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_FP32)
    t["parts"] = parts
    t32 = {key: sum(p[key] for p in wide.values())
           for key in ("ms", "single_call_ms", "bytes", "ops")}
    t32["bound_ms"], t32["bound_by"] = bound(t32["bytes"], t32["ops"],
                                             hw.PEAK_FLOPS_FP32)
    t32["parts"] = {k: p["ms"] for k, p in wide.items()}
    t["int32_bins"] = t32
    return t


# -- phases 4 and 5 --------------------------------------------------------


def counted_fit(workload, grid, X, y, steps, **kw) -> tuple:
    """``api.fit`` with the counters set to 0 just before and read just
    after: (result, launches, {seconds_fit, peak_memory_gib})."""
    dev = grid.device
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = api.fit(workload, grid, X, y, steps=steps, **kw)
    sync(dev)
    stats = {"seconds_fit": time.perf_counter() - t0}
    seen = counts()
    if dev.type == "cuda":
        stats["peak_memory_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return res, seen, stats


def fit_run(name, workload, grid, X, y, steps, expect, check_counts,
            **kw) -> tuple:
    """A regression fit through :func:`counted_fit`; returns (result,
    summary)."""
    res, seen, stats = counted_fit(workload, grid, X, y, steps, **kw)
    losses = [float(m["loss"]) for m in res.history]
    eager, expect = expect, fit_expect(expect, steps, grid, **kw)
    summary = {"run": name, "steps": steps, "launches": seen,
               "expected_launches": expect, "eager_launches": eager,
               **stats,
               "loss_first": losses[0], "loss_last": losses[-1]}
    require(len(losses) == steps, f"{name}: {len(losses)} history entries")
    require(all(math.isfinite(v) for v in losses), f"{name}: loss not "
            "finite")
    require(losses[-1] < losses[0], f"{name}: the loss did not fall")
    require(bool(torch.isfinite(res.state).all()), f"{name}: state not "
            "finite")
    if check_counts:
        require(seen == expect, f"{name}: launches {seen}, the design "
                f"implies {expect}")
    return res, summary


def step_rate(workload, grid, X, y, steps, reps=5, **kw) -> dict:
    """Steady steps/s of ``Program.fit`` on an already-bound program: the
    median, lowest and highest of ``reps`` fits of ``steps`` steps (host
    clock, ending in a synchronise)."""
    program = workload.bind(grid, X, y)
    program.fit(steps=steps, **kw)   # captures the chunks timed below
    sync(grid.device)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        program.fit(steps=steps, **kw)
        sync(grid.device)
        rates.append(steps / (time.perf_counter() - t0))
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "fits": reps}


def profile_steps(workload, grid, X, y, steps: int, **kw) -> dict:
    """Where a main-path step's time goes: ``torch.profiler`` over
    ``steps`` warm steps of ``Program.fit``."""
    program = workload.bind(grid, X, y)
    program.fit(steps=steps, **kw)   # captures the chunks traced below
    return profile_call(lambda: program.fit(steps=steps, **kw), grid.device,
                        steps=steps)


def profile_call(run, dev, match: str | None = None, host_ops: int = 0,
                 **label) -> dict:
    """``torch.profiler`` over one call of ``run()`` (after a warm-up
    elsewhere): device time by kernel and the device's idle share of the
    traced window; with ``match``, also every kernel whose name holds it
    (any case), by name; with ``host_ops``, the host's self time of
    every op (``host_ms``) and the ``host_ops`` largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {}
    if host_ops:
        host = {"host_ms": {e.key: e.self_cpu_time_total / 1e3
                            for e in events
                            if e.device_type == DeviceType.CPU}}
        host["top_host_ops"] = [
            {"name": e.key, "calls": e.count,
             "ms": e.self_cpu_time_total / 1e3}
            for e in sorted(events, key=lambda e: -e.self_cpu_time_total)
            if e.device_type == DeviceType.CPU][:host_ops]
    if not kernels:
        return {**label, **host, "device_time": "not measured (the "
                "profiler recorded no device events)",
                "traced_wall_ms": wall_ms}
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]

    def name(key: str) -> str:                         # names are mangled
        found = PORT_KERNELS.search(key)
        return found.group(1) if found else key[:90]

    ours = sum(e.self_device_time_total for e in kernels
               if PORT_KERNELS.search(e.key))
    gemm = sum(e.self_device_time_total for e in kernels
               if GEMM_KERNELS.search(e.key))
    out = {**label, "traced_wall_ms": wall_ms,
           "device_busy_ms": busy_us / 1e3,
           "device_kernel_calls": sum(e.count for e in kernels),
           "idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
           "port_kernels_ms": ours / 1e3,
           "gemm_kernels_ms": gemm / 1e3,
           "top_kernels": [{"name": name(e.key), "calls": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top], **host}
    if match is not None:
        out[f"{match}_kernels"] = [
            {"name": e.key[:90], "calls": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in kernels if match.lower() in e.key.lower()]
    return out


def small_parity(dev, seed: int, d: int) -> dict:
    """A small int8 + LUT fit equals its use_kernels(False) twin."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    X, y, _ = datasets.binary_classification(gen, 8 * 4096 + 5, d)
    grid = make_grid(8, device=dev)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    out = {}
    for k in (1, 4):
        a = api.fit(wl, grid, X, y, steps=10, merge_every=k)
        with dispatch.use_kernels(False):
            b = api.fit(wl, grid, X, y, steps=10, merge_every=k)
        equal = bool(torch.equal(a.state, b.state)) and all(
            bool(torch.equal(m["loss"], n["loss"]))
            for m, n in zip(a.history, b.history))
        out[f"cadence_{k}"] = equal
        require(equal, f"small fit at cadence {k} != its plain twin")
    return out


def train(args, dev, card: str) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    grid = make_grid(args.lanes, device=dev)
    X, y, w_true = datasets.binary_classification(gen, args.rows, args.features)
    check = not args.rehearse
    runs = []
    t0 = time.perf_counter()
    ref_res, s = fit_run("logreg fp32 exact", LogReg(lr=0.5), grid, X, y,
                         args.steps, expected(), check)
    acc_ref = accuracy(ref_res.state, X, y)
    s["accuracy"] = acc_ref
    runs.append(s)

    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    # the main path: its counters are the kernels line's "launches"
    main_res, s = fit_run("logreg int8 lut, cadence 1", wl, grid, X, y,
                          args.steps,
                          expected(fxp_matmul=FXP_STEP * args.steps,
                                   lut_activation=args.steps), check)
    main_counts = s["launches"]
    s["accuracy"] = accuracy(main_res.state, X, y)
    s["steps_per_s"] = step_rate(wl, grid, X, y, args.steps)
    require(abs(s["accuracy"] - acc_ref) <= 0.01, "int8 + LUT accuracy "
            f"{s['accuracy']} is not within 0.01 of fp32 {acc_ref}")
    runs.append(s)
    emit("profile", workload="logreg", **profile_steps(wl, grid, X, y, 5))

    k = args.cadence
    cad_res, s = fit_run(f"logreg int8 lut, cadence {k}", wl, grid, X, y,
                         args.cadence_steps,
                         expected(fxp_matmul=FXP_STEP * args.cadence_steps,
                                  lut_activation=args.cadence_steps), check,
                         merge_every=k)
    s["accuracy"] = accuracy(cad_res.state, X, y)
    s["steps_per_s"] = step_rate(wl, grid, X, y, args.cadence_steps,
                                 merge_every=k)
    require(abs(s["accuracy"] - acc_ref) <= 0.01, f"cadence {k} accuracy "
            f"{s['accuracy']} is not within 0.01 of fp32 {acc_ref}")
    runs.append(s)
    requests = X[:512].clone()
    del X, y, ref_res, cad_res

    Xr, yr, _ = datasets.regression(gen, args.rows, args.features)
    lin = LinReg(lr=0.1, precision="int8")
    _, s = fit_run("linreg int8, cadence 1", lin, grid, Xr, yr,
                   args.linreg_steps,
                   expected(fxp_matmul=FXP_STEP * args.linreg_steps),
                   check)
    s["steps_per_s"] = step_rate(lin, grid, Xr, yr, args.linreg_steps)
    runs.append(s)
    del Xr, yr
    emit("train", workload="logreg/linreg", card=card, lanes=args.lanes,
         rows=args.rows, features=args.features,
         runs=runs, small_parity=small_parity(dev, args.seed, args.features),
         seconds=time.perf_counter() - t0)
    return wl, main_res.state, requests, main_counts, w_true


def km_run(name, wl, grid, X, iters, check, launches=None, **kw) -> tuple:
    """One K-means fit: one ``kmeans_assign`` launch per iteration (or
    ``launches``), a finite state, and (at cadence 1, where Lloyd's SSE
    cannot rise) the last SSE at most the first."""
    res, seen, stats = counted_fit(wl, grid, X, None, iters, **kw)
    sse = [float(m["sse"]) for m in res.history]
    eager = expected(kmeans_assign=iters if launches is None else launches)
    want = fit_expect(eager, iters, grid, **kw)
    summary = {"run": name, "iterations": iters, "launches": seen,
               "expected_launches": want, "eager_launches": eager, **stats,
               "sse_first": sse[0], "sse_last": sse[-1],
               "moved_last": float(res.history[-1]["moved"]),
               "eval_sse": res.eval(X)["sse"]}
    require(len(sse) == iters and all(math.isfinite(v) for v in sse),
            f"{name}: history {sse}")
    require(bool(torch.isfinite(res.state).all()), f"{name}: state not "
            "finite")
    if kw.get("merge_every", 1) == 1:
        require(sse[-1] <= sse[0], f"{name}: the SSE rose")
    if check:
        require(seen == want, f"{name}: launches {seen}, the design "
                f"implies {want}")
    return res, summary


def small_km_parity(dev, seed: int, d: int, k: int) -> dict:
    """Small K-means fits against their use_kernels(False) twins (within
    atol 1e-4, rtol 1e-5: counts are exact, sums differ in order), and
    the python engine bit-equal to the scan engine.  The fits start near
    the blobs' centres: from random rows two centroids can split one
    blob, and a row on that dense boundary flips on a 1-ulp difference
    of the centroids and moves them by |x| / count."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    X, _, centers = datasets.blobs(gen, 8 * 4096 + 5, d, k)
    c0 = centers + 0.1 * torch.randn(centers.shape, generator=gen,
                                     device=dev)
    grid = make_grid(8, device=dev)
    out = {}
    for precision in ("fp32", "int16"):
        for cadence in (1, 4):
            program = KMeans(k=k, precision=precision).bind(grid, X)
            program.state0 = c0
            a = program.fit(steps=10, merge_every=cadence)
            with dispatch.use_kernels(False):
                b = program.fit(steps=10, merge_every=cadence)
            c = program.fit(steps=10, merge_every=cadence, engine="python")
            case = {"max_abs_err": max_abs_err(a.state, b.state),
                    "within_tolerance": bool(torch.allclose(
                        a.state, b.state, atol=1e-4, rtol=1e-5)),
                    "python_equals_scan": bool(torch.equal(a.state,
                                                           c.state))}
            out[f"{precision}, cadence {cadence}"] = case
            require(case["within_tolerance"] and case["python_equals_scan"],
                    f"small K-means fit ({precision}, cadence {cadence}): "
                    f"{case}")
    return out


def train_kmeans(args, dev, card: str) -> tuple:
    """K-means on blobs: fp32 (the yardstick), int16 at cadence 1 (the
    main K-means path) and int16 at cadence 8 (a round of 8 and one of
    2)."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 10)
    grid = make_grid(args.lanes, device=dev)
    d, k, iters = args.km_features, args.km_clusters, args.km_iters
    X, _, _ = datasets.blobs(gen, args.rows, d, k)
    check = not args.rehearse
    t0 = time.perf_counter()
    _, ref_s = km_run("kmeans fp32, cadence 1", KMeans(k=k), grid, X, iters,
                      check)
    wl = KMeans(k=k, precision="int16")
    main_res, s = km_run("kmeans int16, cadence 1", wl, grid, X, iters,
                         check)
    main_counts = s["launches"]
    s["iterations_per_s"] = step_rate(wl, grid, X, None, iters,
                                      reps=KM_RATE_FITS)
    require(s["eval_sse"] <= 1.05 * ref_s["eval_sse"], f"int16 SSE "
            f"{s['eval_sse']} above 1.05 x fp32 {ref_s['eval_sse']}")
    emit("profile", workload="kmeans", **profile_steps(wl, grid, X, None,
                                                        iters))
    _, cad_s = km_run(f"kmeans int16, cadence {args.cadence}", wl, grid, X,
                      iters, check, merge_every=args.cadence)
    cad_s["iterations_per_s"] = step_rate(wl, grid, X, None, iters,
                                          reps=KM_RATE_FITS,
                                          merge_every=args.cadence)
    requests = X[:512].clone()
    del X
    emit("train", workload="kmeans", card=card, lanes=args.lanes,
         rows=args.rows, features=d, clusters=k,
         runs=[ref_s, s, cad_s],
         small_parity=small_km_parity(dev, args.seed, d, k),
         seconds=time.perf_counter() - t0)
    return wl, main_res.state, requests, main_counts


def train_tree(args, dev, card: str) -> tuple:
    """DecisionTree on the labelled mixture: one split_hist launch per
    level and one for the leaf pass, and the tree equal to its
    use_kernels(False) twin."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    grid = make_grid(args.lanes, device=dev)
    X, y = datasets.mixture_classification(gen, args.rows, args.dt_features,
                                           args.dt_classes)
    wl = DecisionTree(max_depth=args.dt_depth, n_bins=args.dt_bins,
                      n_classes=args.dt_classes)
    t0 = time.perf_counter()
    res, seen, stats = counted_fit(wl, grid, X, y, wl.max_depth)
    levels = len(res.history)
    reached = sum(1 for h in res.history if h["splits"] > 0)
    want = expected(split_hist=levels + (1 if reached else 0))
    if not args.rehearse:
        require(seen == want, f"tree: launches {seen}, the design implies "
                f"{want}")
    with dispatch.use_kernels(False):
        twin = api.fit(wl, grid, X, y, steps=wl.max_depth)
    equal = {f: bool(torch.equal(getattr(res.state, f),
                                 getattr(twin.state, f)))
             for f in ("feature", "threshold", "leaf_value", "bin_edges")}
    require(all(equal.values()), f"tree != its plain twin: {equal}")
    acc = res.eval(X, y)["accuracy"]
    require(acc > 0.5, f"tree training accuracy {acc}")
    times = []
    for _ in range(DT_TIMED_TREES):
        sync(dev)
        t1 = time.perf_counter()
        api.fit(wl, grid, X, y, steps=wl.max_depth)
        sync(dev)
        times.append(time.perf_counter() - t1)
    emit("profile", workload="dtree", **profile_call(
        lambda: api.fit(wl, grid, X, y, steps=wl.max_depth), dev, trees=1))
    # the binning alone (DecisionTree.prepare: the column sort of the
    # percentile edges, then the chunked searchsorted into uint8 bins),
    # and its bins alone
    emit("profile", workload="dtree binning", **profile_call(
        lambda: wl.prepare(grid, X, y), dev, prepares=1))
    edges = wl.prepare(grid, X, y)[2]["_edges"]
    emit("profile", workload="dtree binning, bins only", **profile_call(
        lambda: bin_features(X, edges, bin_dtype(wl.n_bins)), dev))
    requests = X[:512].clone()
    emit("train", workload="dtree", card=card, lanes=args.lanes,
         rows=args.rows, features=args.dt_features, depth=wl.max_depth,
         bins=wl.n_bins, classes=wl.n_classes,
         runs=[{"run": "dtree, first fit", "launches": seen,
                "expected_launches": want, **stats, "levels": levels,
                "reached_depth": reached,
                "splits_per_level": [h["splits"] for h in res.history],
                "accuracy": acc, "equal_to_plain_twin": equal,
                "seconds_per_tree": {"median": statistics.median(times),
                                     "min": min(times), "max": max(times),
                                     "trees": len(times)}}],
         seconds=time.perf_counter() - t0)
    return wl, res.state, requests, seen


def rated_run(name, wl, grid, X, y, steps, expect, check, acc_fn,
              **kw) -> tuple:
    """:func:`fit_run` (:func:`km_run` for K-means), the run's accuracy
    (``acc_fn(state)``) and its steps/s (median of 5 fits, as the train
    phase times them)."""
    if isinstance(wl, KMeans):
        res, s = km_run(name, wl, grid, X, steps, check, **kw)
    else:
        res, s = fit_run(name, wl, grid, X, y, steps, expect, check, **kw)
        s["accuracy"] = acc_fn(res.state)
    s["steps_per_s"] = step_rate(wl, grid, X, y, steps,
                                 reps=KM_RATE_FITS, **kw)
    return res, s


def permutation_on_card_and_cpu(dev, per: int) -> list:
    """The default minibatch permutation drawn on the card and on the CPU
    for a few (seed, epoch): bit-equal, and a permutation."""
    out = []
    for seed, epoch in PERM_CASES:
        here = mb.hashed_permutation(seed, torch.tensor(epoch, device=dev),
                                     per)
        host = mb.hashed_permutation(seed, torch.tensor(epoch), per)
        equal = bool(torch.equal(here.cpu(), host))
        is_perm = bool(torch.equal(torch.sort(host).values,
                                   torch.arange(per)))
        out.append({"seed": seed, "epoch": epoch, "slots": per,
                    "device": here.device.type, "equal": equal,
                    "permutation": is_perm, "first": host[:4].tolist()})
        require(equal and is_perm, f"default permutation (seed {seed}, "
                f"epoch {epoch}): card != CPU or not a permutation")
    return out


def train_more(args, dev, card: str) -> None:
    """The slice's other workloads at the path's full size, each run with
    its launches checked, its accuracy and steps/s: LinearSVM int8 against
    fp32 (within SVM_ACC_TOL); MultinomialLogReg(int8, LUT softmax)
    against (fp32, exact) at C = 4 and 10 (within MN_ACC_TOL); minibatch
    fits of LogReg(int8, LUT) at cadence 1 and the config's 8 (within
    MB_ACC_TOL of fp32 full batch) and of KMeans(int16) (SSE at most
    1.05 x fp32 full batch), on batch_size = rows a lane / 64; and the
    default permutation drawn on the card and on the CPU."""
    grid = make_grid(args.lanes, device=dev)
    check = not args.rehearse
    steps, cfg = args.steps, CONFIG
    batch = args.rows // args.lanes // MB_FRACTION
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 40)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)

    def svm_acc(w):
        return svm_accuracy(w, X, y)

    runs = []
    _, ref_s = rated_run("svm fp32", LinearSVM(lr=0.1, l2=cfg.svm_l2), grid,
                         X, y, steps, expected(), check, svm_acc)
    _, s = rated_run("svm int8", LinearSVM(lr=0.1, l2=cfg.svm_l2,
                                           precision="int8"), grid, X, y,
                     steps, expected(fxp_matmul=FXP_STEP * steps), check,
                     svm_acc)
    require(abs(s["accuracy"] - ref_s["accuracy"]) <= SVM_ACC_TOL,
            f"svm int8 accuracy {s['accuracy']} not within {SVM_ACC_TOL} of "
            f"fp32 {ref_s['accuracy']}")
    runs += [ref_s, s]

    def lr_acc(w):
        return accuracy(w, X, y)

    _, full_s = rated_run("logreg fp32 exact, full batch", LogReg(lr=0.5),
                          grid, X, y, steps, expected(), check, lr_acc)
    runs.append(full_s)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    emit("profile", workload=f"logreg minibatch {batch}", **profile_steps(
        wl, grid, X, y, 5, batch_size=batch))
    for k, n in ((1, steps), (args.cadence, args.cadence_steps)):
        _, s = rated_run(f"logreg int8 lut, batch_size {batch}, cadence {k}",
                         wl, grid, X, y, n,
                         expected(fxp_matmul=FXP_STEP * n, lut_activation=n),
                         check,
                         lr_acc, merge_every=k, batch_size=batch)
        require(s["accuracy"] >= full_s["accuracy"] - MB_ACC_TOL,
                f"{s['run']}: accuracy {s['accuracy']} more than "
                f"{MB_ACC_TOL} below full batch {full_s['accuracy']}")
        runs.append(s)
    del X, y

    for C in MN_CLASSES:
        X, y = datasets.mixture_classification(gen, args.rows,
                                               args.features, C)

        def mn_acc(W):
            return multinomial_accuracy(W, X, y)

        _, ref_s = rated_run(f"multinomial fp32 exact, C={C}",
                             MultinomialLogReg(n_classes=C), grid, X, y,
                             steps, expected(), check, mn_acc)
        n_fxp = 2 * dispatch.hybrid_launches(C)
        wl = MultinomialLogReg(n_classes=C, precision="int8", softmax="lut")
        _, s = rated_run(f"multinomial int8 lut, C={C}", wl, grid, X, y,
                         steps, expected(fxp_matmul=n_fxp * steps,
                                         lut_activation=steps), check, mn_acc)
        emit("profile", workload=f"multinomial C={C}", **profile_steps(
            wl, grid, X, y, 5))
        require(abs(s["accuracy"] - ref_s["accuracy"]) <= MN_ACC_TOL,
                f"{s['run']}: accuracy {s['accuracy']} not within "
                f"{MN_ACC_TOL} of fp32 {ref_s['accuracy']}")
        runs += [ref_s, s]
        del X, y

    X, _, _ = datasets.blobs(gen, args.rows, args.km_features,
                             args.km_clusters)
    k, iters = args.km_clusters, args.km_iters
    _, ref_s = rated_run("kmeans fp32, full batch", KMeans(k=k), grid, X,
                         None, iters, None, check, None)
    _, s = rated_run(f"kmeans int16, batch_size {batch}",
                     KMeans(k=k, precision="int16"), grid, X, None, iters,
                     None, check, None, batch_size=batch)
    require(s["eval_sse"] <= 1.05 * ref_s["eval_sse"], f"{s['run']}: SSE "
            f"{s['eval_sse']} above 1.05 x fp32 full batch "
            f"{ref_s['eval_sse']}")
    runs += [ref_s, s]
    del X
    emit("train_more", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, batch_size=batch, runs=runs,
         permutation=permutation_on_card_and_cpu(
             dev, args.rows // args.lanes),
         seconds=time.perf_counter() - t0)


def rates_in_turns(program, plans: dict, steps: int, fits: int) -> dict:
    """Steps/s of ``Program.fit`` under each plan: the median, lowest and
    highest of ``fits`` fits, taken in turns (the plans in order, then in
    reverse, ...) so that a drift of the card's rate between calls falls
    on every plan alike."""
    dev = program.grid.device
    for plan in plans.values():
        program.fit(steps=steps, merge_plan=plan)
    sync(dev)
    rates: dict = {name: [] for name in plans}
    order = list(plans)
    for i in range(fits):
        for name in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            program.fit(steps=steps, merge_plan=plans[name])
            sync(dev)
            rates[name].append(steps / (time.perf_counter() - t0))
    return {name: {"median": statistics.median(r), "min": min(r),
                   "max": max(r), "fits": fits}
            for name, r in rates.items()}


def train_plans(args, dev, card: str) -> None:
    """The main path under the merge plans at its full size: the default
    plan at cadence 1 and the config's 8, SlowMo at 1 and 8 and Nesterov
    at 8, each run with its launches and accuracy, their steps/s in
    turns; SlowMo(beta=0, outer_lr=1) against the default at cadence 8;
    the momentum carried across two fits against one; a profile of SlowMo
    at cadence 1 (the commit every step)."""
    grid = make_grid(args.lanes, device=dev)
    check = not args.rehearse
    steps, k = PLAN_STEPS, args.cadence
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 60)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    expect = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
    plans = {"default, cadence 1": MergePlan(),
             "SlowMo, cadence 1": MergePlan(outer=SlowMo()),
             f"default, cadence {k}": MergePlan(cadence=k),
             f"SlowMo, cadence {k}": MergePlan(cadence=k, outer=SlowMo()),
             f"Nesterov, cadence {k}": MergePlan(cadence=k,
                                                 outer=Nesterov()),
             f"SlowMo(beta=0, outer_lr=1), cadence {k}": MergePlan(
                 cadence=k, outer=SlowMo(beta=0.0, outer_lr=1.0))}
    runs, states = [], {}
    for name, plan in plans.items():
        res, s = fit_run(f"logreg int8 lut, {name}", wl, grid, X, y, steps,
                         expect, check, merge_plan=plan)
        s["accuracy"] = accuracy(res.state, X, y)
        runs.append(s)
        states[name] = res.state
        default = f"default, cadence {plan.cadence}"
        if name.startswith(("SlowMo,", "Nesterov,")):
            acc = runs[list(plans).index(default)]["accuracy"]
            require(s["accuracy"] >= acc - PLAN_ACC_TOL,
                    f"{s['run']}: accuracy {s['accuracy']} more than "
                    f"{PLAN_ACC_TOL} below the default plan's {acc}")
    w0 = states[f"default, cadence {k}"]
    gap = float((states[f"SlowMo(beta=0, outer_lr=1), cadence {k}"]
                 - w0).abs().max())
    beta0 = {"max_abs_dw": gap, "max_abs_w": float(w0.abs().max()),
             "bound": PLAN_BETA0_TOL * float(w0.abs().max())}
    require(gap <= beta0["bound"], f"SlowMo(beta=0, outer_lr=1) at cadence "
            f"{k}: max|dw| {gap} above {beta0['bound']}")

    program = wl.bind(grid, X, y)
    plan = plans[f"SlowMo, cadence {k}"]

    def fit(state, n, holder=None):
        return program.grid.fit(init_state=state, local_fn=program.local_fn,
                                update_fn=program.update_fn,
                                data=program.data, steps=n, merge_plan=plan,
                                merge_state=holder)[0]

    holder: dict = {}
    one = fit(program.state0, steps)
    two = fit(fit(program.state0, steps // 2, holder), steps // 2, holder)
    carried = {"steps": [steps // 2, steps // 2], "plan": plan.describe(),
               "bit_equal": bool(torch.equal(one, two)),
               "commits": int(holder["momentum"].step)}
    require(carried["bit_equal"], "SlowMo: fit(24) + fit(24) with one "
            "merge_state != fit(48)")
    timed = {name: plans[name] for name in list(plans)[:5]}
    rates = rates_in_turns(program, timed, steps, KM_RATE_FITS)
    program.fit(steps=5, merge_plan=plans["SlowMo, cadence 1"])
    emit("profile", workload="logreg SlowMo, cadence 1", **profile_call(
        lambda: program.fit(steps=5, merge_plan=plans["SlowMo, cadence 1"]),
        dev, steps=5))
    for s in runs:
        name = s["run"].split(", ", 1)[1]
        if name in rates:
            s["steps_per_s"] = rates[name]
    del X, y, program
    emit("train_plans", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, steps=steps, runs=runs, beta0=beta0,
         momentum_carried=carried, seconds=time.perf_counter() - t0)


def wire_summary(holder: dict, cfg) -> dict:
    """What crosses the host hop in one merge round, from the error
    buffer the fit left in ``holder`` (the wire's shapes and dtypes with
    a leading hop axis): its bytes exact and under ``cfg``."""
    wire = tree_map(lambda e: e[0], holder["error"])
    return {"shapes": {k: list(v.shape) for k, v in wire.items()}
            if isinstance(wire, dict) else list(wire.shape),
            "exact_bytes": wire_bytes(wire, None),
            "bytes": wire_bytes(wire, cfg)}


def train_wire(args, dev, card: str) -> None:
    """The main path under the compressed and overlapped merges at its
    full size: int8 EF at cadence 1 and 8, int8 without EF at cadence 1
    (printed, not held), top-k 0.25 at int8 on the delta wire at cadence
    8, overlap at 1 and 8, overlap + int8 EF + SlowMo at 8, each with its
    launches (the overlap's prologue adds one phase), its accuracy
    against the default plan at its cadence and its wire bytes; steps/s
    in turns; fit(24) + fit(24) against fit(48) under int8 EF at cadence
    8 and python against scan under overlap + int8 EF at 1 and 8, bit for
    bit; a profile of int8 EF at cadence 1; and KMeans(int16) under
    overlap + int8 EF at cadence 1 against the default."""
    grid = make_grid(args.lanes, device=dev)
    check = not args.rehearse
    steps, k, d = PLAN_STEPS, args.cadence, args.features
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 80)
    X, y, _ = datasets.binary_classification(gen, args.rows, d)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    int8, topk = CompressionConfig(bits=8), CompressionConfig(
        bits=8, top_k_frac=WIRE_TOP_K)
    # local steps of each run: the overlap's prologue is one more phase
    # (1 step at cadence 1, k at cadence k) whose metrics are not reported
    plans = {
        "default, cadence 1": (MergePlan(), steps),
        "int8 EF, cadence 1": (MergePlan(compression=int8), steps),
        "int8 no EF, cadence 1": (MergePlan(compression=CompressionConfig(
            bits=8, error_feedback=False)), steps),
        "overlap, cadence 1": (MergePlan(overlap=True), steps + 1),
        f"default, cadence {k}": (MergePlan(cadence=k), steps),
        f"int8 EF, cadence {k}": (MergePlan(cadence=k, compression=int8),
                                  steps),
        f"top-k {WIRE_TOP_K} int8, cadence {k}": (
            MergePlan(cadence=k, compression=topk), steps),
        f"overlap, cadence {k}": (MergePlan(cadence=k, overlap=True),
                                  steps + k),
        f"overlap + int8 EF + SlowMo, cadence {k}": (MergePlan(
            cadence=k, overlap=True, compression=int8, outer=SlowMo()),
            steps + k),
    }
    # the wire of one round: the partials {g: (d,), loss: ()} at cadence
    # 1, the state (d,) at cadence k, all float32
    want_wire = {1: (4 * d + 4, {int8: (d + 4) + (1 + 4)}),
                 k: (4 * d, {int8: d + 4,
                             topk: int(d * WIRE_TOP_K) * (1 + 4) + 4})}
    runs, wires = [], {}
    for name, (plan, local) in plans.items():
        holder: dict = {}
        res, s = fit_run(f"logreg int8 lut, {name}", wl, grid, X, y, steps,
                         expected(fxp_matmul=FXP_STEP * local,
                                  lut_activation=local), check,
                         merge_plan=plan, merge_state=holder)
        s["local_steps"] = local
        s["accuracy"] = accuracy(res.state, X, y)
        if plan.compression is not None:
            w = wire_summary(holder, plan.compression)
            exact, per_cfg = want_wire[plan.cadence]
            w["expected"] = [exact, per_cfg.get(plan.compression)]
            s["wire"] = wires[name] = w
            if plan.compression in per_cfg:
                require([w["exact_bytes"], w["bytes"]] == w["expected"],
                        f"{s['run']}: wire {w}")
        runs.append(s)
        if not name.startswith(("default", "int8 no EF")):
            acc = runs[list(plans).index(
                f"default, cadence {plan.cadence}")]["accuracy"]
            require(s["accuracy"] >= acc - PLAN_ACC_TOL,
                    f"{s['run']}: accuracy {s['accuracy']} more than "
                    f"{PLAN_ACC_TOL} below the default plan's {acc}")

    program = wl.bind(grid, X, y)
    ef8 = plans[f"int8 EF, cadence {k}"][0]

    def fit(state, n, holder):
        return program.grid.fit(init_state=state, local_fn=program.local_fn,
                                update_fn=program.update_fn,
                                data=program.data, steps=n, merge_plan=ef8,
                                merge_state=holder)[0]

    one = fit(program.state0, steps, None)
    holder = {}
    two = fit(fit(program.state0, steps // 2, holder), steps // 2, holder)
    split = {"steps": [steps // 2, steps // 2], "plan": ef8.describe(),
             "bit_equal": bool(torch.equal(one, two))}
    require(split["bit_equal"], f"{ef8.describe()}: fit(24) + fit(24) with "
            "one merge_state != fit(48)")
    engines = []
    for plan in (MergePlan(overlap=True, compression=int8),
                 MergePlan(cadence=k, overlap=True, compression=int8)):
        a = program.fit(steps=steps, engine="python", merge_plan=plan)
        b = program.fit(steps=steps, engine="scan", merge_plan=plan)
        equal = bool(torch.equal(a.state, b.state)) and all(
            bool(torch.equal(m["loss"], n["loss"]))
            for m, n in zip(a.history, b.history, strict=True))
        engines.append({"plan": plan.describe(), "bit_equal": equal})
        require(equal, f"{plan.describe()}: python != scan")
    timed = {name: plan for name, (plan, _) in plans.items()
             if not name.startswith("int8 no EF")}
    rates = rates_in_turns(program, timed, steps, KM_RATE_FITS)
    for s in runs:
        name = s["run"].split(", ", 1)[1]
        if name in rates:
            s["steps_per_s"] = rates[name]
    prof_plan = plans["int8 EF, cadence 1"][0]
    program.fit(steps=5, merge_plan=prof_plan)
    emit("profile", workload="logreg int8 EF, cadence 1", **profile_call(
        lambda: program.fit(steps=5, merge_plan=prof_plan), dev, steps=5))
    del X, y, program

    X, _, _ = datasets.blobs(gen, args.rows, args.km_features,
                             args.km_clusters)
    km, iters = KMeans(k=args.km_clusters, precision="int16"), args.km_iters
    _, ref_s = km_run("kmeans int16, default, cadence 1", km, grid, X, iters,
                      check)
    _, s = km_run("kmeans int16, overlap + int8 EF, cadence 1", km, grid, X,
                  iters, check, launches=iters + 1, merge_plan=MergePlan(
                      overlap=True, compression=int8))
    require(s["sse_last"] <= KM_WIRE_SSE * ref_s["sse_last"] + 1e-3,
            f"{s['run']}: last SSE {s['sse_last']} above {KM_WIRE_SSE} x "
            f"the default's {ref_s['sse_last']} + 1e-3")
    del X
    emit("train_wire", card=card, lanes=args.lanes, rows=args.rows,
         features=d, steps=steps, runs=runs, split_fits=split,
         engines=engines, kmeans=[ref_s, s],
         seconds=time.perf_counter() - t0)


def trace_local_steps(trace: dict) -> int:
    """Local steps a controlled fit ran, from its decisions: each
    dispatch's rounds times its cadence, and for an overlap dispatch one
    more phase (its prologue) of cadence steps."""
    return sum(d["rounds_in_dispatch"] * d["cadence"]
               + d["cadence"] * d["overlap"] for d in trace["decisions"])


def prior_against_measured(trace: dict, name: str) -> dict:
    """Per candidate, the prior's us/step (the H100 roofline of the
    counted round) against the best measured one, and their ratio; fails
    unless every non-warmup decision measured at least its prior (a
    roofline is a lower bound, so a prior above a measured time means the
    count is wrong)."""
    for d in trace["decisions"]:
        if not d["warmup"] and d["predicted_us_per_step"] is not None:
            require(d["us_per_step"] >= d["predicted_us_per_step"],
                    f"{name}: round {d['round']} ({d['compression']}, "
                    f"cadence {d['cadence']}) measured {d['us_per_step']} "
                    f"us/step, below its prior "
                    f"{d['predicted_us_per_step']}")
    prior, measured = trace["prior_us_per_step"], \
        trace["measured_us_per_step"]
    return {tag: {"prior_us_per_step": prior.get(tag),
                  "measured_us_per_step": measured.get(tag),
                  "prior_over_measured":
                      prior[tag] / measured[tag]
                      if tag in prior and tag in measured else None}
            for tag in trace["choices"]}


def controlled_run(name, wl, grid, X, y, steps, plan, check,
                   counted_round: bool) -> tuple:
    """A controlled fit through :func:`counted_fit`: its launches against
    what its trace implies (2 ``fxp_matmul`` and 1 ``lut_activation`` a
    local step, and one more local step when the cost model counts its
    round), its accuracy, and its decisions.  Returns (result, summary,
    merge_state)."""
    holder: dict = {}
    res, seen, stats = counted_fit(wl, grid, X, y, steps, merge_plan=plan,
                                   merge_state=holder)
    trace = holder["tuning_trace"]
    local = trace_local_steps(trace) + int(counted_round)
    expect = expected(fxp_matmul=FXP_STEP * local, lut_activation=local)
    require(len(res.history) == steps, f"{name}: {len(res.history)} "
            "history entries")
    require(trace["decisions"][-1]["steps_done"] == steps,
            f"{name}: the last decision is not at step {steps}")
    if check:
        require(seen == expect, f"{name}: launches {seen}, the trace "
                f"implies {expect}")
    summary = {"run": name, "steps": steps, "launches": seen,
               "expected_launches": expect, "local_steps": local, **stats,
               "accuracy": accuracy(res.state, X, y),
               "chosen": trace["chosen"],
               "cadence_trace": holder["cadence_trace"],
               "decisions": [{k: d[k] for k in (
                   "cadence", "rounds_in_dispatch", "compression",
                   "warmup", "us_per_step", "predicted_us_per_step")}
                   for d in trace["decisions"]]}
    return res, summary, holder


def train_auto(args, dev, card: str) -> None:
    """The main path under the plan controller at its full size: (a)
    ``merge_plan="auto"`` for 48 steps, which trusts the prior and keeps
    the exact wire; (b) ``AutoTune()`` for its ``min_steps_to_explore``
    steps, which probes every candidate and exploits the measured winner;
    (c) ``AdaptiveCadence(k_max=8)`` for 48 steps, whose cadence trace
    replays through a fresh controller; each with its launches as its
    trace implies (the counted round adds one local step the first time
    a program's functions meet the cost model), its accuracy against the
    default plan's fit of as many steps, and every measured round at or
    above its prior; (d) steps/s of (a) and (c) in turns with the default
    plan at cadence 1 and 8, and a second auto fit of one program, which
    counts no round."""
    grid = make_grid(args.lanes, device=dev)
    check = not args.rehearse
    steps, k = PLAN_STEPS, args.cadence
    explore_steps = AutoTune().min_steps_to_explore
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 100)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    runs, base = [], {}
    for n in (steps, explore_steps):
        res, s = fit_run(f"logreg int8 lut, default, cadence 1, {n} steps",
                         wl, grid, X, y, n,
                         expected(fxp_matmul=FXP_STEP * n,
                                  lut_activation=n), check)
        s["accuracy"] = base[n] = accuracy(res.state, X, y)
        runs.append(s)

    def near_default(s, n):
        require(abs(s["accuracy"] - base[n]) <= PLAN_ACC_TOL,
                f"{s['run']}: accuracy {s['accuracy']} not within "
                f"{PLAN_ACC_TOL} of the default plan's {base[n]}")

    # (a) the short auto fit: no exploration, the exact wire throughout
    _, s, holder = controlled_run("logreg int8 lut, auto", wl, grid, X, y,
                                  steps, "auto", check, True)
    trace = holder["tuning_trace"]
    require(trace["chosen"]["compression"] == "exact"
            and all(d["compression"] == "exact"
                    for d in trace["decisions"]),
            f"{s['run']}: left the exact wire: {trace['chosen']}")
    s["prior"] = prior_against_measured(trace, s["run"])
    near_default(s, steps)
    runs.append(s)

    # (b) the exploring fit: every candidate probed, then the winner
    _, s, holder = controlled_run("logreg int8 lut, AutoTune()", wl, grid,
                                  X, y, explore_steps,
                                  MergePlan(outer=AutoTune()), check, True)
    trace = holder["tuning_trace"]
    require(set(trace["measured_us_per_step"]) == set(trace["choices"]),
            f"{s['run']}: measured {sorted(trace['measured_us_per_step'])}"
            f" of {trace['choices']}")
    s["prior"] = prior_against_measured(trace, s["run"])
    s["cost_table_rows"] = len(trace["cost_table"])
    near_default(s, explore_steps)
    runs.append(s)

    # (c) the cadence controller, replayed offline
    plan_c = MergePlan(outer=AdaptiveCadence(k_max=AUTO_ADAPTIVE_K_MAX))
    _, s, holder = controlled_run(
        f"logreg int8 lut, AdaptiveCadence(k_max={AUTO_ADAPTIVE_K_MAX})",
        wl, grid, X, y, steps, plan_c, check, False)
    cadences = holder["cadence_trace"]
    preset = plan_c.outer
    replay = PlanController(k0=1, k_max=preset.k_max, growth=preset.growth,
                            stable_ratio=preset.stable_ratio,
                            patience=preset.patience)
    for d in holder["tuning_trace"]["decisions"]:
        replay.observe(d["delta_norm"])
    require(all(b >= a for a, b in zip(cadences, cadences[1:])),
            f"{s['run']}: cadence trace {cadences} falls")
    require(replay.cadence_trace == cadences,
            f"{s['run']}: replay {replay.cadence_trace} != {cadences}")
    require(holder["tuning_trace"]["choices"] == ["exact"],
            f"{s['run']}: choices {holder['tuning_trace']['choices']}")
    near_default(s, steps)
    runs.append(s)

    # (d) steps/s in turns, then a second auto fit of one program
    program = wl.bind(grid, X, y)
    timed = {"default, cadence 1": MergePlan(),
             f"default, cadence {k}": MergePlan(cadence=k), "auto": "auto",
             f"AdaptiveCadence(k_max={AUTO_ADAPTIVE_K_MAX})": plan_c}
    rates = rates_in_turns(program, timed, steps, KM_RATE_FITS)
    sync(dev)
    reset_counts()
    again = program.fit(steps=steps, merge_plan="auto")
    sync(dev)
    cached = {"launches": counts(), "expected_launches": expected(
        fxp_matmul=FXP_STEP * steps, lut_activation=steps),
        "history": len(again.history)}
    if check:
        require(cached["launches"] == cached["expected_launches"],
                f"a second auto fit of one program: launches "
                f"{cached['launches']}, expected "
                f"{cached['expected_launches']} (no counted round)")
    del X, y, program
    emit("train_auto", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, steps=steps, explore_steps=explore_steps,
         runs=runs, steps_per_s=rates, cached_second_fit=cached,
         seconds=time.perf_counter() - t0)


# -- phase 11: the mesh ------------------------------------------------------


def mesh_cells(args) -> dict:
    """The main path's cells on a mesh: name -> (steps, merge plan)."""
    k = args.cadence
    return {"default, cadence 1": (args.steps, MergePlan()),
            f"default, cadence {k}": (args.cadence_steps,
                                      MergePlan(cadence=k)),
            "int8 EF, cadence 1": (args.steps, MergePlan(
                compression=CompressionConfig(bits=8))),
            "auto": (PLAN_STEPS, "auto")}


def in_turns(programs: dict, steps: int, fits: int, **kw) -> dict:
    """Steps/s of each bound program's fit (``kw``: its plan), in turns
    (as :func:`rates_in_turns` takes plans)."""
    dev = next(iter(programs.values())).grid.device
    for program in programs.values():
        program.fit(steps=steps, **kw)
    sync(dev)
    rates: dict = {name: [] for name in programs}
    order = list(programs)
    for i in range(fits):
        for name in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            programs[name].fit(steps=steps, **kw)
            sync(dev)
            rates[name].append(steps / (time.perf_counter() - t0))
    return {name: {"median": statistics.median(r), "min": min(r),
                   "max": max(r), "fits": fits}
            for name, r in rates.items()}


def host_trace(programs: dict, args, dev) -> dict:
    """Where the (1, 1) mesh's host time goes: one cadence-k fit of each
    grid traced in turns (m g g m), each op's host self time summed over
    a grid's two traces; the traced walls, each grid's device idle share
    and the ops whose totals differ most between the grids (mesh minus
    make_grid, ms)."""
    fit = {name: (lambda p=p: p.fit(steps=args.cadence_steps,
                                    merge_every=args.cadence))
           for name, p in programs.items()}
    first, second = list(programs)
    traces: dict = {name: [] for name in programs}
    for name in (first, second, second, first):
        traces[name].append(profile_call(fit[name], dev, host_ops=8))
    totals = {name: {} for name in programs}
    for name, ts in traces.items():
        for t in ts:
            for op, ms in t["host_ms"].items():
                totals[name][op] = totals[name].get(op, 0.0) + ms
    ops = set(totals[first]) | set(totals[second])
    diff = sorted(((op, totals[first].get(op, 0.0)
                    - totals[second].get(op, 0.0)) for op in ops),
                  key=lambda d: -abs(d[1]))
    return {"steps": args.cadence_steps, "cadence": args.cadence,
            "traced_wall_ms": {n: [t["traced_wall_ms"] for t in ts]
                               for n, ts in traces.items()},
            "idle_share": {n: [t.get("idle_share") for t in ts]
                           for n, ts in traces.items()},
            "host_ms_total": {n: sum(v.values())
                              for n, v in totals.items()},
            "top_host_ops": {n: ts[0]["top_host_ops"]
                             for n, ts in traces.items()},
            "largest_differences_ms": [{"op": op, "ms": d}
                                       for op, d in diff[:10]]}


def mesh_hop_one(args, dev, store_dir: str) -> tuple:
    """(a) A world of one process (NCCL on the card, gloo on the CPU) and
    ``make_mesh_grid(lanes)``, a (1, 1) mesh: the main path's cells on
    it and on ``make_grid`` must be bit-equal (every all-reduce has one
    participant, the compressed hop is ``ef_quantize``), with the same
    launches; steps/s in turns; a profile of 5 steps with the
    collectives' device time.  Returns (summary, make_grid's states by
    cell)."""
    init_world("nccl" if dev.type == "cuda" else "gloo",
               dist.FileStore(os.path.join(store_dir, "world1"), 1))
    try:
        mesh_grid = make_mesh_grid(args.lanes, device=dev)
        grid = make_grid(args.lanes, device=dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 200)
        X, y, _ = datasets.binary_classification(gen, args.rows,
                                                 args.features)
        wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
        check = not args.rehearse
        runs, refs = [], {}
        for name, (steps, plan) in mesh_cells(args).items():
            counted = 1 if plan == "auto" else 0   # the cost model's round
            want = expected(fxp_matmul=FXP_STEP * (steps + counted),
                            lut_activation=steps + counted)
            fits = {}
            for g_name, g in (("mesh", mesh_grid), ("grid", grid)):
                fits[g_name] = counted_fit(wl, g, X, y, steps,
                                           merge_plan=plan)
            (m, m_seen, m_stats), (r, r_seen, _) = fits["mesh"], fits["grid"]
            equal = bool(torch.equal(m.state, r.state)) and all(
                bool(torch.equal(a["loss"], b["loss"]))
                for a, b in zip(m.history, r.history))
            s = {"run": f"logreg int8 lut, {name}, (1, 1) mesh",
                 "steps": steps, "launches": m_seen,
                 "grid_launches": r_seen, "expected_launches": want,
                 **m_stats, "bit_equal_to_make_grid": equal,
                 "accuracy": accuracy(m.state, X, y)}
            require(equal, f"{s['run']}: not bit-equal to make_grid's fit")
            # make_grid's fit replays its captured chunks
            r_want = fit_expect(want, steps, grid, merge_plan=plan)
            s["grid_expected_launches"] = r_want
            if check:
                require(m_seen == want and r_seen == r_want,
                        f"{s['run']}: launches {m_seen} (make_grid "
                        f"{r_seen}), the design implies {want} "
                        f"({r_want})")
            runs.append(s)
            refs[name] = r.state
        # make_grid's fit under (b)'s dead pod (train_faults (d))
        with faults.armed(mesh_fault_plan(MESH_RANKS),
                          recovery=FAULT_POLICY):
            refs["dead pod"] = api.fit(wl, grid, X, y,
                                       steps=args.cadence_steps,
                                       merge_every=args.cadence).state
        programs = {"(1, 1) mesh": wl.bind(mesh_grid, X, y),
                    "make_grid": wl.bind(grid, X, y)}
        rates = {"cadence 1": in_turns(programs, args.steps, KM_RATE_FITS),
                 f"cadence {args.cadence}": in_turns(
                     programs, args.cadence_steps, KM_RATE_FITS,
                     merge_every=args.cadence)}
        prof = profile_call(lambda: programs["(1, 1) mesh"].fit(steps=5),
                            dev, match="nccl", steps=5)
        summary = {"backend": dist.get_backend(), "world": 1,
                   "mesh": list(mesh_grid.mesh.shape), "runs": runs,
                   "steps_per_s": rates, "profile": prof,
                   "host_trace": host_trace(programs, args, dev)}
        return summary, refs
    finally:
        dist.destroy_process_group()


def mesh_rank(rank: int, world: int, store: str, out_dir: str,
              opts: dict) -> None:
    """(b) One rank of the hop-2 world: the same data from the seed on
    every rank, 128 of the 256 lanes kept, the main path's cells, K-means
    and the tree; results to ``out_dir/rank<r>.pkl``."""
    dev = torch.device(opts["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_world("gloo", dist.FileStore(store, world), rank=rank,
               world_size=world)
    try:
        grid = make_mesh_grid(opts["lanes"], mesh=make_pim_mesh(
            world, 1, device_type="cpu"), device=dev)
        gen = torch.Generator(device=dev).manual_seed(opts["seed"] + 200)
        X, y, _ = datasets.binary_classification(gen, opts["rows"],
                                                 opts["features"])
        program = LogReg(lr=0.5, precision="int8",
                         sigmoid="lut").bind(grid, X, y)
        k = opts["cadence"]
        cells = {
            "exact, cadence 1": (opts["steps"], MergePlan(), None),
            f"exact, cadence {k}": (opts["cadence_steps"],
                                    MergePlan(cadence=k), None),
            "int8 EF, cadence 1": (opts["steps"], MergePlan(
                compression=CompressionConfig(bits=8)),
                CompressionConfig(bits=8)),
            f"int8 EF, cadence {k}": (opts["cadence_steps"], MergePlan(
                cadence=k, compression=CompressionConfig(bits=8)),
                CompressionConfig(bits=8)),
            f"top-k {WIRE_TOP_K}, cadence {k}": (
                opts["cadence_steps"], MergePlan(
                    cadence=k, compression=CompressionConfig(
                        bits=8, top_k_frac=WIRE_TOP_K)),
                CompressionConfig(bits=8, top_k_frac=WIRE_TOP_K))}
        # the host clock's seconds are kept apart: the rest must be
        # bit-equal across the ranks
        out = {"pod": grid.axis_index("pod"), "lanes": grid.n_local,
               "rows_held": int(program.data["X"].shape[0]
                                * program.data["X"].shape[1]),
               "cells": {}, "seconds": {}}
        for name, (steps, plan, cfg) in cells.items():
            program.fit(steps=steps, merge_plan=plan)      # warm
            holder: dict = {}
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            res = program.fit(steps=steps, merge_plan=plan,
                              merge_state=holder)
            sync(dev)
            seconds = time.perf_counter() - t0
            out["seconds"][name] = seconds
            cell = {"steps": steps, "launches": counts(),
                    "state": res.state.cpu().numpy(),
                    "losses": [float(m["loss"]) for m in res.history],
                    "accuracy": accuracy(res.state, X, y)}
            if cfg is not None:
                cell["wire"] = wire_summary(holder, cfg)
                cell["error_shapes"] = [list(e.shape) for e in
                                        tree_leaves(holder["error"])]
            out["cells"][name] = cell
        # train_faults (d): a dead pod on the real hop, where the pod
        # holds its EF residual
        out["faults"] = {}
        for name, cfg in (("exact", None),
                          ("int8 EF", CompressionConfig(bits=8))):
            holder = {}
            sync(dev)
            reset_counts()
            with faults.armed(mesh_fault_plan(world),
                              recovery=FAULT_POLICY):
                res = program.fit(steps=opts["cadence_steps"],
                                  merge_plan=MergePlan(cadence=k,
                                                       compression=cfg),
                                  merge_state=holder)
            sync(dev)
            rep = holder["resilience_report"]
            out["faults"][name] = {
                "launches": counts(), "state": res.state.cpu().numpy(),
                "losses": [float(m["loss"]) for m in res.history],
                "survivors": rep["survivors"], "restarts": rep["restarts"],
                "accuracy": accuracy(res.state, X, y)}
        # where a hop-2 step's time goes: 5 warm cadence-1 steps, traced
        # on rank 0 (rank 1 runs them alongside, untraced)
        if rank == 0:
            out["profile"] = profile_call(lambda: program.fit(steps=5), dev,
                                          steps=5)
        else:
            program.fit(steps=5)
        del X, y, program

        gen = torch.Generator(device=dev).manual_seed(opts["seed"] + 210)
        X, _, _ = datasets.blobs(gen, opts["rows"], opts["km_features"],
                                 opts["km_clusters"])
        wl = KMeans(k=opts["km_clusters"], precision="int16")
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = api.fit(wl, grid, X, steps=opts["km_iters"])
        sync(dev)
        out["seconds"]["kmeans"] = time.perf_counter() - t0
        out["kmeans"] = {"launches": counts(),
                         "state": res.state.cpu().numpy(),
                         "sse": res.eval(X)["sse"]}
        del X

        gen = torch.Generator(device=dev).manual_seed(opts["seed"] + 220)
        X, y = datasets.mixture_classification(
            gen, opts["rows"], opts["dt_features"], opts["dt_classes"])
        wl = DecisionTree(max_depth=opts["dt_depth"], n_bins=opts["dt_bins"],
                          n_classes=opts["dt_classes"])
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = api.fit(wl, grid, X, y, steps=wl.max_depth)
        sync(dev)
        out["seconds"]["dtree"] = time.perf_counter() - t0
        out["dtree"] = {"launches": counts(), "levels": len(res.history),
                        "reached": sum(1 for h in res.history
                                       if h["splits"] > 0),
                        "tree": {f: getattr(res.state, f).cpu().numpy()
                                 for f in ("feature", "threshold",
                                           "leaf_value", "bin_edges")},
                        "accuracy": res.eval(X, y)["accuracy"]}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, store: str, out_dir: str, opts: dict) -> list:
    """Spawn ``world`` processes of ``fn`` and join them within
    ``MESH_JOIN_S``; a rank that fails or hangs fails the run (its
    processes are killed).  Returns each rank's pickled results."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=(world, store, out_dir, opts),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.perf_counter() + MESH_JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline -
                                       time.perf_counter())):
            if time.perf_counter() >= deadline:
                raise SmokeFailure(f"the {world}-rank world did not end "
                                   f"within {MESH_JOIN_S} s")
    except tmp.spawn.ProcessException as e:
        raise SmokeFailure(f"a rank of the {world}-rank world failed: "
                           f"{e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def mesh_hop_two(args, dev, store_dir: str, refs: dict) -> dict:
    """(b) Two spawned ranks, pods=2 and data=1, both on the one card
    over gloo (NCCL takes one rank a device): the main path's exact,
    int8 EF and top-k cells, K-means and the tree.  The ranks' results
    must be bit-equal; exact cells within 1e-5 x max|w| of make_grid's
    fit (``refs``, from part (a)), compressed cells' accuracy within
    0.01 of the exact cell's, the tree equal to make_grid's and K-means'
    SSE at most 1.05 x make_grid's.  Also train_faults' (d): a dead pod
    at round 2 on the exact and int8 EF wires, 128 survivors, the ranks
    bit-equal, the exact cell within 1e-5 x max|w| of make_grid's fit
    under the same event (``refs["dead pod"]``)."""
    check = not args.rehearse
    # make_grid's K-means and tree, on the data the ranks will make
    grid = make_grid(args.lanes, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 210)
    X, _, _ = datasets.blobs(gen, args.rows, args.km_features,
                             args.km_clusters)
    km_ref = api.fit(KMeans(k=args.km_clusters, precision="int16"), grid, X,
                     steps=args.km_iters).eval(X)["sse"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 220)
    X, y = datasets.mixture_classification(gen, args.rows, args.dt_features,
                                           args.dt_classes)
    tree = api.fit(DecisionTree(max_depth=args.dt_depth, n_bins=args.dt_bins,
                                n_classes=args.dt_classes), grid, X, y,
                   steps=args.dt_depth).state
    tree_ref = {f: getattr(tree, f).cpu().numpy()
                for f in ("feature", "threshold", "leaf_value", "bin_edges")}
    del X, y, tree, grid
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    opts = {k: getattr(args, k) for k in (
        "lanes", "rows", "features", "steps", "cadence", "cadence_steps",
        "seed", "km_features", "km_clusters", "km_iters", "dt_features",
        "dt_classes", "dt_depth", "dt_bins")}
    opts["device"] = "cuda:0" if dev.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_RANKS,
                      os.path.join(store_dir, "world2"), store_dir, opts)
    world_s = time.perf_counter() - t0

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if hasattr(a, "tobytes"):
            return a.dtype == b.dtype and a.tobytes() == b.tobytes()
        return a == b or (a != a and b != b)

    for key in ("cells", "kmeans", "dtree", "faults"):
        require(same(ranks[0][key], ranks[1][key]),
                f"hop 2: rank 1's {key} differ from rank 0's")
    k = args.cadence
    cells = ranks[0]["cells"]
    summary = []
    for name, cell in cells.items():
        row = {"run": f"logreg int8 lut, {name}, (2, 1) mesh",
               "steps": cell["steps"], "launches": cell["launches"],
               "steps_per_s": [cell["steps"] / r["seconds"][name]
                               for r in ranks],
               "accuracy": cell["accuracy"],
               "loss_last": cell["losses"][-1]}
        want = expected(fxp_matmul=FXP_STEP * cell["steps"],
                        lut_activation=cell["steps"])
        if check:
            for r in ranks:
                require(r["cells"][name]["launches"] == want,
                        f"hop 2 {name}: launches "
                        f"{r['cells'][name]['launches']}, expected {want}")
        if name.startswith("exact"):
            ref_name = ("default, cadence 1" if name.endswith(" 1")
                        else f"default, cadence {k}")
            want_w = refs[ref_name].cpu().numpy()
            gap = float(abs(cell["state"] - want_w).max()
                        / abs(want_w).max())
            row["gap_to_make_grid"] = gap
            require(gap <= 1e-5, f"hop 2 {name}: {gap} x max|w| from "
                    f"make_grid's fit")
        else:
            exact = cells["exact, cadence 1" if name.endswith(" 1")
                          else f"exact, cadence {k}"]
            row["wire"] = cell["wire"]
            row["accuracy_gap"] = abs(cell["accuracy"] - exact["accuracy"])
            require(row["accuracy_gap"] <= PLAN_ACC_TOL,
                    f"hop 2 {name}: accuracy {cell['accuracy']} not within "
                    f"{PLAN_ACC_TOL} of exact {exact['accuracy']}")
        summary.append(row)
    fault_rows = []
    for name, cell in ranks[0]["faults"].items():
        row = {"run": f"dead pod 1 at round {FAULT_MESH_POD_ROUND}, {name}, "
                      f"cadence {k}, (2, 1) mesh",
               "launches": cell["launches"], "survivors": cell["survivors"],
               "restarts": cell["restarts"], "accuracy": cell["accuracy"],
               "loss_last": cell["losses"][-1]}
        require(cell["survivors"] == args.lanes // MESH_RANKS and
                cell["restarts"] == 0, f"hop 2 {row['run']}: "
                f"{cell['survivors']} survivors, {cell['restarts']} restarts")
        if check:
            want = expected(fxp_matmul=FXP_STEP * args.cadence_steps,
                            lut_activation=args.cadence_steps)
            for r in ranks:
                require(r["faults"][name]["launches"] == want,
                        f"hop 2 {row['run']}: launches "
                        f"{r['faults'][name]['launches']}, expected {want}")
        if name == "exact":
            want_w = refs["dead pod"].cpu().numpy()
            row["gap_to_make_grid"] = float(abs(cell["state"] - want_w).max()
                                            / abs(want_w).max())
            # held on the card; a rehearsal's 16 lanes of 1,024 rows read
            # 1.3e-5 (the summation order, carried by the int8 step's
            # requantization), where the card's exact cells of this world
            # read 1e-7 to 3e-6 (PERF.md)
            require(not check or row["gap_to_make_grid"] <= 1e-5,
                    f"hop 2 {row['run']}: {row['gap_to_make_grid']} x "
                    f"max|w| from make_grid's")
        fault_rows.append(row)
    km = ranks[0]["kmeans"]
    require(km["sse"] <= 1.05 * km_ref, f"hop 2 K-means SSE {km['sse']} "
            f"above 1.05 x make_grid's {km_ref}")
    dt = ranks[0]["dtree"]
    tree_equal = same(dt["tree"], tree_ref)
    require(tree_equal, "hop 2: the tree differs from make_grid's")
    if check:
        require(km["launches"] == expected(kmeans_assign=args.km_iters),
                f"hop 2 K-means launches {km['launches']}")
        require(dt["launches"] == expected(
            split_hist=dt["levels"] + (1 if dt["reached"] else 0)),
            f"hop 2 tree launches {dt['launches']}")
    return {"backend": "gloo", "world": MESH_RANKS, "mesh": [MESH_RANKS, 1],
            "device": opts["device"], "lanes_a_rank": ranks[0]["lanes"],
            "rows_a_rank": ranks[0]["rows_held"], "runs": summary,
            "faults_dead_pod": fault_rows,
            "kmeans": {"sse": km["sse"], "make_grid_sse": km_ref,
                       "launches": km["launches"],
                       "seconds": [r["seconds"]["kmeans"] for r in ranks]},
            "dtree": {"equal_to_make_grid": tree_equal,
                      "accuracy": dt["accuracy"], "launches": dt["launches"],
                      "seconds": [r["seconds"]["dtree"] for r in ranks]},
            "ranks_bit_equal": True, "profile_rank0": ranks[0]["profile"],
            "world_seconds": world_s}


def train_mesh(args, dev, card: str) -> None:
    """The main path on a mesh (``make_mesh_grid``): (a) a world of one
    rank over NCCL, bit-equal to ``make_grid``; (b) two ranks on the one
    card over gloo at hop 2."""
    t0 = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    a, refs = mesh_hop_one(args, dev, store_dir)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    b = mesh_hop_two(args, dev, store_dir, refs)
    emit("train_mesh", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, hop_one=a, hop_two=b,
         seconds=time.perf_counter() - t0)


# -- phase 12: checkpoint and restart -----------------------------------------


def ckpt_program(args, dev):
    """The main path bound for ``train_ckpt``: ``LogReg(int8, LUT)`` on
    the phase's data, made from ``--seed`` on ``dev`` (the killed child
    makes the same)."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 300)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    program = LogReg(lr=0.5, precision="int8", sigmoid="lut").bind(
        make_grid(args.lanes, device=dev), X, y)
    return program, X, y


def seeded_holder(program) -> dict:
    """A merge-state holder seeded by a prior ``PimGrid.fit`` segment
    under int8 EF and SlowMo at cadence 2 (``for_program`` refuses such
    plans, so the buffers ride its checkpoints as cargo)."""
    ms: dict = {}
    program.grid.fit(init_state=program.state0, local_fn=program.local_fn,
                     update_fn=program.update_fn, data=program.data,
                     steps=KILL_SEGMENT_STEPS, merge_state=ms,
                     merge_plan=MergePlan(
                         cadence=2, compression=CompressionConfig(bits=8),
                         outer=SlowMo()))
    ms["tuning_trace"] = {"note": ["segment-done"]}
    return ms


def kill_config(args, ckpt_dir: str) -> TrainerConfig:
    return TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=KILL_EVERY,
                         log_every=KILL_EVERY, merge_every=args.cadence,
                         batch_size=args.rows // args.lanes // MB_FRACTION)


def ckpt_child(args, dev, ckpt_dir: str) -> int:
    """(c)'s victim, in its own process: the run of :func:`kill_config`,
    SIGKILLed inside its ``KILL_DISPATCH``-th round, after the round has
    computed and before the trainer records or checkpoints it."""
    import signal

    program, X, y = ckpt_program(args, dev)
    del X, y
    tr = Trainer.for_program(program, kill_config(args, ckpt_dir),
                             merge_state=seeded_holder(program))
    orig = tr.step_fn
    calls = {"n": 0}

    def sabotaged(state, batch):
        out = orig(state, batch)
        calls["n"] += 1
        if calls["n"] == KILL_DISPATCH:
            sync(dev)
            tr.ckpt.wait()      # the last save lands: the crash tests resume
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    tr.step_fn = sabotaged
    tr.run(KILL_STEPS)
    print("chip_smoke: the killed run finished", file=sys.stderr)
    return 1


def counted_trainer(program, cfg, steps, wrap=None) -> tuple:
    """``Trainer.for_program(program, cfg).run(steps)`` (``wrap`` takes
    and returns the step function) with the counters set to 0 just
    before and read just after: (trainer, result, launches, seconds)."""
    dev = program.grid.device
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    tr = Trainer.for_program(program, cfg)
    if wrap is not None:
        tr.step_fn = wrap(tr.step_fn)
    out = tr.run(steps)
    sync(dev)
    return tr, out, counts(), time.perf_counter() - t0


def same_history(out, history) -> bool:
    """A trainer's history against ``Program.fit``'s, step for step."""
    return [e["step"] for e in out["history"]] == list(
        map(float, range(len(history)))) and [
        e["loss"] for e in out["history"]] == [float(m["loss"])
                                               for m in history]


def trainer_against_fit(args, program, X, y, base: str,
                        check: bool) -> tuple:
    """(a): the trainer at cadence 1 and the config's against
    ``Program.fit`` of as many steps, bit for bit, with the same launches
    and every checkpoint on a merge boundary.  Returns (runs, cadence-1
    fit result)."""
    runs, ref = [], None
    k = args.cadence
    for name, steps, cad, every in (
            ("cadence 1", args.steps, 1, CKPT_EVERY),
            (f"cadence {k}", args.cadence_steps, k, CKPT_EVERY_K)):
        want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
        sync(program.grid.device)
        reset_counts()
        res = program.fit(steps=steps, merge_every=cad)
        sync(program.grid.device)
        fit_seen = counts()
        cfg = TrainerConfig(ckpt_dir=tempfile.mkdtemp(dir=base),
                            ckpt_every=every, log_every=CKPT_LOG_EVERY,
                            merge_every=cad, ckpt_keep=1000)
        tr, out, seen, seconds = counted_trainer(program, cfg, steps)
        saved = tr.ckpt.steps()
        s = {"run": f"Trainer.for_program, {name}", "steps": steps,
             "ckpt_every": every, "launches": seen,
             "fit_launches": fit_seen, "expected_launches": want,
             "seconds": seconds, "restarts": out["restarts"],
             "checkpoints": saved,
             "bit_equal_to_fit": bool(torch.equal(tr.state, res.state))
             and same_history(out, res.history),
             "accuracy": accuracy(tr.state, X, y)}
        require(s["bit_equal_to_fit"], f"{s['run']}: not bit-equal to "
                f"Program.fit({steps}) at cadence {cad}")
        require(out["restarts"] == 0, f"{s['run']}: {out['restarts']} "
                "restarts")
        require(saved and all((t + 1) % cad == 0 for t in saved),
                f"{s['run']}: checkpoints {saved} off the merge boundaries")
        # Program.fit captures its chunks; the trainer runs eagerly
        fit_want = fit_expect(want, steps, program.grid, merge_every=cad)
        s["fit_expected_launches"] = fit_want
        if check:
            require(seen == want and fit_seen == fit_want, f"{s['run']}: "
                    f"launches {seen} (fit {fit_seen}), the design "
                    f"implies {want} ({fit_want})")
        runs.append(s)
        if cad == 1:
            ref = res
    return runs, ref


def restore_and_replay(args, program, ref, base: str, check: bool) -> list:
    """(b): the cadence-1 trainer whose step returns a NaN loss once, at
    step ``CKPT_NAN_STEP``: one restore of the step-20 checkpoint, the
    replay, and the end bit-equal to (a); in line, with the background
    sink and under a RecoveryPolicy."""
    steps = args.steps
    first = CKPT_NAN_STEP // CKPT_LOG_EVERY * CKPT_LOG_EVERY
    replayed = (first + CKPT_LOG_EVERY) - CKPT_NAN_RESTORES
    want = expected(fxp_matmul=FXP_STEP * (steps + replayed),
                    lut_activation=steps + replayed)
    runs = []
    for name, extra in (("in line", {}),
                        ("async_metrics", {"async_metrics": True}),
                        ("RecoveryPolicy(backoff_base_s=0.0)",
                         {"recovery": RecoveryPolicy(backoff_base_s=0.0)})):
        def wrap(fn):
            calls = {"n": 0}

            def nan_once(state, batch):
                state, metrics = fn(state, batch)
                calls["n"] += 1
                if calls["n"] == CKPT_NAN_STEP + 1:
                    metrics = dict(metrics, loss=torch.full_like(
                        metrics["loss"], float("nan")))
                return state, metrics
            return nan_once

        cfg = TrainerConfig(ckpt_dir=tempfile.mkdtemp(dir=base),
                            ckpt_every=CKPT_EVERY, log_every=CKPT_LOG_EVERY,
                            **extra)
        tr, out, seen, seconds = counted_trainer(program, cfg, steps, wrap)
        steps_seen = [int(e["step"]) for e in out["history"]]
        s = {"run": f"NaN at step {CKPT_NAN_STEP}, {name}",
             "restarts": out["restarts"], "launches": seen,
             "expected_launches": want, "seconds": seconds,
             "history_entries": len(out["history"]),
             "history_in_order": steps_seen == list(range(steps)),
             "bit_equal_to_a": bool(torch.equal(tr.state, ref.state))
             and same_history(out, ref.history),
             "recovery_trace": [{k: v for k, v in e.items()
                                 if k != "latency_s"}
                                for e in out["recovery_trace"]]}
        require(out["restarts"] == 1, f"{s['run']}: {out['restarts']} "
                "restarts, want 1")
        require(s["history_in_order"], f"{s['run']}: history steps "
                f"{steps_seen}")
        require(s["bit_equal_to_a"], f"{s['run']}: not bit-equal to (a)")
        if "recovery" in extra:
            ev = out["recovery_trace"]
            require(len(ev) == 1 and ev[0]["action"] == "rollback"
                    and ev[0]["to_step"] == CKPT_NAN_RESTORES,
                    f"{s['run']}: recovery trace {ev}")
        if check:
            require(seen == want, f"{s['run']}: launches {seen}, the "
                    f"replay implies {want}")
        runs.append(s)
    return runs


def kill_and_resume(args, program, base: str, check: bool) -> dict:
    """(c): a child process runs :func:`kill_config` and is SIGKILLed in
    its third round; this process resumes from its checkpoints with a
    holder of zeros and must end bit-equal to an uninterrupted run:
    state, sampler counter, EF buffer, momentum and history."""
    import signal

    ckpt_dir = tempfile.mkdtemp(dir=base)
    cmd = [sys.executable, os.path.abspath(__file__), "--seed",
           str(args.seed), "--ckpt-child", ckpt_dir]
    if args.rehearse:
        cmd.append("--rehearse")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=KILL_JOIN_S)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"the killed child did not end within "
                           f"{KILL_JOIN_S} s") from e
    child_s = time.perf_counter() - t0
    require(proc.returncode == -signal.SIGKILL, f"the child ended with "
            f"{proc.returncode}, not SIGKILL: {proc.stderr[-2000:]}")
    on_disk = CheckpointManager(ckpt_dir).steps()

    ms_oracle = seeded_holder(program)
    oracle = Trainer.for_program(program, kill_config(
        args, tempfile.mkdtemp(dir=base)), merge_state=ms_oracle)
    out_oracle = oracle.run(KILL_STEPS)

    ms = {key: tree_map(torch.zeros_like, ms_oracle[key])
          for key in ("error", "momentum")}
    sync(program.grid.device)
    reset_counts()
    t0 = time.perf_counter()
    tr = Trainer.for_program(program, kill_config(args, ckpt_dir),
                             merge_state=ms)
    start = tr.start_step
    out = tr.run(KILL_STEPS - start)
    sync(program.grid.device)
    seen, resume_s = counts(), time.perf_counter() - t0
    n = KILL_STEPS - start
    want = expected(fxp_matmul=FXP_STEP * n, lut_activation=n)
    names = {key: tree_flatten_with_names(ms[key])[0]
             for key in ("error", "momentum")}
    buffers = all(
        len(tree_leaves(ms[key])) == len(tree_leaves(ms_oracle[key])) > 0
        and all(bool(torch.equal(a, b)) for a, b in zip(
            tree_leaves(ms[key]), tree_leaves(ms_oracle[key])))
        for key in ("error", "momentum"))
    tail = out_oracle["history"][start:]
    s = {"child_seconds": child_s, "child_exit": proc.returncode,
         "checkpoints_left": on_disk, "resumed_at": start,
         "resumed_launches": seen, "expected_launches": want,
         "resume_seconds": resume_s, "buffer_leaves": names,
         "state_bit_equal": bool(torch.equal(tr.state[0],
                                             oracle.state[0])),
         "counter": [float(tr.state[1]), float(oracle.state[1])],
         "buffers_bit_equal": buffers,
         "tuning_trace_restored": ms.get("tuning_trace") == {
             "note": ["segment-done"]},
         "history_bit_equal": [e["step"] for e in out["history"]]
         == [e["step"] for e in tail] and [e["loss"] for e in
                                           out["history"]]
         == [e["loss"] for e in tail]}
    last = KILL_DISPATCH * args.cadence
    require(on_disk and on_disk[-1] < last, f"the child left checkpoints "
            f"{on_disk}, past its kill at step {last}")
    require(start == on_disk[-1] + 1, f"resumed at {start}, the newest "
            f"checkpoint is {on_disk[-1]}")
    for key in ("state_bit_equal", "buffers_bit_equal",
                "tuning_trace_restored", "history_bit_equal"):
        require(s[key], f"kill and resume: {key} is false")
    require(s["counter"] == [float(KILL_STEPS)] * 2, f"kill and resume: "
            f"sampler counters {s['counter']}")
    if check:
        require(seen == want, f"kill and resume: launches {seen}, the "
                f"resumed steps imply {want}")
    return s


def trainer_rates(args, program, base: str) -> dict:
    """(d): steps/s of ``Program.fit`` and of the trainer (with the
    background sink, without a checkpoint directory, with in-line
    saves), the median of ``KM_RATE_FITS`` runs each, taken in turns
    (each trainer a fresh directory, built in the timed region, as a
    user calls it); then where one trainer run's time goes."""
    dev = program.grid.device
    out = {}
    for name, steps, cad, every in (
            ("cadence 1", args.steps, 1, CKPT_EVERY),
            (f"cadence {args.cadence}", args.cadence_steps, args.cadence,
             CKPT_EVERY_K)):
        def trainer(ckpt=True, in_line=False, **kw):
            def run():
                cfg = TrainerConfig(ckpt_dir=next(dirs) if ckpt else None,
                                    ckpt_every=every,
                                    log_every=CKPT_LOG_EVERY,
                                    merge_every=cad, **kw)
                tr = Trainer.for_program(program, cfg)
                if in_line:
                    tr.ckpt.async_save = False
                tr.run(steps)
            return run

        contenders = {"Program.fit": lambda: program.fit(
            steps=steps, merge_every=cad),
            "Trainer": trainer(),
            "Trainer, async_metrics": trainer(async_metrics=True),
            "Trainer, no checkpoints": trainer(ckpt=False),
            "Trainer, saves in line": trainer(in_line=True)}
        dirs = iter([tempfile.mkdtemp(dir=base)    # + the host trace's
                     for _ in range((KM_RATE_FITS + 1) * 3 + 1)])
        for fn in contenders.values():
            fn()
        sync(dev)
        rates: dict = {c: [] for c in contenders}
        order = list(contenders)
        for i in range(KM_RATE_FITS):
            for c in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                contenders[c]()
                sync(dev)
                rates[c].append(steps / (time.perf_counter() - t0))
        out[name] = {c: {"median": statistics.median(r), "min": min(r),
                         "max": max(r), "fits": KM_RATE_FITS}
                     for c, r in rates.items()}
        out[name]["breakdown"] = {
            c: trainer_breakdown(program, TrainerConfig(
                ckpt_dir=ckpt_dir, ckpt_every=every,
                log_every=CKPT_LOG_EVERY, merge_every=cad), steps)
            for c, ckpt_dir in (("Trainer", tempfile.mkdtemp(dir=base)),
                                ("Trainer, no checkpoints", None))}
        if cad == 1:
            out[name]["host_trace"] = {}
            for c in ("Program.fit", "Trainer"):
                trace = profile_call(contenders[c], dev, host_ops=10)
                trace["host_self_ms"] = sum(trace.pop("host_ms").values())
                out[name]["host_trace"][c] = trace
    return out


def trainer_breakdown(program, cfg, steps) -> dict:
    """Where one warm trainer run's time goes: inside its step (or round)
    calls, its flushes, ``CheckpointManager.save`` (which first waits
    for the previous write) and every ``wait`` (blocked on a background
    write: in a save and at the end); beside it, just before, a
    ``Program.fit`` of as many steps and the same step calls in a bare
    loop (one sync at the end)."""
    dev = program.grid.device
    k = cfg.merge_every
    sync(dev)
    t0 = time.perf_counter()
    program.fit(steps=steps, merge_every=k)
    sync(dev)
    fit_ms = (time.perf_counter() - t0) * 1e3
    fn, state = program.step_fn() if k == 1 else program.round_fn(k)
    t0 = time.perf_counter()
    for _ in range(steps // k):
        state, _ = fn(state, None)
    sync(dev)
    loop_ms = (time.perf_counter() - t0) * 1e3
    acc: dict = {}

    def timed(fn, key):
        acc[f"{key}_ms"], acc[f"{key}_calls"] = 0.0, 0

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[f"{key}_ms"] += (time.perf_counter() - t) * 1e3
                acc[f"{key}_calls"] += 1
        return run

    t0 = time.perf_counter()
    tr = Trainer.for_program(program, cfg)
    tr.step_fn = timed(tr.step_fn, "step")
    tr._flush = timed(tr._flush, "flush")
    if tr.ckpt is not None:
        tr.ckpt.wait = timed(tr.ckpt.wait, "wait")
        tr.ckpt.save = timed(tr.ckpt.save, "save")
    tr.run(steps)
    sync(dev)
    return {"run_ms": (time.perf_counter() - t0) * 1e3, "fit_ms": fit_ms,
            "loop_ms": loop_ms, **acc}


def save_cost(program, holder: dict, base: str) -> dict:
    """(d): one ``CheckpointManager.save``: the part before it returns
    (the host copy, one synchronising read on the card) and the
    background write (``wait``), the median of ``CKPT_SAVES`` saves, for
    the main path's state and for (c)'s v2 layout."""
    dev = program.grid.device
    trees = {"state (w)": program.state0,
             "v2 layout (c)": {"model": (program.state0,
                                         torch.zeros((), device=dev)),
                               "merge_error": holder["error"],
                               "merge_momentum": holder["momentum"]}}
    out = {}
    for name, tree in trees.items():
        mgr = CheckpointManager(tempfile.mkdtemp(dir=base))
        sync_ms, write_ms = [], []
        for i in range(CKPT_SAVES):
            sync(dev)
            t0 = time.perf_counter()
            mgr.save(i, tree, extra={"data_step": i})
            t1 = time.perf_counter()
            mgr.wait()
            sync_ms.append((t1 - t0) * 1e3)
            write_ms.append((time.perf_counter() - t1) * 1e3)
        out[name] = {"leaves": len(tree_leaves(tree)),
                     "bytes": nbytes(*tree_leaves(tree)),
                     "sync_ms": statistics.median(sync_ms),
                     "write_ms": statistics.median(write_ms),
                     "saves": CKPT_SAVES}
    return out


def train_ckpt(args, dev, card: str) -> None:
    """The main path through the fault-tolerant trainer: (a) against
    ``Program.fit``, (b) restore and replay, (c) kill and resume in a
    second process, (d) its cost."""
    import shutil

    check = not args.rehearse
    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        program, X, y = ckpt_program(args, dev)
        a, ref = trainer_against_fit(args, program, X, y, base, check)
        del X, y
        b = restore_and_replay(args, program, ref, base, check)
        c = kill_and_resume(args, program, base, check)
        d = {"steps_per_s": trainer_rates(args, program, base),
             "save": save_cost(program, seeded_holder(program), base)}
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("train_ckpt", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, trainer_against_fit=a,
         restore_and_replay=b, kill_and_resume=c, cost=d,
         seconds=time.perf_counter() - t0)


# -- phase 13: fault injection and the resilient fit --------------------------


def faults_program(args, dev):
    """The main path bound for ``train_faults``: ``LogReg(int8, LUT)`` on
    the phase's data, made once from ``--seed`` on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 400)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    program = LogReg(lr=0.5, precision="int8", sigmoid="lut").bind(
        make_grid(args.lanes, device=dev), X, y)
    return program, X, y


def armed_fit(program, steps: int, plan, fp=None, **arm) -> tuple:
    """``program.fit(steps, merge_plan=plan)``, under ``faults.armed(fp,
    **arm)`` unless ``fp`` is None, with the counters set to 0 just
    before and read just after: (result, the resilient report or None,
    launches, seconds)."""
    dev = program.grid.device
    holder: dict = {}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    if fp is None:
        res = program.fit(steps=steps, merge_plan=plan, merge_state=holder)
    else:
        with faults.armed(fp, **arm):
            res = program.fit(steps=steps, merge_plan=plan,
                              merge_state=holder)
    sync(dev)
    seconds = time.perf_counter() - t0
    require(faults.armed_context() is None, "a plan stayed armed")
    return res, holder.get("resilience_report"), counts(), seconds


def chunks(steps: int, k: int, scan_chunk: int = 32) -> int:
    """Dispatched chunks (host syncs) of an idle armed fit."""
    return -(-(steps // k) // scan_chunk) + (1 if steps % k else 0)


def armed_rates(program, steps: int, plan, fits: int) -> dict:
    """Steps/s of the unarmed fit and of the fit under an empty plan, in
    turns (u a a u ...), and the armed plan's overhead."""
    dev = program.grid.device

    def run(armed: bool) -> None:
        if armed:
            with faults.armed(FaultPlan()):
                program.fit(steps=steps, merge_plan=plan)
        else:
            program.fit(steps=steps, merge_plan=plan)

    run(False)
    run(True)
    sync(dev)
    rates: dict = {"unarmed": [], "armed idle": []}
    for i in range(fits):
        for name in (("unarmed", "armed idle") if i % 2 == 0
                     else ("armed idle", "unarmed")):
            t0 = time.perf_counter()
            run(name == "armed idle")
            sync(dev)
            rates[name].append(steps / (time.perf_counter() - t0))
    out = {name: {"median": statistics.median(r), "min": min(r),
                  "max": max(r), "fits": fits} for name, r in rates.items()}
    out["overhead_pct"] = (out["unarmed"]["median"]
                           / out["armed idle"]["median"] - 1.0) * 100.0
    return out


def faults_idle(args, program, X, y, check: bool) -> tuple:
    """(a) An empty plan against the unarmed fit at the config's cadence
    and at 1: launches, the state gap, accuracy, host syncs, steps/s in
    turns.  Returns (summary, the idle fit at the config's cadence)."""
    runs, idle = [], None
    k = args.cadence
    for cad, steps, bar in ((k, args.cadence_steps, FAULT_IDLE_TOL_K),
                            (1, args.steps, FAULT_IDLE_TOL_1)):
        plan = MergePlan(cadence=cad)
        want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
        base, _, base_seen, base_s = armed_fit(program, steps, plan)
        res, rep, seen, seconds = armed_fit(program, steps, plan,
                                            FaultPlan())
        w_max = float(base.state.abs().max())
        s = {"run": f"FaultPlan() armed, cadence {cad}", "steps": steps,
             "launches": seen, "unarmed_launches": base_seen,
             "expected_launches": want, "seconds": seconds,
             "unarmed_seconds": base_s,
             "gap_over_max_w": float((res.state - base.state).abs().max())
             / w_max,
             "bit_equal_to_unarmed": bool(torch.equal(res.state,
                                                      base.state)),
             "accuracy": accuracy(res.state, X, y),
             "unarmed_accuracy": accuracy(base.state, X, y),
             "host_syncs": rep["host_syncs"],
             "expected_host_syncs": chunks(steps, cad),
             "restarts": rep["restarts"]}
        losses = [float(m["loss"]) for m in res.history]
        require(len(losses) == steps and all(map(math.isfinite, losses)),
                f"{s['run']}: history of {len(losses)} entries")
        require(s["gap_over_max_w"] <= bar, f"{s['run']}: "
                f"{s['gap_over_max_w']} x max|w| from the unarmed fit")
        require(abs(s["accuracy"] - s["unarmed_accuracy"]) <= PLAN_ACC_TOL,
                f"{s['run']}: accuracy {s['accuracy']} against "
                f"{s['unarmed_accuracy']}")
        require(s["restarts"] == 0 and
                s["host_syncs"] == s["expected_host_syncs"],
                f"{s['run']}: {s['restarts']} restarts, "
                f"{s['host_syncs']} host syncs")
        # the unarmed fit captures its chunks; the armed one is eager
        base_want = fit_expect(want, steps, program.grid, merge_plan=plan)
        s["unarmed_expected_launches"] = base_want
        if check:
            require(seen == want and base_seen == base_want,
                    f"{s['run']}: launches {seen} (unarmed {base_seen}), "
                    f"the design implies {want} ({base_want})")
        s["steps_per_s"] = armed_rates(program, steps, plan,
                                       TIMING_RUNS)
        if cad == 1:
            # where the armed cadence-1 step's time goes: 5 warm steps of
            # each, traced (the armed round merges lane states, so its
            # update and merge run per lane)
            program.fit(steps=5, merge_plan=plan)
            s["profile"] = {
                "unarmed": profile_call(
                    lambda: program.fit(steps=5, merge_plan=plan),
                    program.grid.device, host_ops=6, steps=5),
                "armed idle": profile_call(
                    lambda: armed_fit(program, 5, plan, FaultPlan()),
                    program.grid.device, host_ops=6, steps=5)}
            for prof in s["profile"].values():
                prof.pop("host_ms", None)
        runs.append(s)
        if cad == k:
            idle = res
    return runs, idle


def fault_cells(lanes: int) -> dict:
    """(b)'s plans: kind -> (plan, survivors it leaves)."""
    return {
        "dead_lane": (FaultPlan(events=(
            FaultEvent(1, "dead_lane", lane=5),)), lanes - 1),
        "dead_pod": (FaultPlan(events=(
            FaultEvent(1, "dead_pod", pod=1),), pods=FAULT_PODS),
            lanes - lanes // FAULT_PODS),
        "nan_lane": (FaultPlan(events=(
            FaultEvent(3, "nan_lane", lane=2),)), lanes),
        "wire_bitflip": (FaultPlan(events=(
            FaultEvent(3, "wire_bitflip", leaf=0, index=2, bit=30),)),
            lanes),
        "timeout": (FaultPlan(events=(
            FaultEvent(3, "timeout", duration_s=0.002),)), lanes),
        # every save torn, then a divergence: the rollback quarantines
        # the torn step and falls back to the fit's start
        "torn_ckpt": (FaultPlan(events=tuple(
            FaultEvent(i, "torn_ckpt") for i in range(FAULT_TORN_SAVES))
            + (FaultEvent(4, "nan_lane", lane=1),)), lanes),
    }


def mesh_fault_plan(pods: int) -> FaultPlan:
    """(d)'s dead pod on the two-rank world's real hop (``pods`` = its
    ranks), and on ``make_grid`` for the reference."""
    return FaultPlan(events=(FaultEvent(FAULT_MESH_POD_ROUND, "dead_pod",
                                        pod=1),), pods=pods)


def faults_matrix(args, program, X, y, idle_exact, base: str,
                  check: bool) -> list:
    """(b) One fault a cell at the config's cadence on the exact and int8
    EF wires, a checkpoint every clean dispatch."""
    k, steps = args.cadence, args.cadence_steps
    rows = []
    for wire_name, cfg in (("exact", None),
                           ("int8 EF", CompressionConfig(bits=8))):
        plan = MergePlan(cadence=k, compression=cfg)
        idle = idle_exact
        if cfg is not None:
            idle = armed_fit(program, steps, plan, FaultPlan())[0]
        acc_idle = accuracy(idle.state, X, y)
        for kind, (fp, survivors) in fault_cells(args.lanes).items():
            ckpt = tempfile.mkdtemp(dir=base)
            res, rep, seen, seconds = armed_fit(
                program, steps, plan, fp, recovery=FAULT_POLICY, ckpt=ckpt,
                ckpt_every_rounds=1)
            trace = rep["trace"]
            rollbacks = [e for e in trace if e["action"] == "rollback"]
            degrades = [e for e in trace if e["action"] == "degrade"]
            replayed = replay_trace(trace, start_plan=plan)
            run_steps = rep["rounds"] * k      # every round at cadence k
            losses = [float(m["loss"]) for m in res.history]
            row = {"run": f"{kind}, {wire_name}, cadence {k}",
                   "launches": seen, "seconds": seconds,
                   "restarts": rep["restarts"], "rounds": rep["rounds"],
                   "steps_run": run_steps, "steps_replayed":
                   run_steps - steps, "survivors": rep["survivors"],
                   "fired": rep["fired"], "final_plan": rep["final_plan"],
                   "trace": [{key: v for key, v in e.items()
                              if key not in ("latency_s", "detail")}
                             for e in trace],
                   "latency_s": [e["latency_s"] for e in rollbacks],
                   "accuracy": accuracy(res.state, X, y),
                   "idle_accuracy": acc_idle,
                   "bit_equal_to_idle": bool(torch.equal(res.state,
                                                         idle.state))}
            name = row["run"]
            require(len(losses) == steps and all(map(math.isfinite, losses))
                    and bool(torch.isfinite(res.state).all()),
                    f"{name}: {len(losses)} history entries or not finite")
            require((replayed[-1] if replayed else plan.describe())
                    == rep["final_plan"], f"{name}: the trace does not "
                    f"replay to {rep['final_plan']}")
            require(len(rollbacks) == rep["restarts"],
                    f"{name}: {len(rollbacks)} rollbacks, "
                    f"{rep['restarts']} restarts")
            require(all(e["to_cadence"] == k for e in degrades),
                    f"{name}: the cadence was degraded: {degrades}")
            require(rep["survivors"] == survivors, f"{name}: "
                    f"{rep['survivors']} survivors, want {survivors}")
            if kind in ("nan_lane", "timeout", "torn_ckpt"):
                require(rep["restarts"] == 1 and not degrades,
                        f"{name}: {rep['restarts']} restarts, degrades "
                        f"{degrades}")
            if kind in ("nan_lane", "timeout", "torn_ckpt") or (
                    kind == "wire_bitflip" and rollbacks and not degrades):
                require(row["bit_equal_to_idle"], f"{name}: the replayed "
                        "fit is not bit-equal to the idle fit")
            if kind in ("dead_lane", "dead_pod"):
                require(abs(row["accuracy"] - acc_idle) <= PLAN_ACC_TOL,
                        f"{name}: accuracy {row['accuracy']} against the "
                        f"idle fit's {acc_idle}")
            if kind == "torn_ckpt":
                row["quarantined"] = sorted(d for d in os.listdir(ckpt)
                                            if ".corrupt" in d)
                require(row["quarantined"], f"{name}: no step quarantined")
            if check:
                want = expected(fxp_matmul=FXP_STEP * run_steps,
                                lut_activation=run_steps)
                require(seen == want, f"{name}: launches {seen}, the "
                        f"trace implies {want}")
            rows.append(row)
    return rows


def faults_kmeans(args, dev, check: bool) -> dict:
    """(c) KMeans(int16) with a dead lane at round 1 against the unarmed
    fp32 fit's SSE."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 410)
    grid = make_grid(args.lanes, device=dev)
    d, k, iters = args.km_features, args.km_clusters, args.km_iters
    X, _, _ = datasets.blobs(gen, args.rows, d, k)
    ref_sse = api.fit(KMeans(k=k), grid, X, steps=iters).eval(X)["sse"]
    fp = FaultPlan(events=(FaultEvent(1, "dead_lane", lane=5),))
    holder: dict = {}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    with faults.armed(fp, recovery=FAULT_POLICY):
        res = api.fit(KMeans(k=k, precision="int16"), grid, X, steps=iters,
                      merge_state=holder)
    sync(dev)
    seen, seconds = counts(), time.perf_counter() - t0
    rep = holder["resilience_report"]
    s = {"run": "kmeans int16, dead lane at round 1", "iterations": iters,
         "launches": seen, "seconds": seconds, "survivors":
         rep["survivors"], "restarts": rep["restarts"],
         "rounds": rep["rounds"], "sse": res.eval(X)["sse"],
         "fp32_sse": ref_sse}
    require(len(res.history) == iters and
            bool(torch.isfinite(res.state).all()), f"{s['run']}: history "
            f"of {len(res.history)} or a non-finite state")
    require(rep["survivors"] == args.lanes - 1, f"{s['run']}: "
            f"{rep['survivors']} survivors")
    require(s["sse"] <= FAULT_KM_SSE * ref_sse, f"{s['run']}: SSE "
            f"{s['sse']} above {FAULT_KM_SSE} x fp32's {ref_sse}")
    if check:
        require(seen == expected(kmeans_assign=rep["rounds"]),
                f"{s['run']}: launches {seen}, {rep['rounds']} iterations "
                "run")
    return s


def faults_mesh_one(args, program, X, y, store_dir: str,
                    check: bool) -> dict:
    """(d) A dead lane at cadence 8, no checkpoint directory, on
    ``make_mesh_grid(lanes)`` (a world of one process, NCCL on the card)
    bit-equal to the same plan on ``make_grid``."""
    dev = program.grid.device
    init_world("nccl" if dev.type == "cuda" else "gloo",
               dist.FileStore(os.path.join(store_dir, "faults1"), 1))
    try:
        mesh_program = program.workload.bind(
            make_mesh_grid(args.lanes, device=dev), X, y)
        fp = FaultPlan(events=(FaultEvent(1, "dead_lane", lane=5),))
        plan = MergePlan(cadence=args.cadence)
        steps = args.cadence_steps
        fits = {name: armed_fit(p, steps, plan, fp, recovery=FAULT_POLICY)
                for name, p in (("mesh", mesh_program), ("grid", program))}
        (m, m_rep, m_seen, m_s), (g, g_rep, g_seen, _) = \
            fits["mesh"], fits["grid"]
        s = {"run": f"dead lane, cadence {args.cadence}, (1, 1) mesh",
             "backend": dist.get_backend(), "launches": m_seen,
             "grid_launches": g_seen, "seconds": m_s,
             "survivors": m_rep["survivors"],
             "bit_equal_to_make_grid": bool(torch.equal(m.state, g.state))
             and all(bool(torch.equal(a["loss"], b["loss"]))
                     for a, b in zip(m.history, g.history))}
        require(s["bit_equal_to_make_grid"], f"{s['run']}: not bit-equal "
                "to make_grid's")
        require(m_rep["survivors"] == g_rep["survivors"] == args.lanes - 1,
                f"{s['run']}: survivors {m_rep['survivors']}")
        if check:
            want = expected(fxp_matmul=FXP_STEP * steps,
                            lut_activation=steps)
            require(m_seen == want and g_seen == want, f"{s['run']}: "
                    f"launches {m_seen} (make_grid {g_seen}), want {want}")
        return s
    finally:
        dist.destroy_process_group()


def train_faults(args, dev, card: str) -> None:
    """The main path under fault injection: (a) armed but idle, (b) the
    fault matrix, (c) K-means, (d) the (1, 1) mesh."""
    import shutil

    check = not args.rehearse
    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        program, X, y = faults_program(args, dev)
        a, idle = faults_idle(args, program, X, y, check)
        b = faults_matrix(args, program, X, y, idle, base, check)
        d = faults_mesh_one(args, program, X, y, base, check)
        del program, X, y, idle
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        c = faults_kmeans(args, dev, check)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("train_faults", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, armed_idle=a, matrix=b, kmeans=c,
         mesh_one=d, seconds=time.perf_counter() - t0)


# -- phase 14: out-of-core streaming -------------------------------------------


def stream_of(args, X, y, **kw) -> StreamingDataset:
    """The phase's stream of host rows: a partition of 1/STREAM_PARTS of
    them, STREAM_SPW steps a window, STREAM_DEPTH windows prefetched, the
    default permutation from --seed; ``kw`` overrides."""
    opts = dict(partition_rows=args.rows // STREAM_PARTS,
                steps_per_window=STREAM_SPW, prefetch_depth=STREAM_DEPTH,
                seed=args.seed)
    opts.update(kw)
    return StreamingDataset(X, y, **opts)


def same_fit(a, b) -> bool:
    """Two fits' states and histories, bit for bit."""
    return torch.equal(a.state, b.state) and len(a.history) == len(
        b.history) and all(sorted(x) == sorted(z) and all(
            torch.equal(x[key], z[key]) for key in x)
        for x, z in zip(a.history, b.history))


def streamed_fit(wl, grid, source, steps, **kw) -> tuple:
    """A fit over ``source`` (a ``StreamingDataset``: ``api.fit``, which
    binds it; a bound ``StreamProgram``: its ``fit``) with the counters
    set to 0 just before and read just after, and the device memory
    allocated read in the callback at every step: (result, launches,
    seconds, baseline bytes, readings, the rotation's statistics)."""
    dev = grid.device
    readings: list = []

    def cb(step, state, metrics):
        if dev.type == "cuda":
            readings.append(torch.cuda.memory_allocated(dev))

    holder: dict = kw.pop("merge_state", {})
    sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    reset_counts()
    t0 = time.perf_counter()
    if isinstance(source, api.StreamProgram):
        res = source.fit(steps=steps, callback=cb, merge_state=holder, **kw)
    else:
        res = api.fit(wl, grid, source, steps=steps, callback=cb,
                      merge_state=holder, **kw)
    sync(dev)
    return (res, counts(), time.perf_counter() - t0, base, readings,
            holder["streaming_trace"])


def windowed_reference(wl, grid, X, y, rotation, steps, spw, **fit_kw):
    """The rotation's plain version on the card: the resident set
    (``Workload.bind``), each window's slots taken by ``index_select``
    with the sampler's schedule drawn on the card
    (``minibatch.batch_indices``), the mask multiplied into ``w`` and the
    partials by ``per / n_valid`` (the sampler's multiply); one
    ``PimGrid.fit`` of ``spw`` steps a window, on the eager rounds
    (``engine="python"``), as the rotation runs its windows.  Returns
    (state, history, launches)."""
    dev = grid.device
    prog = wl.bind(grid, X, y)
    per, part, seed = rotation.per, rotation.part, rotation.stream.seed
    state, history = prog.state0, []
    sync(dev)
    reset_counts()
    for t in range(-(-steps // spw)):
        idx, mask = mb.batch_indices(per, part, seed,
                                     torch.tensor(t, device=dev))
        win = {key: v.index_select(1, idx) for key, v in prog.data.items()}
        win["w"] = win["w"] * mask
        scale = torch.full((), float(per), device=dev) / torch.clamp(
            mask.sum(), min=1.0)

        def lf(st, sl, _s=scale):
            return {key: v * _s for key, v in prog.local_fn(st, sl).items()}

        state, h = grid.fit(init_state=state, local_fn=lf,
                            update_fn=prog.update_fn, data=win,
                            steps=min(spw, steps - len(history)),
                            engine="python", **fit_kw)
        history.extend(h)
    sync(dev)
    return state, history, counts()


def stream_window_cost(args, wl, prog, Xh, yh) -> tuple:
    """One window's ingest of the bound ``prog`` timed alone, three
    windows: the gather of its rows (``np.take``), the workload's numpy
    transform (int8 quantization), the whole ``window_host`` (schedule,
    gather, transform, the pad rows) and ``place`` (pinned copy and H2D).
    Returns (summary, a staged window's bytes)."""
    rot, consts = prog.data, prog.consts
    parts = {"gather_s": [], "transform_s": [], "window_host_s": [],
             "h2d_s": []}
    buf = np.empty((args.lanes * rot.part, args.features), np.float32)
    for t in range(3):
        idx, _ = rot.schedule(t)
        rows = (np.arange(args.lanes, dtype=np.int64)[:, None] * rot.per
                + idx[None, :]).ravel()
        t0 = time.perf_counter()
        np.take(Xh, rows, axis=0, out=buf)
        yb = np.take(yh, rows)
        t1 = time.perf_counter()
        wl.stream_transform(consts, buf, yb)
        t2 = time.perf_counter()
        host = rot.window_host(t)
        t3 = time.perf_counter()
        placed = rot.place(host)
        sync(prog.grid.device)
        t4 = time.perf_counter()
        for key, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key].append(v)
    staged = nbytes(*placed.values())
    out = {key: statistics.median(v) for key, v in parts.items()}
    out.update(windows_timed=3, rows=args.lanes * rot.part,
               gathered_bytes=int(buf.nbytes), staged_bytes=staged,
               staged_dtypes={key: str(v.dtype) for key, v in placed.items()},
               per=rot.per, part=rot.part,
               windows_per_epoch=rot.windows_per_epoch)
    return out, staged


def stream_one_window(args, wl, grid, X, y, Xh, yh, check) -> dict:
    """(a) One window of every row, unshuffled, at the config's cadence:
    bit-equal to the resident full-batch fit, with its launches."""
    k, steps = args.cadence, args.cadence_steps
    want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
    sd = StreamingDataset(Xh, yh, partition_rows=args.rows,
                          steps_per_window=steps, prefetch_depth=0,
                          shuffle=False, seed=args.seed)
    res, seen, seconds, _, _, stats = streamed_fit(wl, grid, sd, steps,
                                                   merge_every=k)
    ref, ref_seen, ref_stats = counted_fit(wl, grid, X, y, steps,
                                           merge_every=k)
    s = {"run": f"one window, shuffle=False, cadence {k}", "steps": steps,
         "launches": seen, "resident_launches": ref_seen,
         "expected_launches": want, "seconds": seconds,
         "resident_seconds": ref_stats["seconds_fit"],
         "ingest_s": stats["ingest_s"], "windows": stats["windows"],
         "bit_equal_to_resident": same_fit(res, ref),
         "accuracy": accuracy(res.state, X, y)}
    require(s["bit_equal_to_resident"], f"{s['run']}: not bit-equal to "
            "the resident full-batch fit")
    ref_want = fit_expect(want, steps, grid, merge_every=k)
    s["resident_expected_launches"] = ref_want
    if check:
        require(seen == want and ref_seen == ref_want, f"{s['run']}: "
                f"launches {seen} (resident {ref_seen}), the design "
                f"implies {want} ({ref_want})")
    return s


def stream_rotations(args, wl, prog, X, y, Xh, yh, window_bytes: int,
                     check: bool) -> tuple:
    """(b) Rotations of the bound ``prog`` (STREAM_SPW steps a window) at
    cadence 8 and 1 and under int8 EF at 8 against
    :func:`windowed_reference`, and of one step a window (an epoch)
    against the resident minibatch fit, bit for bit with the same
    launches; (d) the memory read at every step.  Returns (summary, the
    cadence-8 rotation's result)."""
    grid, rot = prog.grid, prog.data
    k, steps = args.cadence, args.cadence_steps
    ef = MergePlan(cadence=k, compression=CompressionConfig(bits=8))
    bound = (STREAM_DEPTH + 2) * window_bytes
    runs, main = [], None
    for name, kw in ((f"cadence {k}", dict(merge_every=k)),
                     ("cadence 1", dict(merge_every=1)),
                     (f"int8 EF, cadence {k}", dict(merge_plan=ef))):
        ms: dict = {}
        res, seen, seconds, base, readings, stats = streamed_fit(
            wl, grid, prog, steps, merge_state=ms, **kw)
        ref_ms: dict = {}
        ref_state, ref_hist, ref_seen = windowed_reference(
            wl, grid, X, y, rot, steps, STREAM_SPW, merge_state=ref_ms,
            **kw)
        want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
        s = {"run": f"rotation, {name}", "steps": steps,
             "windows": stats["windows"], "launches": seen,
             "reference_launches": ref_seen, "expected_launches": want,
             "seconds": seconds, "stats": stats,
             "bit_equal_to_reference": same_fit(
                 res, api.FitResult(ref_state, ref_hist, wl)),
             "accuracy": accuracy(res.state, X, y)}
        if "error" in ms:
            s["ef_buffer_bit_equal"] = all(
                torch.equal(p, q) for p, q in zip(tree_leaves(ms["error"]),
                                                  tree_leaves(ref_ms[
                                                      "error"])))
            require(s["ef_buffer_bit_equal"], f"{s['run']}: the EF buffer "
                    "differs from the reference's")
        if grid.device.type == "cuda":
            require(readings, f"{s['run']}: the callback read no memory")
            s["memory"] = {"baseline_bytes": base,
                           "window_bytes": window_bytes,
                           "bound_bytes": base + bound,
                           "max_bytes": max(readings),
                           "max_windows": (max(readings) - base)
                           / window_bytes, "readings": len(readings)}
            require(max(readings) <= base + bound, f"{s['run']}: "
                    f"{max(readings)} bytes allocated at a window, above "
                    f"{base} + {STREAM_DEPTH + 2} windows")
        require(s["bit_equal_to_reference"], f"{s['run']}: not bit-equal "
                "to the windowed resident reference")
        if check:
            require(seen == want and ref_seen == want, f"{s['run']}: "
                    f"launches {seen} (reference {ref_seen}), the design "
                    f"implies {want}")
        runs.append(s)
        if main is None:
            main = res
    # one step a window: the resident minibatch sampler, literally
    steps = STREAM_PARTS
    sd = stream_of(args, Xh, yh, steps_per_window=1)
    res, seen, seconds, _, _, stats = streamed_fit(wl, grid, sd, steps)
    ref, ref_seen, _ = counted_fit(wl, grid, X, y, steps,
                                   batch_size=rot.part, sample_seed=args.seed)
    want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
    s = {"run": "rotation, one step a window, cadence 1 (an epoch)",
         "steps": steps, "windows": stats["windows"], "batch_size": rot.part,
         "launches": seen, "resident_launches": ref_seen,
         "expected_launches": want, "seconds": seconds, "stats": stats,
         "bit_equal_to_resident_minibatch": same_fit(res, ref)}
    require(s["bit_equal_to_resident_minibatch"], f"{s['run']}: not "
            "bit-equal to the resident minibatch fit")
    ref_want = fit_expect(want, steps, grid)
    s["resident_expected_launches"] = ref_want
    if check:
        require(seen == want and ref_seen == ref_want, f"{s['run']}: "
                f"launches {seen} (resident {ref_seen}), the design "
                f"implies {want} ({ref_want})")
    runs.append(s)
    return runs, main


def stream_rates(args, wl, prog, X, y, Xh, yh) -> dict:
    """(c) Steps/s of the rotation at depth 0 and of the bound ``prog``
    (depth 2) and of the resident minibatch fit at ``batch_size=part``,
    STREAM_RATE_FITS fits each in turns at the config's cadence, with
    each rotation's statistics and the residency tax (streaming steps/s
    over resident)."""
    grid = prog.grid
    k, steps = args.cadence, args.cadence_steps
    progs = {"depth 0": wl.bind_stream(grid, stream_of(
                 args, Xh, yh, prefetch_depth=0)),
             "depth 2": prog,
             "resident minibatch": wl.bind(grid, X, y)}
    part = progs["depth 2"].data.part
    opts = {"resident minibatch": dict(batch_size=part,
                                       sample_seed=args.seed)}
    progs["resident minibatch"].fit(steps=STREAM_SPW, merge_every=k,
                                    **opts["resident minibatch"])
    rates: dict = {name: [] for name in progs}
    stats: dict = {name: [] for name in progs if name.startswith("depth")}
    order = list(progs)
    for i in range(STREAM_RATE_FITS):
        for name in (order if i % 2 == 0 else order[::-1]):
            sync(grid.device)
            t0 = time.perf_counter()
            progs[name].fit(steps=steps, merge_every=k, **opts.get(name, {}))
            sync(grid.device)
            rates[name].append(steps / (time.perf_counter() - t0))
            if name in stats:
                stats[name].append(progs[name].data.last_run_stats)
    out = {name: {"median": statistics.median(r), "min": min(r),
                  "max": max(r), "fits": len(r)}
           for name, r in rates.items()}
    for name, st in stats.items():
        out[name]["rotation_stats"] = st
        out[name]["residency_tax"] = (
            out[name]["median"] / out["resident minibatch"]["median"])
    out.update(steps=steps, cadence=k, batch_size=part)
    return out


def stream_trainer(args, prog, ref, base: str, check: bool) -> dict:
    """(e) ``Trainer.for_program`` over the bound StreamProgram at the
    config's cadence, checkpoints every STREAM_CKPT_EVERY steps, and a
    second trainer over it: bit-equal to
    (b)'s cadence-8 rotation with its launches, every manifest carrying
    the rotation's tag and window, and a fresh trainer resumed from the
    first checkpoint (the one covering step 16) ending bit-equal."""
    import shutil

    k, steps = args.cadence, args.cadence_steps

    def cfg(d):
        return TrainerConfig(ckpt_dir=d, ckpt_every=STREAM_CKPT_EVERY,
                             log_every=STREAM_CKPT_EVERY, merge_every=k,
                             ckpt_keep=1000)

    dir_a = tempfile.mkdtemp(dir=base)
    tr, out, seen, seconds = counted_trainer(prog, cfg(dir_a), steps)
    saved = tr.ckpt.steps()
    extras = []
    for step in saved:
        with open(os.path.join(dir_a, f"step_{step:010d}",
                               "manifest.json")) as f:
            extras.append(json.load(f)["extra"])
    want = expected(fxp_matmul=FXP_STEP * steps, lut_activation=steps)
    first = saved[0]
    dir_b = tempfile.mkdtemp(dir=base)
    shutil.copytree(os.path.join(dir_a, f"step_{first:010d}"),
                    os.path.join(dir_b, f"step_{first:010d}"))
    resumed = Trainer.for_program(prog, cfg(dir_b))
    start = resumed.start_step
    resumed.run(steps - start)
    s = {"run": f"Trainer.for_program over the StreamProgram, cadence {k}",
         "steps": steps, "ckpt_every": STREAM_CKPT_EVERY, "launches": seen,
         "expected_launches": want, "seconds": seconds,
         "restarts": out["restarts"], "checkpoints": saved,
         "manifests": [{key: e.get(key) for key in ("stream_tag",
                                                    "rotation_window")}
                       for e in extras],
         "bit_equal_to_api_fit": bool(torch.equal(tr.state, ref.state))
         and same_history(out, ref.history),
         "resumed_from_step": first, "resumed_start_step": start,
         "resumed_bit_equal": bool(torch.equal(resumed.state, ref.state))}
    require(s["bit_equal_to_api_fit"], f"{s['run']}: not bit-equal to "
            "api.fit over the stream")
    require(saved and all(e.get("stream_tag") == prog.stream_tag and
                          e.get("rotation_window") == t // STREAM_SPW
                          for e, t in zip(extras, saved)),
            f"{s['run']}: manifests {s['manifests']} at {saved}")
    require(start == first + 1 and s["resumed_bit_equal"], f"{s['run']}: "
            f"resumed at {start} from the step-{first} checkpoint, "
            f"bit-equal {s['resumed_bit_equal']}")
    if check:
        require(seen == want, f"{s['run']}: launches {seen}, the design "
                f"implies {want}")
    return s


def stream_kmeans(args, dev, check: bool) -> dict:
    """(f) KMeans(int16) at d = 16 from host rows, one window an
    iteration: bit-equal to the resident minibatch fit at ``batch_size =
    part``, a ``kmeans_assign`` launch an iteration."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 510)
    grid = make_grid(args.lanes, device=dev)
    d, k, iters = args.km_features, args.km_clusters, args.km_iters
    X, _, _ = datasets.blobs(gen, args.rows, d, k)
    Xh = X.cpu().numpy()
    wl = KMeans(k=k, precision="int16", seed=args.seed)
    sd = stream_of(args, Xh, None, steps_per_window=None)
    res, seen, seconds, _, _, stats = streamed_fit(wl, grid, sd, iters)
    part = sd.bind(grid).part
    ref, ref_seen, _ = counted_fit(wl, grid, X, None, iters,
                                   batch_size=part, sample_seed=args.seed)
    want = expected(kmeans_assign=iters)
    s = {"run": "kmeans int16, one window an iteration", "iterations": iters,
         "host_bytes": int(Xh.nbytes), "batch_size": part,
         "launches": seen, "resident_launches": ref_seen,
         "expected_launches": want, "seconds": seconds, "stats": stats,
         "bit_equal_to_resident_minibatch": same_fit(res, ref),
         "sse_last": float(res.history[-1]["sse"])}
    require(s["bit_equal_to_resident_minibatch"], f"{s['run']}: not "
            "bit-equal to the resident minibatch fit")
    ref_want = fit_expect(want, iters, grid)
    s["resident_expected_launches"] = ref_want
    if check:
        require(seen == want and ref_seen == ref_want, f"{s['run']}: "
                f"launches {seen} (resident {ref_seen}), the design "
                f"implies {want} ({ref_want})")
    return s


def train_stream(args, dev, card: str) -> None:
    """The main path trained from host rows (``data.pipeline``): (a) one
    window, (b) rotations against their references and (d) the memory
    read at every window, (c) the rates in turns and one window's
    ingest, (e) the trainer, (f) K-means."""
    import shutil

    check = not args.rehearse
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 500)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    Xh, yh = X.cpu().numpy(), y.cpu().numpy()
    grid = make_grid(args.lanes, device=dev)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    base = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # one bind (stream_consts: the absmax over every host row) of the
        # main stream, shared by (b), (c) and (e)
        t1 = time.perf_counter()
        prog = wl.bind_stream(grid, stream_of(args, Xh, yh))
        sync(dev)
        bind_s = time.perf_counter() - t1
        window, window_bytes = stream_window_cost(args, wl, prog, Xh, yh)
        window["bind_s"] = bind_s
        a = stream_one_window(args, wl, grid, X, y, Xh, yh, check)
        b, main = stream_rotations(args, wl, prog, X, y, Xh, yh,
                                   window_bytes, check)
        c = stream_rates(args, wl, prog, X, y, Xh, yh)
        e = stream_trainer(args, prog, main, base, check)
        del X, y, Xh, yh, main, prog
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        f = stream_kmeans(args, dev, check)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("train_stream", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, host_bytes=args.rows * args.features * 4,
         partition_rows=args.rows // STREAM_PARTS,
         steps_per_window=STREAM_SPW, prefetch_depth=STREAM_DEPTH,
         window=window, one_window=a, rotations=b, rates=c, trainer=e,
         kmeans=f, seconds=time.perf_counter() - t0)


# -- phase 15: the compiled engine ------------------------------------------

# train_graph: fits of 48 steps (a multiple of the config's cadence 8; at
# cadence 1 a chunk of 32 rounds and one of 16), K-means of the config's 10
# iterations (at cadence 8 one round and a trailing round of 2); the
# rates are GRAPH_FITS fits a contender, in turns
GRAPH_STEPS = 48
GRAPH_FITS = 3
GRAPH_KERNELS = {"fxp_matmul": re.compile(r"fxp_\w+?_kernel"),
                 "lut_activation": re.compile(r"lut_kernel"),
                 "kmeans_assign": re.compile(r"km_reduce")}


def graph_cells(args) -> dict:
    """train_graph's configurations: name -> (data set, workload, the
    fit's keyword arguments)."""
    k = args.cadence
    batch = args.rows // args.lanes // MB_FRACTION
    lr8 = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    int8 = CompressionConfig(bits=8)
    km = KMeans(k=args.km_clusters, precision="int16")
    return {
        "logreg int8 lut, cadence 1": ("binary", lr8, {}),
        f"logreg int8 lut, cadence {k}": ("binary", lr8, {"merge_every": k}),
        "logreg fp32 exact, cadence 1": ("binary", LogReg(lr=0.5), {}),
        "svm int8, cadence 1": ("binary", LinearSVM(
            lr=0.1, l2=CONFIG.svm_l2, precision="int8"), {}),
        f"logreg int8 lut, batch_size {batch}, cadence 1": (
            "binary", lr8, {"batch_size": batch}),
        f"logreg int8 lut, batch_size {batch}, cadence {k}": (
            "binary", lr8, {"batch_size": batch, "merge_every": k}),
        "SlowMo, cadence 1": ("binary", lr8, {
            "merge_plan": MergePlan(outer=SlowMo())}),
        f"SlowMo, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, outer=SlowMo())}),
        f"Nesterov, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, outer=Nesterov())}),
        "int8 EF, cadence 1": ("binary", lr8, {
            "merge_plan": MergePlan(compression=int8)}),
        f"int8 EF, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, compression=int8)}),
        f"top-k {WIRE_TOP_K} int8, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, compression=CompressionConfig(
                bits=8, top_k_frac=WIRE_TOP_K))}),
        "overlap, cadence 1": ("binary", lr8, {
            "merge_plan": MergePlan(overlap=True)}),
        f"overlap, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, overlap=True)}),
        f"overlap + int8 EF + SlowMo, cadence {k}": ("binary", lr8, {
            "merge_plan": MergePlan(cadence=k, overlap=True,
                                    compression=int8, outer=SlowMo())}),
        "linreg int8, cadence 1": ("regression", LinReg(
            lr=0.1, precision="int8"), {}),
        "multinomial int8 lut C=4, cadence 1": ("mixture", MultinomialLogReg(
            n_classes=4, precision="int8", softmax="lut"), {}),
        "kmeans int16, cadence 1": ("blobs", km, {}),
        f"kmeans int16, cadence {k}": ("blobs", km, {"merge_every": k}),
        f"kmeans int16, batch_size {batch}": ("blobs", km,
                                              {"batch_size": batch}),
    }


def graph_data(name: str, args, gen):
    """A train_graph data set at the path's full size: (X, y)."""
    if name == "binary":
        X, y, _ = datasets.binary_classification(gen, args.rows,
                                                 args.features)
    elif name == "regression":
        X, y, _ = datasets.regression(gen, args.rows, args.features)
    elif name == "mixture":
        X, y = datasets.mixture_classification(gen, args.rows,
                                               args.features, 4)
    else:
        X, _, _ = datasets.blobs(gen, args.rows, args.km_features,
                                 args.km_clusters)
        y = None
    return X, y


def step_launches(wl) -> dict:
    """The port's kernels one local step of ``wl`` launches."""
    if isinstance(wl, KMeans):
        return {"kmeans_assign": 1}
    if wl.precision == "fp32":
        return {}
    n_fxp = 2 * dispatch.hybrid_launches(getattr(wl, "n_classes", 1))
    lut = getattr(wl, "sigmoid", getattr(wl, "softmax", "")) == "lut"
    return {"fxp_matmul": n_fxp, **({"lut_activation": 1} if lut else {})}


def graph_count(steps: int, plan: MergePlan, chunk: int = SCAN_CHUNK) -> int:
    """Graphs a fit captures on fresh runners: a chunk length of full
    rounds each (the full chunk, the last one), and the trailing short
    round's."""
    rounds, rem = divmod(steps, plan.cadence)
    lengths = {min(chunk, rounds)} | ({rounds % chunk} if rounds > chunk
                                      and rounds % chunk else set())
    return (len(lengths) if rounds else 0) + (1 if rem else 0)


def fit_gap(a, b) -> float:
    """The largest difference of two fits, over the state and every
    history value."""
    gap = float((a.state.double() - b.state.double()).abs().max())
    for x, z in zip(a.history, b.history, strict=True):
        for key in x:
            gap = max(gap, float((x[key].double()
                                  - z[key].double()).abs().max()))
    return gap


def eager_scan_fit(program, steps: int, plan: MergePlan,
                   batch_size=None) -> tuple:
    """The eager chunk loop ``engine="scan"`` ran before the chunk
    runners, on ``program``'s functions: ``PimGrid.fit``'s rounds through
    ``merge_plan.run_rounds`` (``merge_plan.run_fit``'s for another
    plan), one host sync a chunk of 32 rounds, nothing captured."""
    lf, uf, s0, _ = program._triple(batch_size, 0)
    grid, data = program.grid, program.data
    if not plan.is_exact_default:
        return mp.run_fit(grid, plan, init_state=s0, local_fn=lf,
                          update_fn=uf, data=data, steps=steps,
                          callback=None, scan_chunk=SCAN_CHUNK,
                          engine="scan", merge_state=None, compiled=False)

    def round_fn(state, kk):
        if kk == 1:
            state, metrics = uf(state, grid.map_reduce(lf, state, data))
            return state, [metrics]
        return mp.cadence_round(grid, lf, uf, kk, state, data)

    return mp.run_rounds(steps, plan.cadence, round_fn, s0, engine="scan",
                         scan_chunk=SCAN_CHUNK, callback=None)


def fit_runners(program, steps: int, plan: MergePlan,
                batch_size=None) -> list:
    """The chunk runners a scan fit of ``program`` replays (from the
    grid's cache)."""
    lf, uf, _, _ = program._triple(batch_size, 0)
    grid = program.grid
    rounds, rem = divmod(steps, plan.cadence)
    out = []
    for kk, n in ((plan.cadence, rounds), (rem, rem)):
        if not n:
            continue
        if plan.is_exact_default:
            out.append(grid.make_runner(lf, uf, merge_every=kk))
        else:
            out.append(mp.pipeline_runners(
                grid, lf, uf, merge_every=kk,
                overlap=plan.overlap and kk == plan.cadence,
                compression=plan.compression, state_wire=plan.cadence > 1,
                outer=plan.outer)["runner"])
    return out


def turns(contenders: dict, steps: int, fits: int, dev) -> dict:
    """Steps/s of each contender (a function running one fit of
    ``steps`` steps): the median, lowest and highest of ``fits`` fits,
    in turns (in order, then reversed, ...), host clock ending in a
    synchronise."""
    for run in contenders.values():
        run()
    sync(dev)
    rates: dict = {name: [] for name in contenders}
    order = list(contenders)
    for i in range(fits):
        for name in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            contenders[name]()
            sync(dev)
            rates[name].append(steps / (time.perf_counter() - t0))
    return {name: {"median": statistics.median(r), "min": min(r),
                   "max": max(r), "fits": fits} for name, r in rates.items()}


def graph_snapshot() -> tuple:
    """The replays of every live captured graph and the wrappers'
    counts, to be read again by :func:`launches_since`."""
    return {g: g.replays for g in Graph.live()}, counts()


def launches_since(snapshot: tuple, patterns: dict) -> dict:
    """The launches of each kernel of ``patterns`` (name -> regex of its
    CUDA function) since ``snapshot``, counted without the profiler: the
    wrapper's own launches, plus, for each captured graph, its kernel
    nodes of that kernel (``Graph.kernel_nodes``: the graph captured under
    ``Graph.keep_nodes``) times the replays it made since; the wrappers'
    launches alone for a snapshot without the graphs' replays."""
    replays, before = snapshot
    now = counts()
    seen = {name: now.get(name, 0) - before.get(name, 0)
            for name in patterns}
    for g in Graph.live() if replays is not None else ():
        n = g.replays - replays.get(g, 0)
        if not n:
            continue
        nodes = g.kernel_nodes()
        for name, pattern in patterns.items():
            seen[name] += n * sum(bool(pattern.search(x)) for x in nodes)
    return seen


@contextlib.contextmanager
def keeping_graph_nodes():
    """Graphs captured in the block keep their nodes, so that
    :func:`launches_since` can count what their replays launch."""
    Graph.keep_nodes = True
    try:
        yield
    finally:
        Graph.keep_nodes = False


def device_launches(run, dev, count_graphs: bool = True) -> tuple:
    """One call of ``run()`` after a warm one: the port's kernels it put
    on the card (:func:`launches_since`; a replay runs no Python, so the
    wrappers' counters see only the kernels launched outside a graph,
    and ``count_graphs=False`` counts those alone) and, from
    ``torch.profiler`` over the same call, the host's CUDA launch calls,
    the idle share and the profiler's own count of the kernels (which
    lost events in a long process: 110 of 112 fxp launches once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    sync(dev)
    # one warm-up call traced and discarded: a trace that starts with
    # graph replays lost the first kernels of the first (1 fxp_* and the
    # lut_kernel of 48 steps, on an H100) even after a 50 ms pause
    traced: list = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        run()
        sync(dev)
        prof.step()
        snap = graph_snapshot() if count_graphs else (None, counts())
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        seen = launches_since(snap, GRAPH_KERNELS)
        prof.step()
    by_profiler = {name: 0 for name in GRAPH_KERNELS}
    busy_us, host_launches = 0.0, 0
    for e in traced[0]:
        if e.key.startswith("ProfilerStep"):
            continue             # the step's span on the device timeline
        if e.device_type == DeviceType.CUDA:
            busy_us += e.self_device_time_total
            for name, pattern in GRAPH_KERNELS.items():
                if pattern.search(e.key):
                    by_profiler[name] += e.count
        elif e.key.startswith("cuda") and "Launch" in e.key:
            host_launches += e.count
    return seen, {"traced_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                  "idle_share": (max(0.0, 1.0 - busy_us / 1e3 / wall_ms)
                                 if busy_us else "not measured"),
                  "host_launch_calls": host_launches,
                  "profiler_launches": by_profiler}


def graph_cell(name: str, program, kw: dict, steps: int, dev,
               check: bool) -> dict:
    """One train_graph configuration: (a) the scan fit on its captured
    chunks against ``engine="python"``, bit for bit, in the state and
    every history entry (where the eager fit does not repeat itself, the
    spread it shows bounds the graph's gap); (b) the captures of a first
    and a second fit of the program; (c) the port's kernels the replays
    launch, counted from the graphs' kernel nodes times their replays,
    against the eager rounds'; (d)
    steps/s of the graph, ``engine="python"`` and the eager chunk loop,
    in turns, and their idle shares; (e) the graphs' pool bytes."""
    plan = fit_plan(kw)
    batch = kw.get("batch_size")

    def graph():
        return program.fit(steps=steps, **kw)

    def python():
        return program.fit(steps=steps, engine="python", **kw)

    eager, again = python(), python()
    before = Graph.captures
    first = graph()
    captured = Graph.captures - before
    second = graph()
    captured_again = Graph.captures - before - captured
    repeats = same_fit(eager, again)
    s = {"run": name, "steps": steps, "plan": plan.describe(),
         "batch_size": batch, "eager_repeats_bit_equal": repeats,
         "bit_equal_to_python": same_fit(first, eager),
         "second_fit_bit_equal": same_fit(second, first),
         "captures_first_fit": captured,
         "expected_captures": graph_count(steps, plan),
         "captures_second_fit": captured_again}
    if not repeats:
        s["eager_spread"] = fit_gap(eager, again)
        s["graph_gap"] = fit_gap(first, eager)
        require(s["graph_gap"] <= s["eager_spread"], f"train_graph {name}: "
                f"graph gap {s['graph_gap']} beyond the eager fit's own "
                f"spread {s['eager_spread']}")
    else:
        require(s["bit_equal_to_python"], f"train_graph {name}: the "
                "graph fit != engine=\"python\" (which repeats itself)")
    require(s["second_fit_bit_equal"], f"train_graph {name}: a second "
            "graph fit differs from the first")
    require(captured == s["expected_captures"] and captured_again == 0,
            f"train_graph {name}: captures {captured} then "
            f"{captured_again}, expected {s['expected_captures']} then 0")
    local = eager_local_steps(steps, plan)
    want = {k: n * local for k, n in step_launches(program.workload).items()}
    seen, prof = device_launches(graph, dev)
    seen = {k: n for k, n in seen.items() if n or k in want}
    _, prof_python = device_launches(python, dev)
    s.update(replayed_launches=seen, expected_launches=want,
             launches_per_step={k: n / local for k, n in seen.items()},
             profile_graph=prof, profile_python=prof_python)
    if check:
        require(seen == want, f"train_graph {name}: the replays launched "
                f"{seen}, the eager rounds {want}")
    s["steps_per_s"] = turns(
        {"graph": graph, "python": python,
         "eager scan": lambda: eager_scan_fit(program, steps, plan, batch)},
        steps, GRAPH_FITS, dev)
    s["pool_bytes"] = sum(r.pool_bytes() for r in fit_runners(
        program, steps, plan, batch))
    return s


def train_graph(args, dev, card: str) -> dict:
    """The compiled engine (``core.graphs``): every configuration of
    :func:`graph_cells` at the path's full size through
    :func:`graph_cell`, and two ``api.fit`` calls of the main path (new
    closures a call: each captures again).  Returns the main path's and
    K-means' replayed launches, for the kernels line."""
    check = not args.rehearse
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 600)
    grid = make_grid(args.lanes, device=dev)
    cells = graph_cells(args)
    runs, replayed, api_captures = [], {}, []
    for data_name in ("binary", "regression", "mixture", "blobs"):
        X, y = graph_data(data_name, args, gen)
        for name, (dset, wl, kw) in cells.items():
            if dset != data_name:
                continue
            steps = (args.km_iters if isinstance(wl, KMeans)
                     else GRAPH_STEPS)
            program = wl.bind(grid, X, y)
            s = graph_cell(name, program, kw, steps, dev, check)
            runs.append(s)
            if name in ("logreg int8 lut, cadence 1",
                        "kmeans int16, cadence 1"):
                replayed[name] = (s["replayed_launches"], steps)
            del program
        if data_name == "binary":
            wl = cells["logreg int8 lut, cadence 1"][1]
            for _ in range(2):
                before = Graph.captures
                api.fit(wl, grid, X, y, steps=GRAPH_STEPS)
                api_captures.append(Graph.captures - before)
            require(api_captures == [2, 2], f"train_graph: api.fit "
                    f"captured {api_captures} (new closures a call)")
        del X, y
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    emit("train_graph", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features, runs=runs,
         api_fit_captures=api_captures, seconds=time.perf_counter() - t0)
    return replayed


# -- phases 15b and 15c ----------------------------------------------------

TUNE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
TUNE_FITS = 3
TUNE_NODES = (1, 8, 32)
TUNE_CLASSES = 10


@contextlib.contextmanager
def block_table(path: str):
    """``tuning.autotune``'s table at ``path`` while the block runs; the
    variable as it was after it."""
    old = os.environ.get(TUNE_ENV)
    os.environ[TUNE_ENV] = path
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(TUNE_ENV, None)
        else:
            os.environ[TUNE_ENV] = old


def sweep_summary(case: str, sweep) -> dict:
    """A sweep's candidates with their ms (a call each), the refused
    ones, the heuristic (candidate 0) and the winner."""
    ms = [m.seconds * 1e3 for m in sweep.measured]
    best = min(range(len(ms)), key=ms.__getitem__)
    return {"case": case, "key": sweep.measured[0].key[1],
            "candidates": [{"blocks": dict(m.key[2]), "ms": t}
                           for m, t in zip(sweep.measured, ms)],
            "refused": [{"blocks": b, "why": why}
                        for b, why in sweep.refused],
            "heuristic": dict(sweep.measured[0].key[2]),
            "heuristic_ms": ms[0],
            "winner": dict(sweep.measured[best].key[2]), "winner_ms": ms[best]}


def tune_sweeps(args, dev) -> dict:
    """Every candidate of the three tuned kernels at the main path's
    shapes, each held against the plain version (fxp_matmul and
    split_hist bit for bit; kmeans_assign's counts bit for bit, its sums
    and sse within KM_REL_TOL of their mass), timed, and the winners
    stored in the current table."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 50)
    L, R, d = args.lanes, args.rows // args.lanes, args.features
    out: dict = {"fxp_matmul": [], "kmeans_assign": [], "split_hist": []}

    def keep(kernel, case, sweep):
        at.store_best(sweep)
        out[kernel].append(sweep_summary(case, sweep))

    X = rand_int(gen, (L, R, d), -128, 128, torch.int8)
    dots = {"logreg forward": (X, int16s(gen, (d, 1))),
            "logreg gradient": (X.transpose(-1, -2),
                                int16s(gen, (L, R, 1))),
            f"multinomial C={TUNE_CLASSES} forward":
                (X, int16s(gen, (d, TUNE_CLASSES))),
            f"multinomial C={TUNE_CLASSES} gradient":
                (X.transpose(-1, -2), int16s(gen, (L, R, TUNE_CLASSES)))}
    for case, (a, b) in dots.items():
        want = ref.fxp_matmul_ref(a, b)

        def same(blocks, got, want=want, case=case):
            require(bool(torch.equal(got, want)),
                    f"fxp_matmul {case} at {blocks} != plain version")

        keep("fxp_matmul", case, at.measure_candidates(
            "fxp_matmul", dispatch.fxp_shape(a, b), device=dev,
            inputs=(a, b), check=same))
        del want
    del X, dots

    k = args.km_clusters
    x, c, w, scale, xf = km_inputs(gen, L, R, args.km_features, k,
                                   torch.int16, False)
    want = ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
    onehot = (want[3].long()[..., None] == torch.arange(k, device=dev)
              ).double() * w.double()[..., None]
    mass = onehot.transpose(-1, -2) @ xf.abs().double()
    del onehot, xf

    def near(blocks, got):
        sums_ok = bool(((got[0].double() - want[0].double()).abs()
                        <= KM_REL_TOL * mass + 1e-30).all())
        sse_ok = bool(((got[2].double() - want[2].double()).abs()
                       <= KM_REL_TOL * (want[2].double().abs() + 1)).all())
        require(bool(torch.equal(got[1], want[1])) and sums_ok and sse_ok,
                f"kmeans_assign at {blocks}: counts, sums or sse off the "
                "plain version")

    keep("kmeans_assign", f"int16, K = {k}, D = {args.km_features}",
         at.measure_candidates("kmeans_assign", (L, R, args.km_features, k),
                               device=dev, inputs=(x, c, w, scale),
                               check=near))
    del x, c, w, scale, want, mass

    bins, classes = args.dt_bins, args.dt_classes
    for nodes in TUNE_NODES:
        node, xbin, y, w = sh_inputs(gen, L, R, args.dt_features, nodes,
                                     bins, classes, torch.uint8)
        kw = {"n_nodes": nodes, "n_bins": bins, "n_classes": classes}
        H = ref.split_hist_ref(node, xbin, y, w, **kw)

        def same_h(blocks, got, H=H, nodes=nodes):
            require(bool(torch.equal(got, H)),
                    f"split_hist at {nodes} nodes, {blocks} != plain version")

        keep("split_hist", f"uint8, {nodes} nodes", at.measure_candidates(
            "split_hist", (L, R, args.dt_features, nodes * bins * classes),
            device=dev, hist=(nodes, bins, classes),
            inputs=(node, xbin, y, w), check=same_h))
        del node, xbin, y, w, H
    return out


def tuned_turns(args, dev, card: str, tables: dict) -> dict:
    """The main path under the tuned table against the heuristic
    (``tables``: name -> table path), each on a fresh grid, in turns:
    LogReg int8 + LUT at cadence 1 and 8 (steps/s), KMeans int16
    (iterations/s) and the tree (seconds per tree); the tuned fits
    within PERF.md's bars (accuracy within 0.01 of fp32, SSE at most
    1.05 x fp32's, the tree equal to the heuristic's)."""
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out: dict = {}
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    grid = make_grid(args.lanes, device=dev)
    acc_ref = accuracy(api.fit(LogReg(lr=0.5), grid, X, y,
                               steps=args.steps).state, X, y)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    for k, steps in ((1, args.steps), (args.cadence, args.cadence_steps)):
        progs = {name: wl.bind(make_grid(args.lanes, device=dev), X, y)
                 for name in tables}

        def fit(name, progs=progs, steps=steps, k=k):
            with block_table(tables[name]):
                return progs[name].fit(steps=steps, merge_every=k)

        rates = turns({name: functools.partial(fit, name)
                       for name in tables}, steps, TUNE_FITS, dev)
        states = {name: fit(name).state for name in tables}
        acc = {name: accuracy(s, X, y) for name, s in states.items()}
        require(abs(acc["tuned"] - acc_ref) <= 0.01, f"tuned LogReg at "
                f"cadence {k}: accuracy {acc['tuned']} not within 0.01 of "
                f"fp32 {acc_ref}")
        out[f"logreg int8 lut, cadence {k}"] = {
            "steps_per_s": rates, "accuracy": acc, "accuracy_fp32": acc_ref,
            "bit_equal": bool(torch.equal(states["tuned"],
                                          states["heuristic"]))}
        del progs, states
    del X, y, grid

    kk, iters = args.km_clusters, args.km_iters
    Xk, _, _ = datasets.blobs(gen, args.rows, args.km_features, kk)
    grid = make_grid(args.lanes, device=dev)
    sse_ref = api.fit(KMeans(k=kk), grid, Xk, None, steps=iters).eval(
        Xk)["sse"]
    km = KMeans(k=kk, precision="int16")
    progs = {name: km.bind(make_grid(args.lanes, device=dev), Xk, None)
             for name in tables}

    def km_fit(name):
        with block_table(tables[name]):
            return progs[name].fit(steps=iters)

    rates = turns({name: functools.partial(km_fit, name) for name in tables},
                  iters, TUNE_FITS, dev)
    sse = {name: km_fit(name).eval(Xk)["sse"] for name in tables}
    require(sse["tuned"] <= 1.05 * sse_ref, f"tuned K-means SSE "
            f"{sse['tuned']} above 1.05 x fp32 {sse_ref}")
    out["kmeans int16"] = {"iterations_per_s": rates, "eval_sse": sse,
                           "eval_sse_fp32": sse_ref}
    del Xk, progs, grid

    Xt, yt = datasets.mixture_classification(gen, args.rows,
                                             args.dt_features,
                                             args.dt_classes)
    tree = DecisionTree(max_depth=args.dt_depth, n_bins=args.dt_bins,
                        n_classes=args.dt_classes)
    grids = {name: make_grid(args.lanes, device=dev) for name in tables}

    def tree_fit(name):
        with block_table(tables[name]):
            return api.fit(tree, grids[name], Xt, yt, steps=tree.max_depth)

    rates = turns({name: functools.partial(tree_fit, name)
                   for name in tables}, 1, TUNE_FITS, dev)
    states = {name: tree_fit(name).state for name in tables}
    equal = {f: bool(torch.equal(getattr(states["tuned"], f),
                                 getattr(states["heuristic"], f)))
             for f in ("feature", "threshold", "leaf_value", "bin_edges")}
    require(all(equal.values()), f"tuned tree != the heuristic's: {equal}")
    out["dtree"] = {"seconds_per_tree": {
        name: {"median": 1.0 / r["median"], "min": 1.0 / r["max"],
               "max": 1.0 / r["min"], "trees": r["fits"]}
        for name, r in rates.items()}, "equal_to_heuristic": equal}
    emit("autotune_turns", card=card, **out)
    return out


def autotune_phase(args, dev, card: str) -> dict:
    """Phase 15b: the launch layouts measured, stored under a temp table
    only (``$REPRO_TORCH_AUTOTUNE_CACHE`` points there for the whole
    phase, then back), and the main path timed under the tuned table
    against the heuristic, in turns.  Returns, per tuned kernel, each
    case's winner and its and the heuristic's ms."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    tables = {"tuned": os.path.join(tmp, "tuned.json"),
              "heuristic": os.path.join(tmp, "none.json")}
    try:
        with block_table(tables["tuned"]):
            sweeps = tune_sweeps(args, dev)
            emit("autotune", card=card, table=tables["tuned"],
                 entries=sorted(at._load_cache()), **sweeps)
        turned = tuned_turns(args, dev, card, tables)
        require(not os.path.exists(tables["heuristic"]),
                "the heuristic's table was written")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("autotune", seconds=time.perf_counter() - t0,
         default_table_untouched=not os.path.exists(at.cache_path())
         or os.path.getmtime(at.cache_path()) < t0, turns=list(turned))
    return {kernel: [{key: s[key] for key in ("case", "winner", "winner_ms",
                                             "heuristic", "heuristic_ms")}
                     for s in cases] for kernel, cases in sweeps.items()}


def ops_phase(args, dev) -> dict:
    """Phase 15c: each ``kernels.ops`` entry point on the device against
    its plain version: ``fxp_matmul`` equal to ``a.int() @ b.int()`` bit
    for bit (K over several chunks and N over one launch's 16 columns
    too), ``split_hist`` and ``lut_activation`` bit for bit,
    ``kmeans_assign``'s counts bit for bit and sums within KM_REL_TOL of
    their mass, ``flash_attention`` within FLASH_TOL."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 60)
    out: dict = {"fxp_matmul": []}
    for M, K, N in ((args.rows // args.lanes, args.features, TUNE_CLASSES),
                    (1000, 9000, 19), (333, 4097, 1)):
        a = rand_int(gen, (M, K), -128, 128, torch.int8)
        b = rand_int(gen, (K, N), -128, 128, torch.int8)
        got = ops.fxp_matmul(a, b)
        want = a.cpu().int() @ b.cpu().int()
        equal = got.dtype == torch.int32 and bool(torch.equal(got.cpu(),
                                                              want))
        require(equal, f"ops.fxp_matmul ({M}, {K}) x ({K}, {N}) != the "
                "int32 product")
        out["fxp_matmul"].append({"M": M, "K": K, "N": N, "equal": equal})
    N, D, K = args.rows // args.lanes, args.km_features, args.km_clusters
    x = torch.randn((N, D), generator=gen, device=dev) * 2
    c = x[:K].clone()
    got = ops.kmeans_assign(x, c)
    want = ref.kmeans_assign_ref(x[None], c, torch.ones((1, N), device=dev),
                                 return_assign=True)
    onehot = (want[3][0].long()[:, None] == torch.arange(K, device=dev)
              ).double()
    mass = onehot.T @ x.abs().double()
    sums_err = float(((got[0].double() - want[0][0].double()).abs()
                      / (mass + 1e-30)).max())
    require(bool(torch.equal(got[1], want[1][0])) and sums_err <= KM_REL_TOL,
            f"ops.kmeans_assign off its plain version ({sums_err})")
    out["kmeans_assign"] = {"N": N, "D": D, "K": K,
                            "sums_err_over_mass": sums_err}
    F, bins, classes, nodes = args.dt_features, args.dt_bins, \
        args.dt_classes, 8
    node = rand_int(gen, (N,), 0, nodes, torch.int32)
    xbin = rand_int(gen, (N, F), 0, bins, torch.uint8)
    yy = rand_int(gen, (N,), 0, classes, torch.int32)
    kw = {"n_nodes": nodes, "n_bins": bins, "n_classes": classes}
    H = ops.split_hist(node, xbin, yy, **kw)
    require(bool(torch.equal(H, ref.split_hist_ref(
        node[None], xbin[None], yy[None], torch.ones((1, N), device=dev),
        **kw)[0])), "ops.split_hist != its plain version")
    out["split_hist"] = {"N": N, "F": F, **kw, "equal": True}
    table = lut_mod.sigmoid_lut(device=dev)
    z = torch.randn((64, 1000), generator=gen, device=dev) * 6
    require(bool(torch.equal(
        ops.lut_activation(z.T, table.table, x_min=table.x_min,
                           x_max=table.x_max),
        ref.lut_activation_ref(z.T.contiguous(), table.table, table.x_min,
                               table.x_max))),
        "ops.lut_activation != its plain version")
    out["lut_activation"] = {"shape": [1000, 64], "equal": True}
    out["flash_attention"] = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(gen, 2, 8, 2, 512, 64, dtype)
        got = ops.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        atol, rtol = FLASH_TOL[dtype]
        err = (got.double() - want.double()).abs()
        require(bool((err <= atol + rtol * want.double().abs()).all()),
                f"ops.flash_attention {dtype} off its plain version")
        out["flash_attention"].append({"dtype": str(dtype)[6:],
                                       "max_abs_err": float(err.max())})
    emit("ops", **out)
    return out


def predict(name, wl, state, requests, launches: dict,
            check_counts: bool) -> None:
    """Requests of 1, 7 and 512 rows through ``Workload.predict``, equal
    to the plain path, with the launches each request implies."""
    results = []
    for n in (1, 7, 512):
        rows = requests[:n]
        reset_counts()
        got = wl.predict(state, rows)
        seen = counts()
        if check_counts:
            require(seen == launches, f"{name} predict({n}) launched {seen}")
        with dispatch.use_kernels(False):
            want = wl.predict(state, rows)
        equal = bool(torch.equal(got, want))
        results.append({"rows": n, "launches": seen, "equal": equal,
                        "mean": float(got.float().mean())})
        require(got.shape == (n,) and bool(torch.isfinite(got).all()),
                f"{name} predict({n}) gave {tuple(got.shape)} or "
                "non-finite")
        require(equal, f"{name} predict({n}) != its plain twin")
    emit("predict", workload=name, requests=results)


def pad_invariance(state: torch.Tensor, requests: torch.Tensor) -> list:
    """The fp32 predicts of 7 request rows, alone and padded with 9 zero
    rows, bit for bit on the card (cuBLAS chooses its kernel by shape;
    the fp32 predict sums each row on its own)."""
    rows = requests[:7]
    padded = torch.cat([rows, rows.new_zeros((9, rows.shape[1]))])
    W = torch.stack([state, -state, 0.5 * state, state.flip(0)], dim=1)
    out = []
    for name, wl, st in (("logreg", LogReg(lr=0.5), state),
                         ("svm", LinearSVM(), state),
                         ("linreg", LinReg(), state),
                         ("multinomial C=4", MultinomialLogReg(n_classes=4),
                          W)):
        got, pad = wl.predict(st, rows), wl.predict(st, padded)[:7]
        equal = bool(torch.equal(got, pad))
        out.append({"workload": f"{name} fp32", "rows": 7, "padded_to": 16,
                    "equal": equal})
        require(equal, f"{name} fp32 predict of 7 rows moved when padded "
                "to 16")
    return out


# -- phase 5b: serving the trained main path (serving/) ----------------------


def held_out(args, dev, w_true: torch.Tensor) -> tuple:
    """Labelled rows the fit never saw, drawn from the main path's own
    logistic model (``binary_classification``'s law) from ``--seed``."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 400)
    X = torch.randn((SERVE_PIM_HELD_OUT, args.features), generator=gen,
                    device=dev)
    p = torch.sigmoid(X @ w_true)
    y = (torch.rand((SERVE_PIM_HELD_OUT,), generator=gen, device=dev)
         < p).float()
    return X, y


def serve_configs(args, dev, wl, state, X) -> dict:
    """The served configurations: ``name -> (workload, state, rows)``.
    The main path's trained state (and its fp32 + exact twin); the other
    workloads at their trained shapes with states from ``--seed``
    (serving's bits and time do not depend on the values)."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 500)
    d, kd, k = args.features, args.km_features, args.km_clusters

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"logreg int8 lut": (wl, state, X),
           "logreg fp32 exact": (LogReg(lr=0.5), state, X),
           "linreg int8": (LinReg(lr=0.1, precision="int8"), rand(d), X),
           "svm int8": (LinearSVM(precision="int8"), rand(d), X)}
    for C in MN_CLASSES:
        out[f"multinomial int8 lut C={C}"] = (
            MultinomialLogReg(n_classes=C, lr=0.5, precision="int8",
                              softmax="lut"), 0.3 * rand(d, C), X)
    out["kmeans int16"] = (KMeans(k=k, precision="int16"), rand(k, kd),
                           rand(SERVE_PIM_HELD_OUT, kd))
    return out


def km_tie_free(wl, centroids: torch.Tensor, rows: torch.Tensor):
    """The rows whose two nearest centroids are more than ``KM_NEAR_TIE``
    apart (squared, in float64), on the rows ``predict`` sees (int16:
    quantized on the request's own grid and dequantized)."""
    if wl.precision != "fp32":
        q = qz.quantize_symmetric(rows, bits=16, axis=0)
        rows = q.values.float() * q.scale
    d2 = ((rows.double()[:, None] - centroids.double()[None]) ** 2).sum(-1)
    two = torch.topk(d2, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) > KM_NEAR_TIE


def served_equal(wl, state, rows, got, want) -> bool:
    """A runner's output against the eager predict: bit for bit; K-means
    labels off the near-ties.  In a rehearsal on the CPU within 1e-6 x
    max|want|: the CPU's vectorised exp rounds the elements past a
    tensor's last full vector otherwise than its vector lanes do, and a
    padded request moves elements across that boundary."""
    if got.shape != want.shape:
        return False
    if isinstance(wl, KMeans):
        keep = km_tie_free(wl, state, rows)
        return bool(torch.equal(got[keep], want[keep]))
    if state.device.type == "cpu":
        return bool(torch.allclose(got.cpu(), want.cpu(), rtol=0, atol=1e-6
                                   * float(want.abs().max())))
    return bool(torch.equal(got, want))


def serve_ladder(name, runner, wl, state, rows) -> dict:
    """(b): requests of every ``SERVE_PIM_SIZES`` size, from the card and
    from the host (pinned staging), against the eager ``predict`` on the
    unpadded rows with ``use_kernels(False)``: on each chunk of an
    oversize request, as the runner splits it (a quantized request takes
    its scales over its own rows)."""
    sizes = {}
    top = runner.buckets[-1]
    for n in SERVE_PIM_SIZES:
        Xn = rows[:n]
        with dispatch.use_kernels(False):
            want = torch.cat([wl.predict(state, Xn[i:i + top])
                              for i in range(0, n, top)])
        for src, req in (("card", Xn), ("host", Xn.cpu().numpy())):
            got = runner.predict(req)
            require(bool(torch.isfinite(got.float()).all()),
                    f"serve {name}: predict({n}, {src}) not finite")
            require(served_equal(wl, state, Xn, got, want),
                    f"serve {name}: predict({n}) from the {src} != the "
                    "eager predict")
        sizes[n] = "equal"
    return sizes


def replay_profile(runner, rows_host: np.ndarray, dev) -> dict:
    """(c): ``SERVE_PIM_REPLAYS`` calls of each bucket from host rows: the
    port's kernels they launched, counted from the bucket graph's kernel
    nodes times its replays (:func:`launches_since`; a replay runs no
    Python, so the wrappers' counters cannot see it), and, by
    ``torch.profiler``, every kernel and the host-to-device copies by
    kind, as the device saw them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    patterns = {"fxp_matmul": GRAPH_KERNELS["fxp_matmul"],
                "lut_activation": GRAPH_KERNELS["lut_activation"]}
    out = {}
    for b in runner.buckets:
        X = rows_host[:b]
        runner.predict(X)
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            snap = graph_snapshot()
            for _ in range(SERVE_PIM_REPLAYS):
                runner.predict(X)
            sync(dev)
            nodes = launches_since(snap, patterns)
        seen = {"fxp": nodes["fxp_matmul"], "lut": nodes["lut_activation"],
                "pinned_h2d": 0, "pageable_h2d": 0, "kernels": 0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            seen["kernels"] += e.count
            if "HtoD" in e.key and "Pageable" in e.key:
                seen["pageable_h2d"] += e.count
            elif "HtoD" in e.key:
                seen["pinned_h2d"] += e.count
        out[b] = seen
    return out


def expected_replay(wl) -> dict:
    """A bucket call's launches of the port's kernels."""
    quantized = not isinstance(wl, KMeans) and wl.precision != "fp32"
    n_cols = getattr(wl, "n_classes", 1)
    lut = getattr(wl, "sigmoid", getattr(wl, "softmax", "")) == "lut"
    return {"fxp": dispatch.hybrid_launches(n_cols) if quantized else 0,
            "lut": int(lut)}


def serve_rates(runner, wl, state, rows_host: np.ndarray, dev) -> dict:
    """(d): rows/s of ``run_stream`` against the eager ``predict`` loop on
    the same host batches (top bucket and 8 rows), median of
    ``TIMING_RUNS`` in turns; one 8-row request's latency to the host,
    graph against eager, in turns; the idle share of a profiled
    ``run_stream``."""
    top = runner.buckets[-1]
    feeds = {
        f"{top}-row batches": [rows_host[(i * top) % len(rows_host):][:top]
                               for i in range(SERVE_PIM_TOP_BATCHES)],
        "8-row batches": [rows_host[(i * 8) % len(rows_host):][:8]
                          for i in range(SERVE_PIM_SMALL_BATCHES)]}
    out = {}
    for label, feed in feeds.items():
        def graph():
            for _ in runner.run_stream(feed):
                pass
            sync(dev)

        def eager():
            for X in feed:
                wl.predict(state, X)
            sync(dev)

        rows = sum(len(X) for X in feed)
        graph()
        eager()
        rates = {"graph": [], "eager": []}
        for i in range(TIMING_RUNS):
            for name in (("graph", "eager") if i % 2 == 0
                         else ("eager", "graph")):
                t0 = time.perf_counter()
                (graph if name == "graph" else eager)()
                rates[name].append(rows / (time.perf_counter() - t0))
        out[label] = {name: {"median_rows_per_s": statistics.median(r),
                             "min": min(r), "max": max(r)}
                      for name, r in rates.items()}
        out[label]["graph_over_eager"] = (
            out[label]["graph"]["median_rows_per_s"]
            / out[label]["eager"]["median_rows_per_s"])
        if dev.type == "cuda":
            out[label]["profile"] = profile_call(graph, dev)
    x8 = rows_host[:8]
    lat = {"graph": [], "eager": []}
    for i in range(SERVE_PIM_LATENCY_CALLS):
        for name in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            t0 = time.perf_counter()
            if name == "graph":
                runner.predict(x8).cpu()
            else:
                wl.predict(state, x8).cpu()
            lat[name].append((time.perf_counter() - t0) * 1e3)
    out["8-row latency"] = {name: {"median_ms": statistics.median(v),
                                   "p99_ms": float(np.percentile(v, 99))}
                            for name, v in lat.items()}
    return out


def serve_queue(runner, rows_host: np.ndarray) -> dict:
    """(e): open-loop bursts of single-row requests through a
    ``MicroBatchQueue`` at each offered rate, the warm heap frozen as
    ``launch.serve`` freezes it: tickets, served requests/s, p50, p99,
    the mean batch."""
    out = {}
    for rate in SERVE_PIM_RATES:
        q = MicroBatchQueue(runner, max_batch=SERVE_PIM_MAX_BATCH,
                            max_wait_ms=SERVE_PIM_MAX_WAIT_MS)
        with serve_cli.frozen_heap():
            tickets, seconds = serve_cli.open_loop(q, rows_host,
                                                   SERVE_PIM_HELD_OUT, rate)
        q.close()
        st = q.stats()
        out[rate] = {"tickets": tickets, "served_per_s":
                     st["requests"] / seconds, "p50_ms": st["p50_ms"],
                     "p99_ms": st["p99_ms"], "mean_batch": st["mean_batch"],
                     "batches": st["batches"]}
    return out


def serve_registry(args, dev, wl, grid, rows, rows_host, base: str
                   ) -> dict:
    """(f): ``Trainer.for_program`` on the main path (cadence 8, a
    checkpoint every 8 steps, the v2 layout), ``refresh()`` to its newest
    step bit-equal to the eager predict on the trainer's state, two
    publishes while the queue serves, and a torn newest step skipped."""
    program, X, y = ckpt_program(args, dev)
    del X, y
    d = args.features
    tr = Trainer.for_program(program, TrainerConfig(
        ckpt_dir=base, ckpt_every=SERVE_PIM_CKPT_EVERY,
        log_every=SERVE_PIM_CKPT_EVERY, merge_every=args.cadence,
        ckpt_keep=1000))
    tr.run(SERVE_PIM_TRAIN_STEPS)
    tr.ckpt.wait()
    steps = tr.ckpt.steps()
    del program
    require(len(steps) >= 3, f"serve registry: checkpoints {steps}")
    reg = ModelRegistry(wl, torch.zeros(d, device=dev), ckpt_dir=base,
                        grid=grid)
    newest = reg.refresh()
    require(newest == steps[-1], f"serve registry: refresh() published "
            f"{newest}, the newest step is {steps[-1]}")
    runner = reg.current()[1]
    with dispatch.use_kernels(False):
        want = wl.predict(tr.state, rows[:512])
    equal = (bool(torch.equal(runner.state, tr.state))
             and bool(torch.equal(runner.predict(rows[:512]), want)))
    require(equal, "serve registry: the refreshed model != the trainer's")

    older = steps[-3]
    published = [runner]
    q = MicroBatchQueue(reg, max_batch=SERVE_PIM_MAX_BATCH,
                        max_wait_ms=SERVE_PIM_MAX_WAIT_MS)
    span = SERVE_PIM_SWAP_REQUESTS / SERVE_PIM_SWAP_RATE

    def swaps():
        time.sleep(span / 3)
        published.append(reg.load_step(older))
        time.sleep(span / 3)
        published.append(reg.load_step(newest))

    swapper = threading.Thread(target=swaps)
    with serve_cli.frozen_heap():
        swapper.start()
        tickets, seconds = serve_cli.open_loop(q, rows_host,
                                               SERVE_PIM_SWAP_REQUESTS,
                                               SERVE_PIM_SWAP_RATE)
        swapper.join()
    q.close()
    versions = {}
    for t in tickets:
        versions[t.version] = versions.get(t.version, 0) + 1
    captures = [r.compile_misses for r in published]
    require(len(tickets) == SERVE_PIM_SWAP_REQUESTS
            and all(t.result is not None for t in tickets),
            "serve registry: a ticket was lost across the swaps")
    require(set(versions) <= {older, newest}, f"serve registry: versions "
            f"{sorted(versions)} beyond the published {older}, {newest}")
    require(captures == [0] * len(published), f"serve registry: the swaps "
            f"captured {captures}")

    with open(os.path.join(reg._mgr._step_path(newest), "arrays.npz"),
              "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff\xff\xff")
    torn = ModelRegistry(wl, torch.zeros(d, device=dev), ckpt_dir=base,
                         grid=grid)
    skipped_to = torn.refresh()
    require(skipped_to == steps[-2], f"serve registry: with step {newest} "
            f"torn, refresh() published {skipped_to}, not {steps[-2]}")
    return {"checkpoints": steps, "refreshed": newest,
            "bit_equal_to_trainer": equal, "swaps": [older, newest],
            "tickets": len(tickets), "versions_served": versions,
            "served_per_s": len(tickets) / seconds,
            "swap_captures": captures, "torn_step": newest,
            "refresh_after_tear": skipped_to}


def serve_pim(args, dev, card: str, wl, state, w_true) -> None:
    """The trained main path (and the other device workloads) served on
    the card: (a) the models, (b) the ladder, (c) counters and the
    replays' launches, (d) rates and latency, (e) the queue, (f) the
    registry, (g) the CLI."""
    import io
    import shutil

    check = not args.rehearse
    t0 = time.perf_counter()
    X, y = held_out(args, dev, w_true)
    X_host, y_host = X.cpu().numpy(), y.cpu().numpy()
    grid = make_grid(args.lanes, device=dev)
    configs = serve_configs(args, dev, wl, state, X)
    runners, ladder, replays = {}, {}, {}
    for name, (swl, st, rows) in configs.items():
        r = PredictRunner(swl, st, grid=grid)
        r.warmup(rows.shape[1])
        require(r.compile_misses == len(r.buckets), f"serve {name}: warmup "
                f"captured {r.compile_misses}, not {len(r.buckets)}")
        runners[name] = r
        ladder[name] = serve_ladder(name, r, swl, st, rows)
        if dev.type == "cuda":
            replays[name] = replay_profile(r, rows.cpu().numpy(), dev)
            want = expected_replay(swl)
            for b, seen in replays[name].items():
                if check:
                    require(seen["fxp"] == want["fxp"] * SERVE_PIM_REPLAYS
                            and seen["lut"] == want["lut"]
                            * SERVE_PIM_REPLAYS, f"serve {name}: "
                            f"{SERVE_PIM_REPLAYS} replays of bucket {b} "
                            f"launched {seen}, the design implies {want} "
                            "a call")
                require(seen["pageable_h2d"] == 0, f"serve {name}: bucket "
                        f"{b} copied from pageable host memory: {seen}")
    emit("serve_pim", part="ladder", card=card, configs={
        name: {"buckets": list(runners[name].buckets),
               "features": rows.shape[1], "state": list(st.shape),
               "sizes": ladder[name], "replays_per_bucket": replays.get(
                   name, "not measured (no card)"),
               "expected_per_call": expected_replay(swl)}
        for name, (swl, st, rows) in configs.items()})

    main = runners["logreg int8 lut"]
    twin_state = state.flip(0)
    twin = PredictRunner(LogReg(lr=0.5, precision="int8", sigmoid="lut"),
                         twin_state, grid=grid)
    twin.warmup(args.features)
    with dispatch.use_kernels(False):
        want = wl.predict(twin_state, X[:100])
    twin_ok = bool(torch.equal(twin.predict(X[:100]), want))
    require(twin.compile_misses == 0, f"serve: an equal configuration "
            f"captured {twin.compile_misses} graphs")
    require(twin_ok, "serve: the second runner's output is not its own "
            "state's")
    # fits on this grid capture their chunk runners into its cache beside
    # the bucket graphs: more runners than a kind's budget evict none of
    # the server's entries (merge_plan.cache_put: a budget a kind)
    rows = args.lanes * 16
    for i in range(mp._CACHE_MAX + 8):
        api.fit(LinReg(lr=0.01 + 1e-3 * i), grid, X[:rows], y[:rows],
                steps=2)
    kinds = [key[0] for key in grid._tuning_cache]
    beside = {"fits": mp._CACHE_MAX + 8,
              "fit_runners_held": kinds.count("fit_runner"),
              "bucket_graphs_held": kinds.count("serving")}
    require(beside["bucket_graphs_held"] == sum(
        len(r.buckets) for r in runners.values()), f"serve: fits beside the "
        f"server evicted bucket graphs: {beside}")

    rates = serve_rates(main, wl, state, X_host, dev)
    emit("serve_pim", part="rates", card=card, workload="logreg int8 lut",
         features=args.features, fits_beside=beside, **rates)

    fp32 = runners["logreg fp32 exact"]
    fwl = configs["logreg fp32 exact"][0]
    eager_fp32 = fwl.predict(state, X).cpu().numpy()
    queue = {}
    for name, r in (("logreg fp32 exact", fp32), ("logreg int8 lut", main)):
        bursts = serve_queue(r, X_host)
        for rate, b in bursts.items():
            got = np.stack([t.result for t in b.pop("tickets")])
            b["accuracy"] = float(((got > 0.5) == (y_host > 0.5)).mean())
            if name == "logreg fp32 exact":
                b["equal_to_eager"] = served_equal(
                    fwl, state, X, torch.from_numpy(got),
                    torch.from_numpy(eager_fp32))
                require(b["equal_to_eager"], f"serve queue: fp32 tickets "
                        f"at {rate}/s != the eager predict")
        queue[name] = bursts
    for rate in SERVE_PIM_RATES:
        gap = abs(queue["logreg int8 lut"][rate]["accuracy"]
                  - queue["logreg fp32 exact"][rate]["accuracy"])
        require(gap <= PLAN_ACC_TOL, f"serve queue at {rate}/s: int8 + LUT "
                f"accuracy {gap} from fp32 + exact's")

    base = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        registry = serve_registry(args, dev, wl, grid, X, X_host, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--workload", "linreg", "--precision", "int8",
                        "--requests", "512", "--rate", "2000",
                        "--device", str(dev)])
    cli = buf.getvalue().strip().splitlines()[-1]
    require(cli.startswith("linreg/int8: 512 requests")
            and cli.endswith("(steady 0)"), f"serve CLI: {cli!r}")

    steady = {name: r.counters() for name, r in runners.items()}
    require(all(c["steady_compile_misses"] == 0 for c in steady.values()),
            f"serve: steady-state captures {steady}")
    emit("serve_pim", part="queue, registry, cli", card=card,
         max_batch=SERVE_PIM_MAX_BATCH, max_wait_ms=SERVE_PIM_MAX_WAIT_MS,
         burst=SERVE_PIM_HELD_OUT, queue=queue,
         registry=registry,
         second_runner={"captures": twin.compile_misses,
                        "own_results": twin_ok},
         counters=steady, cli=cli,
         grid_cache_entries=len(grid._tuning_cache),
         seconds=time.perf_counter() - t0)


# -- phase 6: the serving path ----------------------------------------------


def flash_inputs(gen, B, H, Kh, S, D, dtype) -> tuple:
    """q, k, v as the model hands them over: (B, H, S, D) views of
    (B, S, H, D) tensors."""
    return tuple(torch.randn((B, S, h, D), generator=gen, device=gen.device
                             ).to(dtype).transpose(1, 2) for h in (H, Kh, Kh))


def flash_check(name, q, k, v, causal) -> dict:
    """flash_attention against its plain version within FLASH_TOL (bf16:
    and at least FLASH_BIT_EQUAL of the outputs bit-equal), and a second
    launch bit-equal."""
    got = flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    atol, rtol = FLASH_TOL[q.dtype]
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    share = float((got == want).double().mean())
    if q.dtype == torch.bfloat16:
        ok = ok and share >= FLASH_BIT_EQUAL
    out = {"case": name, "q": list(q.shape), "k": list(k.shape),
           "dtype": str(q.dtype)[6:], "causal": causal,
           "kernel": route(q.dtype, q.shape[-1]),
           "max_abs_err": float(err.max()), "bit_equal_share": share,
           "within_tolerance": ok,
           "deterministic": bool(torch.equal(got, again)),
           "finite": bool(torch.isfinite(got).all())}
    require(ok and out["finite"], f"flash_attention != plain version: {out}")
    require(out["deterministic"], f"flash_attention not deterministic: "
            f"{name}")
    return out


def compare_flash(gen, seq: int, slice_cases: dict) -> list:
    """At qwen2-0.5b's prefill shape, ragged S, the smoke config's D = 32,
    MQA at D = 128 without the causal mask, whisper-tiny's encoder and
    llava's and the MoE backbones, phi3.5-moe's training step included
    (``slice_cases``: each bf16 case on ``wgmma``; qwen3-moe's GQA group
    of 16), and
    q, k, v sliced from one packed (B, S, H + 2 Kh, D) tensor; in bf16
    and float32."""
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, causal in (
                ("qwen2 prefill", (LM_BATCH, 14, 2, seq, 64), True),
                ("ragged S", (2, 14, 2, 1000, 64), True),
                ("smoke heads, D=32", (2, 2, 1, 128, 32), True),
                ("MQA, D=128, full", (1, 8, 1, 512, 128), False),
                *((name, shape, causal)
                  for name, (shape, causal) in slice_cases.items())):
            out.append(flash_check(name, *flash_inputs(gen, *shape, dtype),
                                   causal))
            if dtype == torch.bfloat16 and name in slice_cases:
                require(out[-1]["kernel"] == "wgmma",
                        f"flash_attention took {out[-1]['kernel']} at "
                        f"{shape}")
        packed = torch.randn((2, 300, 18, 64), generator=gen,
                             device=gen.device).to(dtype).transpose(1, 2)
        out.append(flash_check("packed (B, S, H, D) view", packed[:, :14],
                               packed[:, 14:16], packed[:, 16:], True))
    return out


def sdpa(q, k, v, causal: bool = True):
    """PyTorch's fused attention on the same views: the yardstick of
    ``library_ms``, never called by the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def time_flash(gen, seq: int, iters: int) -> dict:
    """One layer's attention in qwen2-0.5b's bf16 prefill.  ops: the
    causal q·kᵀ once and p·v as two bf16 products (p's hi and lo terms),
    6·D per (query, key) pair with key <= query, at the bf16 peak (p·v in
    float32 at the TF32 peak gives the same time)."""
    dev = gen.device
    B, H, Kh, D = LM_BATCH, 14, 2, 64
    q, k, v = flash_inputs(gen, B, H, Kh, seq, D, torch.bfloat16)
    check = flash_check("timed shapes", q, k, v, True)
    o = flash_attention(q, k, v)
    qf, kf, vf = (x.float() for x in (q, k, v))
    lib_err = max_abs_err(sdpa(qf, kf, vf), o)
    t = {"ms": median_ms(lambda: flash_attention(q, k, v), dev, iters),
         "single_call_ms": single_call_ms(lambda: flash_attention(q, k, v),
                                          dev, iters),
         "plain_ms": median_ms(lambda: ref.flash_attention_ref(q, k, v),
                               dev, max(1, iters // 5)),
         "library_ms": median_ms(lambda: sdpa(qf, kf, vf), dev, iters),
         "library_bf16_ms": median_ms(lambda: sdpa(q, k, v), dev, iters),
         "library_max_abs_err": lib_err,
         "bytes": nbytes(q, k, v, o),
         "ops": 6 * B * H * D * seq * (seq + 1) // 2,
         "max_abs_err": check["max_abs_err"],
         "bit_equal_share": check["bit_equal_share"]}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_BF16)
    t["float32_ms"] = median_ms(lambda: flash_attention(qf, kf, vf), dev,
                                max(1, iters // 5))
    return t


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max|got - want| and that over max|want|, on the vocabulary."""
    gap = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    return {"max_abs_gap": gap, "max_abs_logit": top,
            "gap_over_max": gap / max(top, 1e-30)}


def timed_prefill(model, params, batch: dict) -> float:
    sync(model.device)
    t0 = time.perf_counter()
    model.prefill(params, batch)
    sync(model.device)
    return time.perf_counter() - t0


def decode_cache(model, params, batch: int, max_len: int, frames=None):
    """``Model.init_cache``, with an encoder-decoder's cross K/V built
    from ``frames`` (``encdec_build_cross``, in place)."""
    cache = model.init_cache(batch, max_len)
    if frames is not None:
        encdec_build_cross(model.cfg, params, frames, cache)
    return cache


def eager_generate(model, params, prompts: torch.Tensor,
                   new_tokens: int, frames=None) -> Generation:
    """``generate`` on the eager decode: ``Model.decode_step`` called a
    step at a time, ``pos`` a tensor stepped on the card, the argmax
    taken after each step, the same clocks (an encoder-decoder's cross
    K/V built before them, as ``generate`` builds it)."""
    B, P = prompts.shape
    V, dev = model.cfg.vocab_size, model.device
    cache = decode_cache(model, params, B, P + new_tokens, frames)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = model.decode_step(params, cache,
                                          prompts[:, t:t + 1], pos)
        pos += 1
    prompt_logits = logits[:, -1].clone()
    sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = model.decode_step(params, cache, tok, pos)
        pos += 1
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]
        out.append(tok)
    sync(dev)
    return Generation(torch.cat(out, dim=1), prompt_logits, prefill_s,
                      time.perf_counter() - t0)


def decode_graph(model, params, prompts: torch.Tensor, new_tokens: int,
                 dev, check: bool, runs: int = TIMING_RUNS,
                 n: int = 8, frames=None, routes: list | None = None
                 ) -> dict:
    """The captured decode step (``launch.serve_lm.DecodeStep``) against
    the eager decode: every step's logits and token compared in lockstep,
    bit for bit (the tokens must be equal); decode tokens/s of
    ``generate`` against :func:`eager_generate` in ``runs`` turns, their
    tokens equal; the idle share
    and the host's CUDA launch calls a token over ``n`` decode tokens of
    each.  An encoder-decoder decodes over ``frames``, its cross K/V
    built after each reset of the step and into each eager cache.
    ``routes``, where given, gets the MoE routes (``moe.log_routes``) of
    the lockstep's eager decode steps."""
    B, P = prompts.shape
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    step = DecodeStep(model, params, B, P + new_tokens)
    sync(dev)
    capture_s = time.perf_counter() - t0

    def reset():
        step.reset()
        if frames is not None:
            encdec_build_cross(model.cfg, params, frames, step.cache)

    reset()
    cache = decode_cache(model, params, B, P + new_tokens, frames)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    tok = None
    logits_equal, tokens_equal, gap, first_diff = True, True, 0.0, None
    for t in range(P + new_tokens - 1):
        given = prompts[:, t:t + 1] if t < P else tok
        with moe.log_routes() as log:
            logits, cache = model.decode_step(params, cache, given, pos)
        if routes is not None:
            routes.extend(log)
        pos += 1
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]
        got = step(prompts[:, t:t + 1] if t < P else None)
        if not torch.equal(got, logits):
            logits_equal = False
            first_diff = t if first_diff is None else first_diff
            gap = max(gap, float((got.float() - logits.float()).abs().max()))
        tokens_equal = tokens_equal and bool(torch.equal(step.tok, tok))
    require(tokens_equal, "the captured decode step's tokens != the eager "
            "decode's")
    rates: dict = {"graph": [], "eager": []}
    tokens = {}
    for i in range(runs):
        for name in (("graph", "eager") if i % 2 == 0
                     else ("eager", "graph")):
            fn = generate if name == "graph" else eager_generate
            res = fn(model, params, prompts, new_tokens, frames)
            rates[name].append(B * (new_tokens - 1) / res.decode_s)
            tokens[name] = res.tokens
    require(torch.equal(tokens["graph"], tokens["eager"]), "generate's "
            "tokens != the eager decode's")
    rates = {name: {"median": statistics.median(r), "min": min(r),
                    "max": max(r), "runs": len(r)}
             for name, r in rates.items()}
    reset()
    for t in range(P):
        step(prompts[:, t:t + 1])

    def graph_steps():
        step.pos.fill_(P)
        for _ in range(n):
            step()

    _, prof_graph = device_launches(graph_steps, dev, count_graphs=False)
    cache = decode_cache(model, params, B, P + n, frames)
    pos = torch.full((), P, dtype=torch.int32, device=dev)

    def eager_steps():
        pos.fill_(P)
        tok = prompts[:, :1]
        for _ in range(n):
            logits, _ = model.decode_step(params, cache, tok, pos)
            pos.add_(1)
            tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]

    _, prof_eager = device_launches(eager_steps, dev, count_graphs=False)
    for prof in (prof_graph, prof_eager):
        prof["host_launch_calls_per_token"] = prof["host_launch_calls"] / n
    return {"capture_s": capture_s, "pool_bytes": step.graph.pool_bytes,
            "logits_bit_equal": logits_equal, "tokens_equal": tokens_equal,
            "logits_max_abs_gap": gap, "first_differing_step": first_diff,
            "steps_compared": P + new_tokens - 1,
            "decode_tokens_per_s": rates, "profile_graph": prof_graph,
            "profile_eager": prof_eager}


def serve_lm(args, dev, card: str) -> dict:
    """qwen2-0.5b (the smoke config in a rehearsal): the prefill main path
    with its launch count, twin check, rate and profile; ``generate`` on
    the serving requests; the float32 checks at full width."""
    cfg = (get_smoke_config if args.rehearse else get_config)(LM_ARCH)
    check = not args.rehearse
    V = cfg.vocab_size
    t0 = time.perf_counter()
    with torch.inference_mode():
        model = build_model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 30)
        params = model.init(gen)
        tokens = torch.randint(0, V, (LM_BATCH, args.lm_seq), generator=gen,
                               device=dev)
        prompts = torch.randint(0, V, (SERVE_REQUESTS, SERVE_PROMPT),
                                generator=gen, device=dev)
        sync(dev)
        init_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # the main path: counts set to 0 just before, read just after
        reset_counts()
        logits = model.prefill(params, {"tokens": tokens})
        sync(dev)
        seen = counts()
        want = expected(flash_attention=cfg.n_layers)
        if check:
            require(seen == want, f"prefill launched {seen}, the design "
                    f"implies {want}")
        require(tuple(logits.shape) == (LM_BATCH, 1, padded_vocab(cfg))
                and bool(torch.isfinite(logits).all()),
                f"prefill logits {tuple(logits.shape)} or not finite")
        with dispatch.use_kernels(False):
            twin = model.prefill(params, {"tokens": tokens})
        twin_gap = logits_gap(logits, twin)
        require(twin_gap["gap_over_max"] <= PREFILL_TWIN_TOL[cfg.dtype],
                f"prefill vs its plain twin: {twin_gap}")
        del twin
        times = [timed_prefill(model, params, {"tokens": tokens})
                 for _ in range(LM_RATE_REPS)]
        n_tok = LM_BATCH * args.lm_seq
        prefill = {"batch": LM_BATCH, "seq": args.lm_seq,
                   "launches": seen, "expected_launches": want,
                   "twin": twin_gap,
                   "tokens_per_s": {"median": n_tok / statistics.median(
                       times), "min": n_tok / max(times),
                       "max": n_tok / min(times), "runs": len(times)}}
        if dev.type == "cuda":
            prefill["peak_memory_gib"] = \
                torch.cuda.max_memory_allocated(dev) / 2 ** 30
        emit("profile", workload="prefill", **profile_call(
            lambda: model.prefill(params, {"tokens": tokens}), dev,
            prefills=1))

        # serving: the cache filled by replaying the prompts, then greedy
        generate(model, params, prompts, SERVE_NEW)            # warm-up
        reset_counts()
        res = generate(model, params, prompts, SERVE_NEW)
        seen_serve = counts()
        if check:
            require(seen_serve == expected(), f"generate launched "
                    f"{seen_serve}: decode runs the plain mha")
        require(tuple(res.tokens.shape) == (SERVE_REQUESTS, SERVE_NEW)
                and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < V,
                f"generate gave {tuple(res.tokens.shape)}")
        serve_graph = decode_graph(model, params, prompts, SERVE_NEW, dev,
                                   check)
        cache = model.init_cache(SERVE_REQUESTS, SERVE_PROMPT)
        emit("profile", workload="decode", **profile_call(
            lambda: [model.decode_step(params, cache, prompts[:, t:t + 1], t)
                     for t in range(8)], dev, decode_steps=8,
            requests=SERVE_REQUESTS))
        del cache
        pre = model.prefill(params, {"tokens": prompts})[:, 0]
        serve = {"requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT,
                 "new_tokens": SERVE_NEW, "launches": seen_serve,
                 "replay_tokens_per_s":
                     SERVE_REQUESTS * SERVE_PROMPT / res.prefill_s,
                 "decode_tokens_per_s":
                     SERVE_REQUESTS * (SERVE_NEW - 1) / res.decode_s,
                 "replay_s": res.prefill_s, "decode_s": res.decode_s,
                 "prefill_vs_replay": logits_gap(pre, res.prompt_logits),
                 "first_tokens": res.tokens[0, :8].tolist(),
                 "graph": serve_graph}
        del params, model, logits, pre, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # float32 at full width: the kernel path against its twin and
        # against the replay through decode_step
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = build_model(cfg32, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(
            args.seed + 31))
        reset_counts()
        pre = model.prefill(params, {"tokens": tokens})
        f32_seen = counts()
        if check:
            require(f32_seen == want, f"float32 prefill launched {f32_seen}")
        with dispatch.use_kernels(False):
            twin = model.prefill(params, {"tokens": tokens})
        f32_twin = logits_gap(pre, twin)
        require(f32_twin["gap_over_max"] <= PREFILL_TWIN_TOL["float32"],
                f"float32 prefill vs its plain twin: {f32_twin}")
        del pre, twin
        pre = model.prefill(params, {"tokens": prompts})[:, 0]
        res = generate(model, params, prompts, SERVE_NEW)
        cross = logits_gap(pre, res.prompt_logits)
        require(cross["gap_over_max"] <= CROSS_PATH_TOL,
                f"float32 prefill vs the replay through decode_step: {cross}")
        first = torch.argmax(pre[:, :V], dim=-1)
        top2 = torch.topk(pre[:, :V].float(), 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * cross["max_abs_gap"]
        same = bool(torch.equal(first[clear], res.tokens[clear, 0]))
        require(same, "float32: prefill's greedy token != the replay's where "
                "the top-2 gap exceeds the logit gap")
        float32 = {"launches": f32_seen, "prefill_vs_twin": f32_twin,
                   "prefill_vs_replay": cross,
                   "first_token_equal_where_clear": same,
                   "clear_requests": int(clear.sum())}
    emit("serve_lm", arch=cfg.name, card=card, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         vocab=cfg.vocab_size, dtype=cfg.dtype,
         params=model.param_count(params), init_s=init_s,
         prefill=prefill, serve=serve, float32=float32,
         seconds=time.perf_counter() - t0)
    return seen


# -- train_lm: qwen2-0.5b trained at full width ------------------------------

# the backward against its plain version on the same q, k, v, o, dO and
# lse: float32 within 2e-5 of max|grad| (summation order), bf16 within
# 1e-2 (p and ds rounded once to bf16 as mma operands, where the plain
# version keeps them in float32); max|grad| over dq, dk and dv
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_RESUME_AT = 4, 2048, 20, 10
TRAIN_LR = 3e-4
TRAIN_STEADY_STEPS = 3
# one bf16 step with kernels against use_kernels(False): the loss within
# 1e-2 relative; the gradients' relative L2 gap under 5e-2 (one-ulp
# attention outputs and the backward's bf16 p and ds, re-rounded through
# 24 layers of bf16 activations); float32 at full width, cut to 2 layers
# and 2 x 512 tokens, every leaf within 1e-4 of its max|g| (summation
# order)
TRAIN_TWIN_LOSS_RTOL = 1e-2
TRAIN_TWIN_GRAD_L2 = 5e-2
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 2, 512
TRAIN_F32_TOL = 1e-4
FLASH_FWD_KERNELS = re.compile(r"flash_(wgmma|mma|simt)_kernel")
FLASH_BWD_KERNELS = {"delta": re.compile(r"flash_bwd_delta_kernel"),
                     "dkdv": re.compile(r"flash_bwd_dkdv_\w+?_kernel"),
                     "gsum": re.compile(r"flash_bwd_gsum_kernel"),
                     "dq": re.compile(r"flash_bwd_dq_\w+?_kernel")}
STEP_CLASSES = (("flash_forward", FLASH_FWD_KERNELS),
                ("flash_backward", re.compile(r"flash_bwd_")),
                ("gemm", GEMM_KERNELS),
                ("scans", re.compile(r"scan|cumsum", re.IGNORECASE)),
                ("reductions", re.compile(r"reduce|softmax|logsumexp",
                                          re.IGNORECASE)),
                ("gather_scatter", re.compile(
                    r"gather|scatter|index|embedding|sort", re.IGNORECASE)),
                ("elementwise", re.compile(r"elementwise|vectorized|"
                                           r"unrolled|fill|copy|cat",
                                           re.IGNORECASE)))


def flash_bwd_check(name, q, k, v, causal) -> dict:
    """flash_attention_bwd against its plain version within FLASH_BWD_TOL
    (bf16: the bit-equal share printed), a second launch bit-equal, and
    the forward with lse bit-equal to the forward without it."""
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    fwd_same = bool(torch.equal(o, flash_attention(q, k, v, causal=causal)))
    gen = torch.Generator(device=q.device).manual_seed(q.shape[2])
    do = torch.randn((q.shape[0], q.shape[2], q.shape[1], q.shape[3]),
                     generator=gen, device=q.device).to(q.dtype
                                                        ).transpose(1, 2)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    kernel = bwd_route(q.dtype, q.shape[-1])
    scale = max(float(w.float().abs().max()) for w in want)
    errs = [max_abs_err(g, w) for g, w in zip(got, want)]
    share = (sum(int((g == w).sum()) for g, w in zip(got, want))
             / sum(w.numel() for w in want))
    out = {"case": name, "q": list(q.shape), "k": list(k.shape),
           "dtype": str(q.dtype)[6:], "causal": causal,
           "group": q.shape[1] // k.shape[1], "kernel": kernel,
           "max_abs_err": max(errs), "err_over_max_grad": max(errs) / scale,
           "dq_dk_dv_err": errs, "bit_equal_share": share,
           "forward_with_lse_bit_equal": fwd_same,
           "deterministic": all(torch.equal(a, b)
                                for a, b in zip(got, again)),
           "finite": all(bool(torch.isfinite(g).all()) for g in got)}
    out["within_tolerance"] = out["err_over_max_grad"] <= \
        FLASH_BWD_TOL[q.dtype]
    require(out["within_tolerance"] and out["finite"],
            f"flash_attention_bwd != plain version: {out}")
    require(out["deterministic"] and fwd_same,
            f"flash_attention_bwd not deterministic or the forward with lse "
            f"!= without: {out}")
    return out


def compare_flash_bwd(gen, seq: int, slice_cases: dict) -> list:
    """bf16 and float32; D = 32, 64, 128; G = 1, 2, 7; causal and full; a
    ragged S; qwen2-0.5b's training shape (4 x 14 heads, 2 KV heads,
    ``seq``, D = 64); the wgmma schedule's edges: S = 1, 127, 129 and
    300 (a ragged last 128-key tile), the group sum skipped (G = 1) and
    taken (G = 2, 7); and whisper-tiny's encoder, llava's backbone and
    the MoE backbones at G = 4 and 16, phi3.5-moe's training step
    included (``slice_cases``)."""
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, causal in (
                ("qwen2 training", (TRAIN_BATCH, 14, 2, seq, 64), True),
                ("ragged S, G=7", (2, 14, 2, 1000, 64), True),
                ("full, G=7", (1, 14, 2, 513, 64), False),
                ("D=32, G=1", (2, 4, 4, 300, 32), True),
                ("D=32 full, G=2", (2, 4, 2, 256, 32), False),
                ("D=128, G=2", (1, 8, 4, 700, 128), True),
                ("D=128 full, G=1", (1, 4, 4, 512, 128), False),
                ("S=1, G=1", (2, 2, 2, 1, 64), True),
                ("S=127, G=2", (1, 4, 2, 127, 64), True),
                ("S=129, G=1, D=128", (1, 4, 4, 129, 128), True),
                ("S=129 full, G=7", (1, 7, 1, 129, 64), False),
                ("S=300, G=7", (2, 14, 2, 300, 64), True),
                ("S=300 full, G=2, D=128", (1, 4, 2, 300, 128), False),
                ("S=300, G=1, D=128", (1, 2, 2, 300, 128), True),
                *((name, shape, causal)
                  for name, (shape, causal) in slice_cases.items())):
            out.append(flash_bwd_check(
                name, *flash_inputs(gen, *shape, dtype), causal))
            if dtype == torch.bfloat16 and shape[-1] in (64, 128):
                require(out[-1]["kernel"] == "wgmma",
                        f"the backward took {out[-1]['kernel']} at {shape}")
    return out


def bwd_split(run, dev, calls: int = 5) -> dict:
    """Each backward kernel's device time a launch (``torch.profiler`` over
    ``calls`` warm calls of ``run``): delta, dK/dV, the group sum and dQ.
    The time is the kernel's total over the launches the profiler
    recorded, divided by them; in a long process it records fewer than
    were made, so their number says nothing of the main path's launches
    and is not given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        sync(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured (the profiler recorded no "
                "device events)"}
    out = {}
    for name, pat in FLASH_BWD_KERNELS.items():
        hits = [e for e in kernels if pat.search(e.key)]
        seen = sum(e.count for e in hits)
        out[name] = {"ms_a_launch": (sum(e.self_device_time_total
                                         for e in hits) / 1e3 / seen
                                     if seen else None),
                     "kernel": hits[0].key[:60] if hits else None}
    return out


def bwd_design(B: int, H: int, Kh: int, seq: int, D: int, dev) -> dict:
    """The backward design's costs beyond the function's, worked out from
    the shape (nothing here is measured): the scratch (delta and
    lse·log2(e) a padded row, a GQA group's float32 partials) and the
    partials' traffic (written once, read once by the group sum); the
    operations with the dQ kernel's recomputed q·kᵀ and dO·vᵀ (14·D a live
    pair against the function's 10·D); and, causal, each kernel's
    schedule in streamed 64-row tiles: a dK/dV block of key tile ``j``
    walks the query tiles from ``2 j``, a dQ block of query tile ``i`` the
    key tiles up to ``2 i + 1``, the longest first, against an even share
    of the card's SMs (csrc/flash_attention.cu's note)."""
    kernel = bwd_route(torch.bfloat16, D)
    n_delta, n_scratch = bwd_scratch(kernel, B, H, Kh, seq, D)
    n_t = -(-seq // BWD_TILE_ROWS)
    step = BWD_BLOCK_ROWS // BWD_TILE_ROWS
    walks = [n_t - step * j for j in range(-(-seq // BWD_BLOCK_ROWS))]
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)           # the H100 SXM's
    return {"kernel": kernel, "shape": [B, H, Kh, seq, D],
            "scratch_bytes": 4 * (n_delta + n_scratch),
            "partials_traffic_bytes": 2 * 4 * (n_scratch - n_delta),
            "ops_with_recompute": 14 * B * H * D * seq * (seq + 1) // 2,
            "schedule": {"tile_rows": BWD_TILE_ROWS,
                         "blocks_a_kernel": len(walks) * B * H,
                         "tiles_a_kernel": sum(walks) * B * H,
                         "longest_block_tiles": max(walks),
                         "even_share_tiles": sum(walks) * B * H / sms,
                         "sms": sms}}


def sdpa_grads(q, k, v, do, causal: bool = True):
    """The gradient of PyTorch's fused attention on the same views: the
    yardstick of the backward's ``library_ms`` (bf16) and
    ``library_fp32_ms``, never called by the port."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(sdpa(*leaves, causal), leaves, do)


def time_flash_bwd(gen, seq: int, iters: int) -> dict:
    """One layer's attention gradient in qwen2-0.5b's bf16 training step,
    every tensor in the layout the step gives the kernel: (B, H, S, D)
    views of (B, S, H, D) tensors, dO too.  ops: the function's five
    products of 2·D a live (query, key) pair (s = q·kᵀ, as p is not an
    input; dV = pᵀ·dO; dp = dO·vᵀ; dK = dsᵀ·q; dQ = ds·k), at the bf16
    peak; the dQ kernel's second q·kᵀ and dO·vᵀ are the design's cost and
    not counted.  bytes: q, k, v, o, dO and lse read once, dq, dk and dv
    written once."""
    dev = gen.device
    B, H, Kh, D = TRAIN_BATCH, 14, 2, 64
    q, k, v = flash_inputs(gen, B, H, Kh, seq, D, torch.bfloat16)
    check = flash_bwd_check("timed shapes", q, k, v, True)
    o, lse = flash_attention(q, k, v, return_lse=True)
    do = torch.randn((B, seq, H, D), generator=gen, device=dev
                     ).to(o.dtype).transpose(1, 2)
    grads = flash_attention_bwd(q, k, v, o, do, lse)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    lib_err = max(max_abs_err(a, b) for a, b in zip(
        sdpa_grads(q, k, v, do), grads))
    lib_fp32_err = max(max_abs_err(a, b) for a, b in zip(
        sdpa_grads(qf, kf, vf, dof), grads))

    def run():
        return flash_attention_bwd(q, k, v, o, do, lse)

    t = {"ms": median_ms(run, dev, iters),
         "single_call_ms": single_call_ms(run, dev, iters),
         "host_ms": host_ms(run, dev, iters),
         "plain_ms": median_ms(lambda: ref.flash_attention_bwd_ref(
             q, k, v, o, do, lse), dev, max(1, iters // 5)),
         "library_ms": median_ms(lambda: sdpa_grads(q, k, v, do), dev,
                                 iters),
         "library_fp32_ms": median_ms(lambda: sdpa_grads(qf, kf, vf, dof),
                                      dev, max(1, iters // 5)),
         "library_max_abs_err": lib_err,
         "library_fp32_max_abs_err": lib_fp32_err,
         "bytes": nbytes(q, k, v, o, do, lse, *grads),
         "ops": 10 * B * H * D * seq * (seq + 1) // 2,
         "max_abs_err": check["max_abs_err"],
         "err_over_max_grad": check["err_over_max_grad"],
         "bit_equal_share": check["bit_equal_share"]}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_BF16)
    emit("flash_bwd_design", **bwd_design(B, H, Kh, seq, D, dev))
    t["split"] = (bwd_split(run, dev) if dev.type == "cuda"
                  else "not measured (a CPU rehearsal)")
    of, lsef = flash_attention(qf, kf, vf, return_lse=True)
    t["float32_ms"] = median_ms(lambda: flash_attention_bwd(
        qf, kf, vf, of, dof, lsef), dev, max(1, iters // 5))
    return t


def step_profile(run, dev) -> dict:
    """``torch.profiler`` over one warm training step: device time by
    class of kernel (the flash forward and backward, cuBLAS GEMMs,
    reductions, gathers, elementwise passes), the flash kernels' launches
    by name, and the device's idle share of the traced window.  The
    device's activity alone: the host's op events would cost seconds of
    post-processing a step (tens of thousands of kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured (the profiler recorded no "
                "device events)", "traced_wall_ms": wall_ms}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class = {name: 0.0 for name, _ in STEP_CLASSES}
    by_class["other"] = 0.0
    for e in kernels:
        cls = next((name for name, pat in STEP_CLASSES
                    if pat.search(e.key)), "other")
        by_class[cls] += e.self_device_time_total / 1e3
    launches = {"flash_forward": sum(e.count for e in kernels
                                     if FLASH_FWD_KERNELS.search(e.key))}
    for name, pat in FLASH_BWD_KERNELS.items():
        launches[f"flash_bwd_{name}"] = sum(e.count for e in kernels
                                            if pat.search(e.key))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "device_ms_by_class": by_class, "flash_launches": launches,
            "device_kernel_calls": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def event_ms(fn, dev) -> float:
    """One call's device time between two CUDA events (host clock on the
    CPU)."""
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def step_parts(model, opt, state, batch, dev) -> dict:
    """A warm step's parts, each between CUDA events: the step's
    ``launch.train.loss_and_grads``, the loss forward alone on leaves that
    autograd records (the gradient is the difference), the cross entropy
    alone (forward and gradient on the step's logits) and the AdamW
    update."""
    out = {}
    holder = {}

    def forward():
        model.loss(lm_train.trainable(state["params"]), batch)

    def loss_and_grads():
        holder["grads"] = lm_train.loss_and_grads(model, state["params"],
                                                  batch)[2]

    def update():
        with torch.no_grad():
            opt.update(holder["grads"], state["opt"], state["params"])

    out["forward_ms"] = event_ms(forward, dev)
    out["loss_and_grads_ms"] = event_ms(loss_and_grads, dev)
    out["backward_ms"] = out["loss_and_grads_ms"] - out["forward_ms"]
    out["adamw_ms"] = event_ms(update, dev)
    holder.clear()
    with torch.no_grad():
        logits = lm_tfm.lm_forward(model.cfg, state["params"],
                                   batch["tokens"])
    lg = logits.detach().requires_grad_()

    def ce():
        torch.autograd.grad(lm_tfm.cross_entropy(lg, batch["tokens"]), lg)

    out["cross_entropy_ms"] = single_call_ms(ce, dev, 3)
    del logits, lg
    return out


def leaves_equal(a, b) -> dict:
    """Bit-equality of two states leaf by leaf, and the largest gap where
    they differ."""
    names, la = tree_flatten_with_names(a)
    lb = tree_leaves(b)
    differ = {n: max_abs_err(x, y) for n, x, y in zip(names, la, lb)
              if not torch.equal(x, y)}
    return {"leaves": len(la), "bit_equal": not differ,
            "differing": dict(list(differ.items())[:8])}


def grads_of(model, params, batch) -> tuple:
    loss, _, grads = lm_train.loss_and_grads(model, params, batch)
    return loss.detach(), tree_leaves(grads)


def grad_twin(model, params, batch) -> dict:
    """The loss and its gradients with kernels against use_kernels(False)
    on the same parameters and batch."""
    loss, got = grads_of(model, params, batch)
    with dispatch.use_kernels(False):
        twin_loss, want = grads_of(model, params, batch)
    num = sum(float((a.float() - w.float()).norm()) ** 2
              for a, w in zip(got, want))
    den = sum(float(w.float().norm()) ** 2 for w in want)
    worst = max(max_abs_err(a, w) / max(float(w.float().abs().max()), 1e-30)
                for a, w in zip(got, want))
    return {"loss": float(loss), "twin_loss": float(twin_loss),
            "loss_rel_gap": abs(float(loss) - float(twin_loss))
            / abs(float(twin_loss)),
            "grad_rel_l2": (num / den) ** 0.5,
            "worst_leaf_err_over_max": worst}


def lm_trainer(model, opt, seed: int, seq: int, ckpt_dir=None,
               batch: int = TRAIN_BATCH) -> Trainer:
    """``launch.train``'s pieces: the state from ``seed``, a TokenStream
    batch of ``batch`` x ``seq`` tokens a step, the step function, the
    fault-tolerant Trainer."""
    cfg = model.cfg
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=seed,
                         device=model.device)
    # one checkpoint kept: a save of the full-width state is 6.9 GB
    return Trainer(lm_train.make_step_fn(model, opt),
                   lm_train.make_state(model, opt, seed),
                   lm_train.make_batch_fn(cfg, stream, batch, seq),
                   TrainerConfig(ckpt_dir=ckpt_dir, ckpt_keep=1,
                                 log_every=10))


def train_lm(args, dev, card: str) -> tuple:
    """qwen2-0.5b trained at full width (the smoke config in a
    rehearsal): (a) the backward kernel against its plain version, (b) its
    times, (c) 20 steps through ``launch.train`` and the Trainer with
    their launches, loss, tokens/s and a profile of one step, (d) a run
    saved at step 10 and resumed, bit-equal to (c), (e) one step against
    its ``use_kernels(False)`` twin in bf16 and, cut to 2 layers, in
    float32.  Returns the main path's launches and the backward's times."""
    cfg = (get_smoke_config if args.rehearse else get_config)(LM_ARCH)
    check = not args.rehearse
    seq = TRAIN_SEQ if check else 64
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 40)
    emit("compare", flash_attention_bwd=compare_flash_bwd(
        gen, seq if check else 130, args.flash_compare))
    times = time_flash_bwd(gen, seq if check else 130, args.iters)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) the main path: counts set to 0 just before, read just after
    model = build_model(cfg, dev)
    opt = adamw(TRAIN_LR)
    seed = args.seed + 41
    trainer = lm_trainer(model, opt, seed, seq)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = trainer.run(TRAIN_STEPS)
    sync(dev)
    run_s = time.perf_counter() - t0
    seen = counts()
    want = expected(flash_attention=cfg.n_layers * TRAIN_STEPS,
                    flash_attention_bwd=cfg.n_layers * TRAIN_STEPS)
    if check:
        require(seen == want, f"train_lm launched {seen}, the design "
                f"implies {want}")
    losses = [h["loss"] for h in trainer.history]
    first, last5 = losses[0], statistics.mean(losses[-5:])
    require(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
            f"train_lm losses {losses}")
    require(out["restarts"] == 0, f"train_lm restarted: {out}")
    require(last5 < first, f"train_lm: the last five steps' mean loss "
            f"{last5} is not below the first step's {first}")
    n_tok = TRAIN_BATCH * seq
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    state = trainer.state
    step_fn = lm_train.make_step_fn(model, opt)
    batch = trainer.batch_fn(TRAIN_STEPS)
    step_fn(state, batch)                                     # warm
    steady = []
    for _ in range(TRAIN_STEADY_STEPS):
        sync(dev)
        t1 = time.perf_counter()
        step_fn(state, batch)
        sync(dev)
        steady.append(time.perf_counter() - t1)
    reset_counts()
    prof = step_profile(lambda: step_fn(state, batch), dev)
    if check and "flash_launches" in prof:
        per = {k: v for k, v in prof["flash_launches"].items()}
        require(all(n == cfg.n_layers for n in per.values()),
                f"a profiled step launched the flash kernels {per}, the "
                f"design implies {cfg.n_layers} each")
    parts = step_parts(model, opt, state, batch, dev)
    main = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": seq,
            "launches": seen, "expected_launches": want,
            "first_loss": first, "last5_mean_loss": last5,
            "losses": losses, "run_s": run_s,
            "tokens_per_s": {"run": n_tok * TRAIN_STEPS / run_s,
                             "steady_median": n_tok / statistics.median(
                                 steady),
                             "steady_steps_s": steady},
            "peak_memory_gib": peak, "profile": prof, "parts": parts}
    emit("train_lm", card=card, part="main path", arch=cfg.name,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         dtype=cfg.dtype, params=model.param_count(state["params"]), **main)
    del batch

    # (d) saved at step TRAIN_RESUME_AT, resumed by a new Trainer
    base = tempfile.mkdtemp(prefix="train_lm_")
    try:
        t1 = time.perf_counter()
        lm_trainer(model, opt, seed, seq, base).run(TRAIN_RESUME_AT)
        first_s = time.perf_counter() - t1
        resumed = lm_trainer(model, opt, seed, seq, base)
        restore_s = time.perf_counter() - t1 - first_s
        require(resumed.start_step == TRAIN_RESUME_AT,
                f"resumed at step {resumed.start_step}")
        resumed.run(TRAIN_STEPS - TRAIN_RESUME_AT)
        same = leaves_equal(resumed.state, state)
        same_losses = [h["loss"] for h in resumed.history] == \
            losses[TRAIN_RESUME_AT:]
        resume = {"resumed_at": resumed.start_step, **same,
                  "losses_equal": same_losses, "first_run_s": first_s,
                  "restore_s": restore_s,
                  "total_s": time.perf_counter() - t1}
        require(same["bit_equal"] and same_losses,
                f"train_lm: the resumed run != the straight run: {resume}")
        del resumed
    finally:
        import shutil
        shutil.rmtree(base, ignore_errors=True)
    del trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (e) one step against its use_kernels(False) twin
    params = model.init(seed)
    twin_batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                          (TRAIN_BATCH, seq), generator=gen,
                                          device=dev)}
    bf16 = grad_twin(model, params, twin_batch)
    require(bf16["loss_rel_gap"] <= TRAIN_TWIN_LOSS_RTOL
            and bf16["grad_rel_l2"] < TRAIN_TWIN_GRAD_L2,
            f"train_lm: a bf16 step != its plain twin: {bf16}")
    del params, model
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                                block_pattern=(cfg.pattern[0],)
                                * TRAIN_F32_LAYERS, dtype="float32")
    model32 = build_model(cfg32, dev)
    f32 = grad_twin(model32, model32.init(seed), {"tokens": torch.randint(
        0, cfg.vocab_size, (TRAIN_F32_BATCH, min(seq, TRAIN_F32_SEQ)),
        generator=gen, device=dev)})
    require(f32["worst_leaf_err_over_max"] <= TRAIN_F32_TOL,
            f"train_lm: a float32 step != its plain twin: {f32}")
    emit("train_lm", card=card, part="resume and twins", resume=resume,
         bf16_twin=bf16, float32_twin={"layers": TRAIN_F32_LAYERS,
                                       "batch": TRAIN_F32_BATCH,
                                       "seq": min(seq, TRAIN_F32_SEQ), **f32},
         seconds=time.perf_counter() - t_phase)
    return seen, times


# -- lm_recurrent: mamba2-370m and recurrentgemma-2b at full width -----------

REC_ARCHS = ("mamba2-370m", "recurrentgemma-2b")
REC_PREFILL_BATCH, REC_PREFILL_SEQ = 4, 4096
# decode tokens/s, graph against eager: REC_DECODE_RUNS turns, and
# profiles of REC_PROFILE_TOKENS tokens of each (an eager recurrent decode
# takes 45-60 ms and 1,800-2,700 launches a token)
REC_DECODE_RUNS, REC_PROFILE_TOKENS = 2, 2
# float32: one request of 17 x 128 tokens (a multiple of the SSD chunk,
# past recurrentgemma's 2048-slot ring), the graph against the eager decode
# in lockstep REC_WRAP_SIDE positions on each side of the ring's wrap
REC_F32_TOKENS, REC_WRAP_SIDE = 2176, 16
# training: batch x 2048 tokens a step, and the layers kept.  Peaks of two
# steps (NVIDIA H100 80GB HBM3, 79.18 GiB): mamba2-370m 37.6 / 54.0 /
# 70.2 GiB at batch 2 / 3 / 4; recurrentgemma-2b at batch 1 out of memory
# at 26 layers, 75.9 GiB at 20, 59.4 at 14 (AdamW's out-of-place update
# holds the old and new master, moments and parameters at once): 17 layers,
# (rglru, rglru, local_attn) x 5 + (rglru, rglru), the full pattern's shape
REC_TRAIN = {"mamba2-370m": {"batch": 4, "layers": 48},
             "recurrentgemma-2b": {"batch": 1, "layers": 17}}
REC_TRAIN_STEPS, REC_TRAIN_SEQ = 10, 2048


def cut_depth(cfg, layers: int):
    """``cfg`` with its first ``layers`` layers."""
    return dataclasses.replace(cfg, n_layers=layers,
                               block_pattern=cfg.pattern[:layers])


def prefill_run(model, params, batch: dict, dev, want: dict,
                units: dict, routes: list | None = None) -> dict:
    """(a) the prefill of ``batch``: the port's kernels launched as
    ``want`` says (counts set to 0 just before, read just after), finite
    last logits of the padded vocabulary, each of ``units`` (its count a
    call: tokens, frames, positions) a second over LM_RATE_REPS calls
    (warm), peak memory, a profile by kernel class
    (:func:`step_profile`).  ``routes``, where given, gets the MoE routes
    of the counted call (``moe.log_routes``)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with moe.log_routes() as log:
        logits = model.prefill(params, batch)
    sync(dev)
    seen = counts()
    if routes is not None:
        routes.extend(log)
    B, S = batch["tokens"].shape
    # a CPU tensor runs the plain versions, which count nothing
    require(seen == want or dev.type == "cpu", f"{model.cfg.name} prefill "
            f"launched {seen}, the design implies {want}")
    require(tuple(logits.shape) == (B, 1, padded_vocab(model.cfg))
            and bool(torch.isfinite(logits).all()),
            f"{model.cfg.name} prefill logits {tuple(logits.shape)} or not "
            "finite")
    times = [timed_prefill(model, params, batch)
             for _ in range(LM_RATE_REPS)]
    out = {"batch": B, "seq": S, "launches": seen}
    for unit, n in units.items():
        out[f"{unit}_per_s"] = {"median": n / statistics.median(times),
                                "min": n / max(times), "max": n / min(times),
                                "runs": len(times)}
    if dev.type == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["profile"] = step_profile(lambda: model.prefill(params, batch), dev)
    return out


def rec_float32(model, params, request, dev,
                routes: dict | None = None) -> dict:
    """(c) float32 at full width, one request: the prefill's last logits
    against the replay of the request through the captured decode step,
    within CROSS_PATH_TOL of max|logit|, and the graph against the eager
    decode in lockstep, bit for bit, from REC_WRAP_SIDE positions before
    the ring wraps (or the same place in a model without one) to as many
    after: the eager decode takes the graph's caches there.  ``routes``,
    where given, gets the MoE routes (``moe.log_routes``) of the prefill
    (``"prefill"``) and of the eager lockstep (``"lockstep"``, a step's
    layers after another's) and the lockstep's first position
    (``"first"``)."""
    cfg = model.cfg
    T = request.shape[1]
    ring = cfg.window if LOCAL_ATTN in cfg.pattern else 0
    side = min(REC_WRAP_SIDE, (ring or T) // 4)
    lo = (ring or T // 2) - side
    step = DecodeStep(model, params, 1, T)
    step.reset()
    cache, pos = None, None
    equal, compared, gap = True, 0, 0.0
    lockstep: list = []
    for t in range(T):
        if t == lo:
            cache = [{k: v.clone() for k, v in layer.items()}
                     for layer in step.cache]
            pos = torch.full((), t, dtype=torch.int32, device=dev)
        got = step(request[:, t:t + 1])
        if lo <= t < lo + 2 * side:
            with moe.log_routes() as log:
                want, cache = model.decode_step(params, cache,
                                                request[:, t:t + 1], pos)
            lockstep.extend(log)
            pos += 1
            compared += 1
            if not torch.equal(got, want):
                equal = False
                gap = max(gap, float((got - want).abs().max()))
    last = got[:, -1].clone()
    require(equal, f"{cfg.name} float32: the captured decode step != the "
            f"eager decode at positions {lo}..{lo + 2 * side - 1} "
            f"(max gap {gap})")
    V = cfg.vocab_size                  # the padded columns hold -1e9
    with moe.log_routes() as log:
        pre = model.prefill(params, {"tokens": request})[:, 0, :V]
    if routes is not None:
        routes.update(prefill=log, lockstep=lockstep, first=lo)
    cross = logits_gap(pre, last[:, :V])
    require(cross["gap_over_max"] <= CROSS_PATH_TOL,
            f"{cfg.name} float32 prefill vs the replay through decode_step: "
            f"{cross}")
    return {"tokens": T, "prefill_vs_replay": cross,
            "lockstep": {"first": lo, "positions": compared,
                         "ring_slots": ring or None,
                         "wraps_at": ring or None, "bit_equal": equal}}


def short_train(model, seed: int, dev, batch: int, seq: int, check: bool,
                per_step: dict | None = None) -> dict:
    """(d) REC_TRAIN_STEPS steps of ``batch`` x ``seq`` tokens through
    ``launch.train``'s step, batch function and the Trainer: finite
    losses, the last below the first, the port's kernels launched
    ``per_step`` times a step (none when not given), tokens/s, peak
    memory and one warm step's profile."""
    cfg = model.cfg
    opt = adamw(TRAIN_LR)
    trainer = lm_trainer(model, opt, seed, seq, batch=batch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = trainer.run(REC_TRAIN_STEPS)
    sync(dev)
    run_s = time.perf_counter() - t0
    seen = counts()
    want = expected(**{k: n * REC_TRAIN_STEPS
                       for k, n in (per_step or {}).items()})
    losses = [h["loss"] for h in trainer.history]
    require(seen == want or dev.type == "cpu", f"{cfg.name} training "
            f"launched {seen}, the design implies {want}")
    require(len(losses) == REC_TRAIN_STEPS
            and all(map(math.isfinite, losses)) and out["restarts"] == 0,
            f"{cfg.name} training: losses {losses}, {out}")
    if check:                        # a rehearsal's 2 x 16 tokens are noise
        require(losses[-1] < losses[0], f"{cfg.name} training: the last "
                f"loss {losses[-1]} is not below the first {losses[0]}")
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    state = trainer.state
    step_fn = lm_train.make_step_fn(model, opt)
    step_batch = trainer.batch_fn(REC_TRAIN_STEPS)
    steady = []
    for _ in range(TRAIN_STEADY_STEPS):
        sync(dev)
        t1 = time.perf_counter()
        step_fn(state, step_batch)
        sync(dev)
        steady.append(time.perf_counter() - t1)
    n_tok = batch * seq
    return {"steps": REC_TRAIN_STEPS, "batch": batch, "seq": seq,
            "layers": cfg.n_layers, "launches": seen, "losses": losses,
            "run_s": run_s, "peak_memory_gib": peak,
            "tokens_per_s": {"run": n_tok * REC_TRAIN_STEPS / run_s,
                             "steady_median": n_tok / statistics.median(
                                 steady), "steady_steps_s": steady},
            "profile": step_profile(lambda: step_fn(state, step_batch), dev)}


def lm_recurrent(args, dev, card: str, arch: str) -> None:
    """mamba2-370m or recurrentgemma-2b at full width, bf16, random weights
    from ``--seed`` (the smoke config in a rehearsal), through the port's
    entry points: (a) the prefill of 4 x 4096 tokens, (b) ``generate`` on
    8 requests of 64 + 32 tokens through the captured decode step, held
    against the eager decode in lockstep and timed against it in turns,
    (c) float32 at full width (:func:`rec_float32`), (d) training
    (:func:`short_train`; recurrentgemma cut in depth).  No port kernel
    lies on these paths: every count stays 0."""
    cfg = (get_smoke_config if args.rehearse else get_config)(arch)
    check = not args.rehearse
    t0 = time.perf_counter()
    seed = args.seed + 70 + 10 * REC_ARCHS.index(arch)
    B, S = (REC_PREFILL_BATCH, REC_PREFILL_SEQ) if check else (2, 64)
    n_req, prompt = (SERVE_REQUESTS, SERVE_PROMPT) if check else (2, 12)
    with torch.inference_mode():
        model = build_model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (n_req, prompt),
                                generator=gen, device=dev)
        n_params = model.param_count(params)
        parts_s = {"init": time.perf_counter() - t0}
        prefill = prefill_run(model, params, {"tokens": tokens}, dev,
                              expected(), {"tokens": B * S})
        parts_s["prefill"] = time.perf_counter() - t0 - sum(parts_s.values())
        del tokens
        serve = serve_run(model, params, prompts, dev, check, expected())
        parts_s["serve"] = time.perf_counter() - t0 - sum(parts_s.values())
        del params, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = build_model(cfg32, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
        T = REC_F32_TOKENS if check else 3 * cfg.window or 24
        request = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                                device=dev)
        float32 = rec_float32(model, params, request, dev)
        del params, model
        parts_s["float32"] = time.perf_counter() - t0 - sum(parts_s.values())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cut = REC_TRAIN[arch]["layers"] if check else cfg.n_layers
    train = short_train(build_model(cut_depth(cfg, cut), dev), seed + 2,
                        dev, REC_TRAIN[arch]["batch"] if check else 2,
                        REC_TRAIN_SEQ if check else 16, check)
    parts_s["train"] = time.perf_counter() - t0 - sum(parts_s.values())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit("lm_recurrent", arch=arch, card=card, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
         params=n_params, prefill=prefill, serve=serve, float32=float32,
         train=train, parts_s=parts_s, seconds=time.perf_counter() - t0)



# -- lm_encdec and lm_vlm: whisper-tiny and llava-next-mistral-7b ------------

ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "llava-next-mistral-7b"
# the flash kernels at the slice's shapes, in the compare cases and timed
# (name -> ((B, H, Kh, S, D), causal)): whisper's encoder, full attention
# over 1,500 frames, and llava's backbone, causal over 2,880 prefix + 1,216
# token positions; the rehearsal's are cut to the CPU
# and the MoE backbones' prefill, causal over 4 x 4,096 tokens: phi3.5-moe
# at a GQA group of 4, qwen3-moe at 16 (the rehearsal keeps both groups)
FLASH_SLICE = {"whisper encoder": ((16, 6, 6, 1500, 64), False),
               "llava": ((1, 32, 8, 4096, 128), True),
               "phi3.5-moe": ((4, 32, 8, 4096, 128), True),
               "qwen3-moe": ((4, 64, 4, 4096, 128), True)}
FLASH_SLICE_REHEARSE = {"whisper encoder": ((2, 6, 6, 150, 64), False),
                        "llava": ((1, 8, 2, 256, 128), True),
                        "phi3.5-moe": ((1, 8, 2, 256, 128), True),
                        "qwen3-moe": ((1, 16, 1, 256, 128), True)}
# whisper: prefill and training of 16 requests of 1,500 frames + 448
# tokens (its text context); llava: prefill of 4 x (2,880 + 1,216)
ENCDEC_BATCH, ENCDEC_TOKENS = 16, 448
VLM_BATCH, VLM_TOKENS = 4, 1216
# llava trains at 1 x (2,880 + 1,216) positions, cut to the layers that
# fit.  Peaks of two steps (NVIDIA H100 80GB HBM3, 79.18 GiB;
# tools/lm_train_memory.py): 52.8 / 60.1 / 64.6 / 70.5 GiB at 6 / 7 / 8 / 9
# layers, ~6 GiB a layer (AdamW's out-of-place update holds the old and
# new master, moments and parameters at once); 9 keeps 8.6 GiB free
VLM_TRAIN = {"batch": 1, "layers": 9}


def time_flash_case(gen, shape: tuple, causal: bool, iters: int) -> dict:
    """flash_attention at ``shape`` in bf16: ms, the bound (the wrapper's
    charge: q, k, v and o once; 6·D a live (query, key) pair at the bf16
    peak) and bf16 SDPA's ms with ``is_causal`` as the case."""
    dev = gen.device
    B, H, Kh, S, D = shape
    q, k, v = flash_inputs(gen, *shape, torch.bfloat16)
    o = flash_attention(q, k, v, causal=causal)
    pairs = S * (S + 1) // 2 if causal else S * S
    t = {"shape": list(shape), "causal": causal,
         "kernel": route(q.dtype, D),
         "ms": median_ms(lambda: flash_attention(q, k, v, causal=causal),
                         dev, iters),
         "library_bf16_ms": median_ms(lambda: sdpa(q, k, v, causal), dev,
                                      iters),
         "library_bf16_max_abs_err": max_abs_err(sdpa(q, k, v, causal), o),
         "bytes": nbytes(q, k, v, o), "ops": 6 * B * H * D * pairs}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_BF16)
    return t


def time_flash_bwd_case(gen, shape: tuple, causal: bool, iters: int) -> dict:
    """flash_attention_bwd at ``shape`` in bf16, dO in the step's layout:
    ms, the bound (q, k, v, o, dO and lse read once, the gradients
    written once; the function's 10·D a live pair) and bf16 SDPA's
    backward's ms."""
    dev = gen.device
    B, H, Kh, S, D = shape
    q, k, v = flash_inputs(gen, *shape, torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn((B, S, H, D), generator=gen, device=dev
                     ).to(o.dtype).transpose(1, 2)
    grads = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    pairs = S * (S + 1) // 2 if causal else S * S
    t = {"shape": list(shape), "causal": causal,
         "kernel": bwd_route(q.dtype, D),
         "ms": median_ms(lambda: flash_attention_bwd(
             q, k, v, o, do, lse, causal=causal), dev, iters),
         "library_bf16_ms": median_ms(lambda: sdpa_grads(q, k, v, do,
                                                         causal), dev, iters),
         "library_bf16_max_abs_err": max(max_abs_err(a, b) for a, b in zip(
             sdpa_grads(q, k, v, do, causal), grads)),
         "bytes": nbytes(q, k, v, o, do, lse, *grads),
         "ops": 10 * B * H * D * pairs}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["ops"],
                                         hw.PEAK_FLOPS_BF16)
    return t


def slice_kernels(gen, args, name: str) -> dict:
    """Both flash kernels timed at the slice case ``name``."""
    shape, causal = args.flash_slice[name]
    out = {"flash_attention": time_flash_case(gen, shape, causal, args.iters),
           "flash_attention_bwd": time_flash_bwd_case(gen, shape, causal,
                                                      args.iters)}
    if gen.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_run(model, params, prompts, dev, check: bool, want: dict,
              frames=None, runs: int = REC_DECODE_RUNS,
              routes: list | None = None) -> dict:
    """(b) ``generate`` on ``prompts`` (an encoder-decoder over ``frames``)
    after a warm-up, its launches as ``want`` (counts set to 0 just
    before, read just after), then :func:`decode_graph`: the captured
    step bit-equal to the eager decode, timed against it in ``runs``
    turns (``routes`` as :func:`decode_graph`'s)."""
    cfg = model.cfg
    n_req, new = prompts.shape[0], SERVE_NEW if check else 6
    generate(model, params, prompts, new, frames)                # warm-up
    reset_counts()
    res = generate(model, params, prompts, new, frames)
    seen = counts()
    require(seen == want or dev.type == "cpu", f"{cfg.name} generate "
            f"launched {seen}, the design implies {want}")
    require(tuple(res.tokens.shape) == (n_req, new)
            and int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size,
            f"{cfg.name} generate gave {tuple(res.tokens.shape)}")
    graph = decode_graph(model, params, prompts, new, dev, check, runs,
                         REC_PROFILE_TOKENS, frames, routes)
    require(graph["logits_bit_equal"], f"{cfg.name}: the captured decode "
            "step's logits != the eager decode's")
    return {"requests": n_req, "prompt": prompts.shape[1], "new_tokens": new,
            "launches": seen,
            "decode_tokens_per_s": n_req * (new - 1) / res.decode_s,
            "first_tokens": res.tokens[0, :8].tolist(), "graph": graph}


def lm_encdec(args, dev, card: str) -> dict:
    """whisper-tiny at full width, bf16, random weights and frames from
    ``--seed`` (the smoke config in a rehearsal), through the port's entry
    points: (a) ``Model.prefill`` of 16 x (1,500 frames + 448 tokens), a
    flash launch a layer (4 full in the encoder, 4 causal in the
    decoder), against its ``use_kernels(False)`` twin, frames/s and
    tokens/s; (b) ``generate`` on 8 requests of 64 + 32 tokens over 1,500
    frames each (the encoder once: 4 launches; none in the decode
    replays), the captured step against the eager decode; (c) float32 at
    full width, one request's prefill against its replay through
    ``decode_step`` after ``encdec_build_cross``; (d) 10 training steps of
    16 x 448 tokens with zero frames (``launch.train.make_batch_fn``), a
    forward and a backward launch a layer; (e) one step's gradients with
    random frames against its ``use_kernels(False)`` twin.  Returns the
    kernels at the encoder's shape and the slice's launches."""
    cfg = (get_smoke_config if args.rehearse else get_config)(ENCDEC_ARCH)
    check = not args.rehearse
    t0 = time.perf_counter()
    seed = args.seed + 90
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels = slice_kernels(gen, args, "whisper encoder")
    parts_s = {"kernels": time.perf_counter() - t0}
    B, T = (ENCDEC_BATCH, ENCDEC_TOKENS) if check else (2, 24)
    n_req, prompt = (SERVE_REQUESTS, SERVE_PROMPT) if check else (2, 12)
    n_ctx, d, V = cfg.encoder.n_ctx, cfg.d_model, cfg.vocab_size
    L = cfg.encoder.n_layers + cfg.n_layers
    with torch.inference_mode():
        model = build_model(cfg, dev)
        params = model.init(gen)
        batch = {"tokens": torch.randint(0, V, (B, T), generator=gen,
                                         device=dev),
                 "frames": torch.randn((B, n_ctx, d), generator=gen,
                                       device=dev)}
        n_params = model.param_count(params)
        reset_counts()
        encdec_encode(cfg, params["encoder"], batch["frames"])
        encoder_seen = counts()
        require(encoder_seen == expected(
            flash_attention=cfg.encoder.n_layers) or not check,
            f"the encoder launched {encoder_seen}")
        prefill = prefill_run(model, params, batch, dev,
                              expected(flash_attention=L),
                              {"frames": B * n_ctx, "tokens": B * T})
        prefill["encoder_launches"] = encoder_seen
        logits = model.prefill(params, batch)[..., :V]
        with dispatch.use_kernels(False):
            twin = model.prefill(params, batch)[..., :V]
        # on the vocabulary: the padded columns hold -1e9
        prefill["twin"] = logits_gap(logits, twin)
        require(prefill["twin"]["gap_over_max"] <= PREFILL_TWIN_TOL[
            cfg.dtype], f"whisper prefill vs its plain twin: "
            f"{prefill['twin']}")
        del logits, twin
        parts_s["prefill"] = time.perf_counter() - t0 - sum(parts_s.values())
        prompts = torch.randint(0, V, (n_req, prompt), generator=gen,
                                device=dev)
        frames = torch.randn((n_req, n_ctx, d), generator=gen, device=dev)
        serve = serve_run(model, params, prompts, dev, check,
                          expected(flash_attention=cfg.encoder.n_layers),
                          frames)
        parts_s["serve"] = time.perf_counter() - t0 - sum(parts_s.values())
        del params, model, frames
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        model = build_model(dataclasses.replace(cfg, dtype="float32"), dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
        request = {"tokens": batch["tokens"][:1],
                   "frames": batch["frames"][:1]}
        pre = model.prefill(params, request)[:, 0, :V]
        res = generate(model, params, request["tokens"], 1,
                       request["frames"])
        float32 = {"tokens": T, "frames": n_ctx,
                   "prefill_vs_replay": logits_gap(pre,
                                                   res.prompt_logits[:, :V])}
        require(float32["prefill_vs_replay"]["gap_over_max"]
                <= CROSS_PATH_TOL, f"whisper float32 prefill vs the replay "
                f"through decode_step: {float32}")
        del params, model, pre, res
        parts_s["float32"] = time.perf_counter() - t0 - sum(parts_s.values())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = build_model(cfg, dev)
    per_step = {"flash_attention": L, "flash_attention_bwd": L}
    train = short_train(model, seed + 2, dev, B, T, check, per_step)
    parts_s["train"] = time.perf_counter() - t0 - sum(parts_s.values())
    # random frames; tensors made outside inference mode, which autograd
    # may save
    twin = grad_twin(model, model.init(seed + 3),
                     {k: v.clone() for k, v in batch.items()})
    require(twin["loss_rel_gap"] <= TRAIN_TWIN_LOSS_RTOL
            and twin["grad_rel_l2"] < TRAIN_TWIN_GRAD_L2,
            f"whisper: a bf16 step != its plain twin: {twin}")
    parts_s["twin"] = time.perf_counter() - t0 - sum(parts_s.values())
    del model, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit("lm_encdec", arch=cfg.name, card=card, layers=[
        cfg.encoder.n_layers, cfg.n_layers], d_model=d, frames=n_ctx,
        vocab=V, dtype=cfg.dtype, params=n_params, prefill=prefill,
        serve=serve, float32=float32, train=train, grad_twin=twin,
        kernels=kernels, parts_s=parts_s, seconds=time.perf_counter() - t0)
    return {"kernels": kernels, "launches": {
        "prefill": prefill["launches"]["flash_attention"],
        "generate": serve["launches"]["flash_attention"],
        "train_step": {k: n // REC_TRAIN_STEPS
                       for k, n in train["launches"].items() if n}}}


def lm_vlm(args, dev, card: str) -> dict:
    """llava-next-mistral-7b at full width, bf16, random weights and
    prefix embeddings from ``--seed`` (the smoke config in a rehearsal),
    through the port's entry points: (a) ``Model.prefill`` of 4 x (2,880
    prefix embeddings + 1,216 tokens), a causal flash launch a layer,
    positions/s and tokens/s, and the prefill of embedded tokens as the
    prefix bit-equal to the token prefill of the whole sequence; (b)
    ``generate`` on 8 requests of 64 + 32 tokens (tokens only, as JAX
    decodes), the captured step against the eager decode; (c) 10
    training steps of 1 x (2,880 + 1,216) with a zero prefix, cut to
    VLM_TRAIN's layers.  Returns the kernels at its shape and the
    slice's launches."""
    cfg = (get_smoke_config if args.rehearse else get_config)(VLM_ARCH)
    check = not args.rehearse
    t0 = time.perf_counter()
    seed = args.seed + 100
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels = slice_kernels(gen, args, "llava")
    parts_s = {"kernels": time.perf_counter() - t0}
    P, d, V = cfg.n_prefix_embeds, cfg.d_model, cfg.vocab_size
    B, T = (VLM_BATCH, VLM_TOKENS) if check else (2, 24)
    n_req, prompt = (SERVE_REQUESTS, SERVE_PROMPT) if check else (2, 12)
    with torch.inference_mode():
        model = build_model(cfg, dev)
        params = model.init(gen)
        n_params = model.param_count(params)
        parts_s["init"] = time.perf_counter() - t0 - sum(parts_s.values())
        tokens = torch.randint(0, V, (B, T), generator=gen, device=dev)
        batch = {"tokens": tokens, "prefix_embeds": torch.randn(
            (B, P, d), generator=gen, device=dev) * d ** -0.5}
        prefill = prefill_run(model, params, batch, dev,
                              expected(flash_attention=cfg.n_layers),
                              {"positions": B * (P + T), "tokens": B * T})
        head = torch.randint(0, V, (B, P), generator=gen, device=dev)
        embedded = model.prefill(params, {
            "tokens": tokens,
            "prefix_embeds": torch.nn.functional.embedding(
                head, params["embed"])})
        joined = model.prefill(params, {"tokens": torch.cat([head, tokens],
                                                            dim=1)})
        prefill["embedded_prefix_bit_equal"] = bool(torch.equal(embedded,
                                                                joined))
        require(prefill["embedded_prefix_bit_equal"], "llava: the prefill of "
                "embedded tokens as the prefix != the token prefill")
        del embedded, joined, batch
        parts_s["prefill"] = time.perf_counter() - t0 - sum(parts_s.values())
        prompts = torch.randint(0, V, (n_req, prompt), generator=gen,
                                device=dev)
        serve = serve_run(model, params, prompts, dev, check, expected())
        parts_s["serve"] = time.perf_counter() - t0 - sum(parts_s.values())
        del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cut = VLM_TRAIN["layers"] if check else cfg.n_layers
    train = short_train(build_model(cut_depth(cfg, cut), dev), seed + 2,
                        dev, VLM_TRAIN["batch"] if check else 2, T, check,
                        {"flash_attention": cut, "flash_attention_bwd": cut})
    train["prefix"] = P
    parts_s["train"] = time.perf_counter() - t0 - sum(parts_s.values())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit("lm_vlm", arch=cfg.name, card=card, layers=cfg.n_layers,
         d_model=d, heads=[cfg.n_heads, cfg.n_kv_heads], prefix=P, vocab=V,
         dtype=cfg.dtype, params=n_params, prefill=prefill, serve=serve,
         train=train, kernels=kernels, parts_s=parts_s,
         seconds=time.perf_counter() - t0)
    return {"kernels": kernels, "launches": {
        "prefill": prefill["launches"]["flash_attention"],
        "generate": serve["launches"]["flash_attention"],
        "train_step": {k: n // REC_TRAIN_STEPS
                       for k, n in train["launches"].items() if n},
        "train_layers": cut}}


# -- lm_moe: phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b --------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
MOE_CASES = {"phi3.5-moe-42b-a6.6b": "phi3.5-moe",
             "qwen3-moe-235b-a22b": "qwen3-moe"}
# neither fits the card at full depth (bf16: 83.75 and 470 GB): the
# prefill of 4 x 4096 runs the deepest cut that keeps 6 GiB of the card's
# 79.18 GiB free at its peak.  Peaks of one prefill (NVIDIA H100 80GB HBM3,
# 700.00 W; tools/lm_train_memory.py --prefill): phi3.5-moe 68.81 / 71.23 /
# 73.66 GiB at 27 / 28 / 29 layers (weights 65.92 / 68.34 / 70.73);
# qwen3-moe 67.44 / 72.05 GiB at 13 / 14, out of memory at 15
MOE_SERVE_LAYERS = {"phi3.5-moe-42b-a6.6b": 28, "qwen3-moe-235b-a22b": 14}
# float32 at full width, cut to MOE_F32_LAYERS layers, one request of
# MOE_F32_TOKENS tokens at capacity_factor = n_experts, where neither the
# prefill nor the replay drops a pair
MOE_F32_LAYERS, MOE_F32_TOKENS = 3, 128
MOE_DECODE_RUNS = 1
# phi3.5-moe trains at batch x 2048 tokens, cut to 1 of 32 layers (1.57 B
# parameters).  Peaks of six steps (NVIDIA H100 80GB HBM3, 700.00 W;
# tools/lm_train_memory.py): 49.75 GiB at batch 16 (AdamW's out-of-place
# step, whatever the batch), out of memory at 24 and 32.  qwen3-moe trains
# at no depth on one card: cut to one layer it is 3.73 B parameters, ~127
# GB at the ~34 B a parameter AdamW's out-of-place step holds at its peak
MOE_TRAIN = {"batch": 16, "layers": 1}
# the flash kernels at phi3.5-moe's training step (MOE_TRAIN's batch x
# 2048, G = 4), held against their plain versions in both compare lists
# beside FLASH_SLICE's cases (the rehearsal's cut to the CPU)
FLASH_MOE_TRAIN = {"phi3.5-moe training": (
    (MOE_TRAIN["batch"], 32, 8, REC_TRAIN_SEQ, 128), True)}
FLASH_MOE_TRAIN_REHEARSE = {"phi3.5-moe training": ((2, 8, 2, 16, 128),
                                                    True)}


def drop_share(routes: list) -> dict:
    """The (token, choice) pairs of ``moe.log_routes``' calls and the share
    of them capacity dropped, read from the slots the body computed."""
    pairs = sum(kept.numel() for _, kept in routes)
    kept = sum(int(kept.sum()) for _, kept in routes)
    return {"calls": len(routes), "pairs": pairs,
            "dropped_share": (pairs - kept) / max(pairs, 1)}


def flip_share(a: list, b: list) -> float:
    """The share of (token, choice) pairs of the routes ``a`` whose expert
    is not among the same token's experts in ``b`` (one (T, k) tensor a
    layer each)."""
    differ = sum(int((~(x[:, :, None] == y[:, None, :]).any(-1)).sum())
                 for x, y in zip(a, b))
    return differ / max(sum(x.numel() for x in a), 1)


def moe_layer_ms(cfg, p: dict, T: int, gen, iters: int) -> dict:
    """One MoE layer's parts at ``T`` tokens (random (T, d) inputs in the
    compute dtype, ``p`` the model's first layer): the router, top-k and
    slots (``moe.route``, ``aux_loss``, ``slots``); the dispatch gather;
    the experts' cuBLAS products and SwiGLU; the combine -- each the median
    ms of runs of ``iters`` calls."""
    dev = gen.device
    x = torch.randn((T, cfg.d_model), generator=gen, device=dev
                    ).to(cfg.compute_dtype)
    E, C = cfg.moe.n_experts, moe.capacity(cfg, T)

    def routing():
        probs, topw, topi, pos = moe.route(cfg, p, x)
        moe.aux_loss(probs, topi)
        return topw, moe.slots(topi, pos, C, 0, E)

    topw, (kept, slot) = routing()
    buf = moe.dispatch(x, kept, slot, E, C)
    out = moe.experts(p, buf)
    parts = {"route_ms": median_ms(routing, dev, iters),
             "dispatch_ms": median_ms(
                 lambda: moe.dispatch(x, kept, slot, E, C), dev, iters),
             "experts_ms": median_ms(lambda: moe.experts(p, buf), dev,
                                     iters),
             "combine_ms": median_ms(
                 lambda: moe.combine(out, kept, slot, topw), dev, iters)}
    f = cfg.moe.d_ff
    return {"tokens": T, "capacity": C, "slots": E * C, **parts,
            "experts_tflops": 6 * E * C * cfg.d_model * f
            / (parts["experts_ms"] * 1e9)}


def lm_moe(args, dev, card: str, arch: str) -> dict:
    """phi3.5-moe-42b-a6.6b or qwen3-moe-235b-a22b at full width, bf16,
    random weights from ``--seed`` (the smoke config in a rehearsal), cut
    in depth (MOE_SERVE_LAYERS), through the port's entry points: (a)
    both flash kernels timed at its prefill shape (qwen3-moe: GQA group
    16); (b) ``Model.prefill`` of 4 x 4096 tokens, a flash launch a
    layer, tokens/s, peak memory, a profile, the share of (token, choice)
    pairs capacity dropped and one layer's MoE parts timed apart; (c)
    ``generate`` on 8 requests of 64 + 32 tokens, no launch, the captured
    step against the eager decode, and the drop share of the eager decode
    (C = 1 at 8 tokens a step, JAX's rule); (d) float32, cut to
    MOE_F32_LAYERS layers, at capacity_factor = n_experts (no drop on
    either path): one request's prefill against its replay through the
    captured ``decode_step`` and the graph against the eager decode
    (:func:`rec_float32`), with the share of pairs whose expert differs
    between the prefill and the eager lockstep; (e) phi3.5-moe only: 10
    training steps of MOE_TRAIN's batch x 2048 tokens at MOE_TRAIN's
    depth, a forward and a backward launch a layer a step, the last loss
    below the first, and a second gradient of one batch bit-equal to the
    first, the routers' gradients finite and not all zero.  Returns the
    kernels at its shape and the slice's launches."""
    full = (get_smoke_config if args.rehearse else get_config)(arch)
    check = not args.rehearse
    t0 = time.perf_counter()
    seed = args.seed + 110 + 10 * MOE_ARCHS.index(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernels = slice_kernels(gen, args, MOE_CASES[arch])
    parts_s = {"kernels": time.perf_counter() - t0}
    depth = MOE_SERVE_LAYERS[arch] if check else full.n_layers
    cfg = cut_depth(full, depth)
    V, E = cfg.vocab_size, cfg.moe.n_experts
    B, S = (LM_BATCH, LM_SEQ) if check else (2, 64)
    n_req, prompt = (SERVE_REQUESTS, SERVE_PROMPT) if check else (2, 12)
    with torch.inference_mode():
        model = build_model(cfg, dev)
        params = model.init(gen)
        n_params = model.param_count(params)
        in_layers = sum(t.numel() for layer in params["layers"]
                        for t in tree_leaves(layer))
        sizes = {"params": n_params,
                 "active_params": model.active_param_count(params),
                 "params_full_depth": n_params - in_layers
                 + in_layers // depth * full.n_layers}
        parts_s["init"] = time.perf_counter() - t0 - sum(parts_s.values())
        tokens = torch.randint(0, V, (B, S), generator=gen, device=dev)
        routes: list = []
        prefill = prefill_run(model, params, {"tokens": tokens}, dev,
                              expected(flash_attention=depth),
                              {"tokens": B * S}, routes)
        prefill["capacity"] = moe.capacity(cfg, B * S)
        prefill["drops"] = drop_share(routes)
        prefill["moe_layer"] = moe_layer_ms(
            cfg, params["layers"][0]["moe"], B * S, gen,
            5 if check else 1)
        del tokens, routes
        parts_s["prefill"] = time.perf_counter() - t0 - sum(parts_s.values())
        prompts = torch.randint(0, V, (n_req, prompt), generator=gen,
                                device=dev)
        # one turn of graph and eager: an eager MoE decode step takes ~0.1 s;
        # the drops are the eager lockstep's, 8 tokens a step
        routes = []
        serve = serve_run(model, params, prompts, dev, check, expected(),
                          runs=MOE_DECODE_RUNS, routes=routes)
        serve["capacity"] = moe.capacity(cfg, n_req)
        serve["drops"] = drop_share(routes)
        del params, model, routes
        parts_s["serve"] = time.perf_counter() - t0 - sum(parts_s.values())
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(
            cut_depth(full, min(MOE_F32_LAYERS, full.n_layers)),
            dtype="float32", moe=dataclasses.replace(
                full.moe, capacity_factor=float(E)))
        model = build_model(cfg32, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 1))
        T = MOE_F32_TOKENS if check else 24
        request = torch.randint(0, V, (1, T), generator=gen, device=dev)
        logged: dict = {}
        float32 = rec_float32(model, params, request, dev, logged)
        # the prefill's routes at the lockstep's positions against the
        # eager decode's there
        L, lo = cfg32.n_layers, logged["first"]
        steps = logged["lockstep"]
        n = len(steps) // L
        lockstep = [torch.cat([steps[t * L + i][0] for t in range(n)])
                    for i in range(L)]
        float32.update(layers=L, capacity_factor=cfg32.moe.capacity_factor,
                       drops={"prefill": drop_share(logged["prefill"]),
                              "lockstep": drop_share(steps)},
                       prefill_vs_lockstep_expert_flips=flip_share(
                           [r[lo:lo + n] for r, _ in logged["prefill"]],
                           lockstep))
        require(float32["drops"]["prefill"]["dropped_share"] == 0
                and float32["drops"]["lockstep"]["dropped_share"] == 0,
                f"{arch} float32 at capacity_factor = n_experts dropped "
                f"pairs: {float32['drops']}")
        del params, model, logged, steps, lockstep
        parts_s["float32"] = time.perf_counter() - t0 - sum(parts_s.values())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    train = None
    launches = {"prefill": prefill["launches"]["flash_attention"],
                "generate": serve["launches"]["flash_attention"],
                "prefill_layers": depth}
    if arch == MOE_ARCHS[0]:
        cut = MOE_TRAIN["layers"] if check else full.n_layers
        model = build_model(cut_depth(full, cut), dev)
        batch = MOE_TRAIN["batch"] if check else 2
        seq = REC_TRAIN_SEQ if check else 16
        train = short_train(model, seed + 2, dev, batch, seq, check,
                            {"flash_attention": cut,
                             "flash_attention_bwd": cut})
        params = model.init(seed + 3)
        one = {"tokens": torch.randint(0, V, (batch, seq), generator=gen,
                                       device=dev)}
        loss, first = grads_of(model, params, one)
        loss2, second = grads_of(model, params, one)
        names = tree_flatten_with_names(params)[0]
        routers = [g for n, g in zip(names, first) if "['router']" in n]
        train["grad_twice"] = leaves_equal(first, second)
        train["grad_twice"]["loss_equal"] = bool(torch.equal(loss, loss2))
        train["router_grad_max_abs"] = [float(g.abs().max())
                                        for g in routers]
        require(train["grad_twice"]["bit_equal"]
                and train["grad_twice"]["loss_equal"],
                f"{arch}: two gradients of one batch differ: "
                f"{train['grad_twice']}")
        require(len(routers) == cut and all(
            bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
            for g in routers), f"{arch}: router gradients "
            f"{train['router_grad_max_abs']}")
        del model, params, first, second, routers, one
        launches.update(train_step={k: n // REC_TRAIN_STEPS for k, n in
                                    train["launches"].items() if n},
                        train_layers=cut)
        parts_s["train"] = time.perf_counter() - t0 - sum(parts_s.values())
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit("lm_moe", arch=arch, card=card, layers=depth,
         layers_full=full.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads], experts=E,
         top_k=cfg.moe.top_k, expert_d_ff=cfg.moe.d_ff,
         capacity_factor=cfg.moe.capacity_factor, vocab=V, dtype=cfg.dtype,
         **sizes, prefill=prefill, serve=serve, float32=float32,
         train=train, kernels=kernels, parts_s=parts_s,
         seconds=time.perf_counter() - t0)
    return {"kernels": kernels, "launches": launches}


# -- main ------------------------------------------------------------------


# -- shard: the logical sharding rules, expert parallelism, the dry runs ------

SHARD_STEPS = 3
SHARD_TURNS = 3
SHARD_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
SHARD_MOE = {"batch": 4, "seq": 4096, "layers": 1}
SHARD_MOE_REHEARSE = {"batch": 2, "seq": 64, "layers": 1}
# (b): float32 prefill logits within 1e-5 of max|y| of the one-rank run;
# bf16 within the bf16 step bar (TRAIN_TWIN_LOSS_RTOL) of max|y|
SHARD_MOE_TOL = {"float32": 1e-5, "bfloat16": TRAIN_TWIN_LOSS_RTOL}
SHARD_DRYRUNS = (("qwen2-0.5b", "train_4k", False),
                 ("qwen2-0.5b", "train_4k", True),
                 ("phi3.5-moe-42b-a6.6b", "prefill_32k", False),
                 ("qwen1.5-110b", "decode_32k", False),
                 ("mamba2-370m", "long_500k", False))
SHARD_PIM_CADENCES = (1, 8)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def card_bytes(dev) -> dict | None:
    """The caching allocator's live bytes on the card after a sync:
    ``requested`` as the tensors asked for them, ``allocated`` as its
    blocks hold them (each rounded up to a multiple of 512 bytes, a
    large-pool block possibly up to 1 MiB more where a cached block was
    not split); ``None`` off the card."""
    if dev.type != "cuda":
        return None
    sync(dev)
    stats = torch.cuda.memory_stats(dev)
    return {"requested": stats["requested_bytes.all.current"],
            "allocated": stats["allocated_bytes.all.current"]}


def shard_train(args, dev, card: str, store_dir: str) -> dict:
    """(a) qwen2-0.5b's training step (``launch.train.make_step_fn``, 4 x
    2048 tokens, AdamW with a float32 master) for ``SHARD_STEPS`` steps on
    a (1, 1) ``("data", "model")`` mesh over a world of one process
    (NCCL), under ``make_rules``, with every state leaf and batch a
    DTensor placed by ``launch.shardings``: the losses and every state
    leaf bit-equal to the same steps on plain tensors from the same seed,
    the flash kernels launched 24 + 24 times a step (the counters over
    the steps, the profiler over one), the step's ms against the plain
    step's in turns (DTensor's host cost, no bar), and the state's bytes
    and peak for (c)."""
    cfg = (get_smoke_config if args.rehearse else get_config)(LM_ARCH)
    check = not args.rehearse
    seq = TRAIN_SEQ if check else 64
    model = build_model(cfg, dev)
    opt = adamw(TRAIN_LR)
    seed = args.seed + 300
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, seq, seed=seed,
                         device=dev)
    batch_fn = lm_train.make_batch_fn(cfg, stream, TRAIN_BATCH, seq)
    step = lm_train.make_step_fn(model, opt)
    plain = lm_train.make_state(model, opt, seed)
    ref, ref_losses = plain, []
    for i in range(SHARD_STEPS):
        ref, m = step(ref, batch_fn(i))
        ref_losses.append(float(m["loss"]))
    init_world("nccl" if dev.type == "cuda" else "gloo",
               dist.FileStore(os.path.join(store_dir, "shard1"), 1))
    try:
        mesh = make_host_mesh(1, 1, device_type=dev.type)
        rules = make_rules(mesh, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        with use_rules(rules):
            held0 = card_bytes(dev)
            s0 = lm_train.make_state(model, opt, seed)
            s0 = {"params": shardings.distribute_tree(
                      rules, s0["params"], shardings.param_axes),
                  "opt": shardings.distribute_tree(
                      rules, s0["opt"], shardings.param_axes)}
            held = card_bytes(dev)
            state_held = (None if held is None else
                          {k: held[k] - held0[k] for k in held})
            state_bytes = dryrun.local_bytes(s0)
            batches = [shardings.distribute_tree(rules, batch_fn(i),
                                                 shardings.batch_axes)
                       for i in range(SHARD_STEPS)]
            sync(dev)
            before = (torch.cuda.memory_allocated(dev)
                      if dev.type == "cuda" else 0)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            st, losses = s0, []
            for b in batches:
                st, m = step(st, b)
                losses.append(float(whole(m["loss"])))
            sync(dev)
            seen = counts()
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None)
            want = expected(flash_attention=cfg.n_layers * SHARD_STEPS,
                            flash_attention_bwd=cfg.n_layers * SHARD_STEPS)
            if check:
                require(seen == want, f"shard (a) launched {seen}, the "
                        f"design implies {want}")
            local = tree_map(lambda t: t.to_local() if isinstance(
                t, DTensor) else t, st)
            same = leaves_equal(local, ref)
            require(losses == ref_losses and same["bit_equal"],
                    f"shard (a): the DTensor steps != the plain steps: "
                    f"losses {losses} against {ref_losses}, {same}")
            del st, local, ref
            prof = step_profile(lambda: step(s0, batches[0]), dev)
            if check and "flash_launches" in prof:
                per = dict(prof["flash_launches"])
                require(all(n == cfg.n_layers for n in per.values()),
                        f"shard (a): a profiled DTensor step launched the "
                        f"flash kernels {per}, the design implies "
                        f"{cfg.n_layers} each")
            b_plain = batch_fn(0)
            rates = turns({"plain": lambda: step(plain, b_plain),
                           "dtensor": lambda: step(s0, batches[0])},
                          1, SHARD_TURNS, dev)
    finally:
        dist.destroy_process_group()
    step_ms = {k: 1e3 / v["median"] for k, v in rates.items()}
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": seq, "steps": SHARD_STEPS, "mesh": [1, 1],
           "losses": losses, "launches": seen, "expected_launches": want,
           **same, "state_bytes": state_bytes, "state_held": state_held,
           "peak_bytes": peak, "allocated_before_bytes": before,
           "profile": prof, "step_ms_in_turns": step_ms,
           "dtensor_over_plain": step_ms["dtensor"] / step_ms["plain"],
           "turns": rates}
    emit("shard", card=card, part="(a) qwen2-0.5b training on a (1, 1) "
         "mesh, DTensor state", **out)
    return out


def moe_prefill_case(args, dev, dtype: str, seed: int):
    """(b)'s model and request: phi3.5-moe cut to ``layers`` layers in
    ``dtype``, its parameters from ``seed`` and a prompt of batch x seq
    tokens."""
    shape = SHARD_MOE_REHEARSE if args["rehearse"] else SHARD_MOE
    cfg = (get_smoke_config if args["rehearse"] else get_config)(
        SHARD_MOE_ARCH)
    cfg = dataclasses.replace(cut_depth(cfg, shape["layers"]), dtype=dtype)
    model = build_model(cfg, dev)
    params = model.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (shape["batch"],
                                               shape["seq"]),
                           generator=gen, device=dev)
    return cfg, model, params, tokens


def moe_prefill(model, params, tokens) -> tuple:
    """The prefill's last logits over the vocabulary (not the padding's
    -1e9 columns) and its routes ``(topi, kept)``, whole and on the
    CPU."""
    with torch.no_grad(), moe.log_routes() as routes:
        logits = model.prefill(params, {"tokens": tokens})
    logits = whole(logits)[..., :model.cfg.vocab_size]
    return (logits.float().cpu().numpy(),
            [(t.cpu().numpy(), k.cpu().numpy()) for t, k in routes])


# gloo's refusal of a tensor's dtype (its type switch's message)
GLOO_DTYPE_REFUSAL = re.compile(r"invalid scalar type|unsupported (scalar "
                                r"type|dtype)", re.IGNORECASE)


def gloo_refuses(dtype: torch.dtype, dev) -> str | None:
    """``None`` where the world's gloo group all-reduces a one-element
    tensor of ``dtype`` on ``dev``, else gloo's message refusing the
    dtype.  Any other error is raised."""
    try:
        dist.all_reduce(torch.ones(1, dtype=dtype, device=dev))
    except RuntimeError as e:
        if GLOO_DTYPE_REFUSAL.search(str(e)) is None:
            raise
        return f"{type(e).__name__}: {e}"[:400]
    return None


def shard_moe_rank(rank: int, world: int, store: str, out_dir: str,
                   opts: dict) -> None:
    """(b) One rank of the expert-parallel world: the same model and
    request from the seed on every rank, the prefill under ``make_rules``
    on a (1, ``world``) ``("data", "model")`` mesh, so that ``moe_ffn``
    takes its expert-parallel branch (this rank's experts by
    ``local_map``, the partials summed by ``sharding.all_sum``).  The rest
    of the model runs whole on every rank, on plain tensors: DTensor's
    all-gather over gloo crashes on CUDA tensors (a card probe), its
    all-reduce does not.  Float32, then bf16 where gloo takes it
    (:func:`gloo_refuses`, probed before the prefill; the prefill itself
    catches nothing)."""
    dev = torch.device(opts["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_world("gloo", dist.FileStore(store, world), rank=rank,
               world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(1, world, device_type=dev.type)
        for dtype in SHARD_MOE_TOL:
            refused = gloo_refuses(getattr(torch, dtype), dev)
            if refused is not None:
                require(dtype != "float32", f"shard (b): {refused}")
                out[dtype] = {"refused": refused}
                continue
            cfg, model, params, tokens = moe_prefill_case(
                opts, dev, dtype, opts["seed"])
            rules = make_rules(mesh, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads)
            t0 = time.perf_counter()
            try:
                with use_rules(rules):
                    logits, routes = moe_prefill(model, params, tokens)
            finally:
                del model, params
            out[dtype] = {"logits": logits, "routes": routes,
                          "prefill_s": time.perf_counter() - t0,
                          "local_experts": cfg.moe.n_experts // world}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def shard_moe(args, dev, card: str, store_dir: str) -> dict:
    """(b) phi3.5-moe at full width, one layer, a prefill of 4 x 4096
    tokens with its 16 experts over ``model`` = 2: two spawned ranks share
    the card over gloo (:func:`shard_moe_rank`).  The one-rank
    ``moe_ffn`` (no rules, this process) is the reference: each rank's
    routes equal its, the kept pairs those of the rank's own experts, and
    the logits within ``SHARD_MOE_TOL`` of max|y|; the ranks' logits
    equal.  Float32, then bf16 (at the bf16 bar) where gloo takes it."""
    opts = {"device": "cuda:0" if dev.type == "cuda" else "cpu",
            "rehearse": args.rehearse, "seed": args.seed + 310}
    refs = {}
    for dtype in SHARD_MOE_TOL:
        cfg, model, params, tokens = moe_prefill_case(opts, dev, dtype,
                                                      opts["seed"])
        refs[dtype] = moe_prefill(model, params, tokens)
        del model, params
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    t0 = time.perf_counter()
    ranks = run_ranks(shard_moe_rank, MESH_RANKS,
                      os.path.join(store_dir, "shard2"), store_dir, opts)
    out = {"world_s": time.perf_counter() - t0}
    E = cfg.moe.n_experts
    for dtype, tol in SHARD_MOE_TOL.items():
        got = [r[dtype] for r in ranks]
        if "refused" in got[0]:
            out[dtype] = {"gloo_refused": got[0]["refused"]}
            continue
        ref_logits, ref_routes = refs[dtype]
        require(np.array_equal(got[0]["logits"], got[1]["logits"]),
                f"shard (b) {dtype}: the ranks' logits differ")
        scale = float(np.abs(ref_logits).max())
        err = float(np.abs(got[0]["logits"] - ref_logits).max())
        routes_equal, kept_local = True, True
        for rank, g in enumerate(got):
            lo, hi = rank * E // MESH_RANKS, (rank + 1) * E // MESH_RANKS
            for (topi, kept), (rtopi, rkept) in zip(g["routes"],
                                                    ref_routes):
                routes_equal &= bool(np.array_equal(topi, rtopi))
                kept_local &= bool(np.array_equal(
                    kept, rkept & (topi >= lo) & (topi < hi)))
        out[dtype] = {"max_abs_err": err, "max_abs_logit": scale,
                      "err_over_max": err / scale, "tolerance": tol,
                      "routes_equal": routes_equal,
                      "kept_are_local": kept_local,
                      "experts_a_rank": got[0]["local_experts"],
                      "prefill_s": [g["prefill_s"] for g in got]}
        require(routes_equal and kept_local and err <= tol * scale,
                f"shard (b) {dtype}: expert parallelism != one rank: "
                f"{out[dtype]}")
    emit("shard", card=card, part="(b) phi3.5-moe prefill, experts over "
         "model = 2 (two ranks, gloo)", arch=cfg.name, layers=cfg.n_layers,
         ranks=MESH_RANKS, **out)
    return out


def shard_dryruns(args, card: str, trained: dict) -> dict:
    """(c) ``launch.dryrun`` cells on fake worlds of 256 (512) ranks, each
    ``OK``, with GB, FLOPs and collectives a rank; then (a)'s cell on a
    (1, 1) fake mesh: its parameter, master and moment bytes equal the
    bytes (a)'s state took from the card's allocator (as requested) and
    (a)'s local shards, its predicted peak beside (a)'s (no bar).  (d)
    ``launch.dryrun_pim`` logreg on the (16, 16) mesh at cadence 1 and
    8: ``OK``, one merge collective a round of k local steps."""
    cells = {}
    for arch, shape, multi in SHARD_DRYRUNS:
        kw = {}
        if args.rehearse:
            kw = dict(cfg=get_smoke_config(arch), batch=8, seq_len=64)
        r = dryrun.run_cell(arch, shape, multi, **kw)
        require(r["status"] == "OK", f"shard (c) {arch} {shape}: "
                f"{r.get('error')} {r.get('trace', '')[-1500:]}")
        cells[f"{arch} {shape} {r['mesh']}"] = {
            "gb_per_rank": r["memory"]["peak_per_device_gb"],
            "argument_gb": r["memory"]["argument_bytes"] / 2 ** 30,
            "flops_per_rank": r["cost_analysis"]["flops"],
            "collectives": r["collectives"],
            "bottleneck": r["roofline"]["bottleneck"],
            "step_time_bound_s": r["roofline"]["step_time_bound_s"],
            "mesh_device_type": r["mesh_device_type"],
            "trace_s": r["trace_s"]}
    cfg = (get_smoke_config if args.rehearse else get_config)(LM_ARCH)
    one = dryrun.run_cell(LM_ARCH, "train_4k", cfg=cfg, mesh_shape=(1, 1),
                          mesh_names=("data", "model"),
                          batch=trained["batch"], seq_len=trained["seq"])
    require(one["status"] == "OK", f"shard (c) (1, 1): {one.get('error')}")
    mem = one["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    step_peak = None
    if trained["peak_bytes"] is not None:
        # the card's peak less what was allocated before the steps,
        # plus the step's own arguments (state and batch)
        batch_bytes = mem["argument_bytes"] - mem["state_bytes"]
        step_peak = (trained["peak_bytes"] - trained["allocated_before_bytes"]
                     + trained["state_bytes"] + batch_bytes)
    # the dry run's bytes against what (a)'s state holds on the card: the
    # allocator's requested bytes over the state's making and placing
    # (a copy kept by DTensor, or any state beyond the shards, would show)
    held = trained["state_held"]
    if held is not None:
        require(held["requested"] == mem["state_bytes"]
                and held["allocated"] >= held["requested"],
                f"shard (c): the dry run's state bytes {mem['state_bytes']} "
                f"!= the card's {held}")
    same_bytes = mem["state_bytes"] == trained["state_bytes"]
    require(same_bytes, f"shard (c): the dry run's state bytes "
            f"{mem['state_bytes']} != (a)'s local shards' "
            f"{trained['state_bytes']}")
    pim = {}
    for k in SHARD_PIM_CADENCES:
        r = dryrun_pim.build(False, merge_every=k, chunk=2,
                             rows=(1 << 24) if not args.rehearse else 1 << 16)
        per_round = r["collectives_per_round"]
        require(r["status"] == "OK" and sum(
            c["count"] for c in per_round.values()) == 1
            and r["merge_overlap"]["dots"] == 3 * k,
            f"shard (d) cadence {k}: {per_round} {r['merge_overlap']}")
        pim[f"cadence {k}"] = {
            "gb_per_rank": r["memory_gb_per_device"],
            "collectives_per_round": per_round,
            "kernels_per_round": r["merge_overlap"]["dots"],
            "collectives_of_the_chunk": r["collectives"],
            "roofline": {key: r["roofline"][key] for key in (
                "compute_s", "memory_s", "collective_s", "bottleneck")}}
    out = {"cells": cells, "one_by_one": {
        "state_bytes": mem["state_bytes"],
        "local_shard_bytes": trained["state_bytes"],
        "card_state_requested_bytes": held and held["requested"],
        "card_state_allocated_bytes": held and held["allocated"],
        "state_bytes_equal": same_bytes,
        "predicted_peak_bytes": predicted,
        "card_peak_bytes": trained["peak_bytes"],
        "card_step_peak_bytes": step_peak,
        "predicted_over_card_step_peak": (predicted / step_peak
                                          if step_peak else None)},
        "pim": pim}
    emit("shard", card=card, part="(c) dry runs and (d) dryrun_pim", **out)
    return out


def shard_train_rank(rank: int, world: int, store: str, out_dir: str,
                     opts: dict) -> None:
    """(a) in a process of its own: ``torch.profiler`` lost a kernel event
    at the end of this long process (23 flash forwards of 24 in a step
    the counters saw whole), never in a fresh one."""
    dev = torch.device(opts["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    args = argparse.Namespace(rehearse=opts["rehearse"], seed=opts["seed"])
    out = shard_train(args, dev, opts["card"], out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def shard_phase(args, dev, card: str) -> dict:
    """Phase ``shard``: (a) :func:`shard_train` (in a child process), (b)
    :func:`shard_moe`, (c) and (d) :func:`shard_dryruns`; each
    ``require`` ends the run."""
    t0 = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="shard_")
    try:
        opts = {"device": "cuda:0" if dev.type == "cuda" else "cpu",
                "rehearse": args.rehearse, "seed": args.seed, "card": card}
        trained = run_ranks(shard_train_rank, 1, os.path.join(
            store_dir, "child"), store_dir, opts)[0]
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        shard_moe(args, dev, card, store_dir)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        shard_dryruns(args, card, trained)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    emit("shard", card=card, seconds=time.perf_counter() - t0)
    return trained


def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_kernel(mangled: str) -> str:
    """``name<args>`` of a kernel from its mangled name: the last of the
    length-prefixed identifiers after ``_Z``/``_ZN`` (past the anonymous
    namespace), then its template's integer and element type
    (``flash_bwd_dkdv_wgmma_kernel<128>``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = None
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        pos += len(m.group())
        name = mangled[pos:pos + int(m.group())]
        pos += len(name)
    if not name:
        return mangled[:60]
    tail = mangled[pos:]
    if not tail.startswith("I"):
        return name
    args = ["bf16"] if tail.startswith("I13__nv_bfloat16") else \
        ["float"] if tail.startswith("If") else []
    width = re.match(r"I\w*?Li(\d+)E", tail)
    return f"{name}<{', '.join(args + [width.group(1)] if width else args)}>"


def ptxas_summary(log: str) -> list:
    """Each kernel of ``nvcc -Xptxas -v``'s report: its registers, spill
    stores and the performance notes ptxas gave it (C7512: ``wgmma``
    serialised for want of registers; C7515 and the like: serialised for
    another reason), by code."""
    notes: dict = {}
    for code, fn in re.findall(r"\((C\d{4})\)[^\n]*?'(\w+)'", log):
        notes.setdefault(fn, []).append(code)
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        fn = part.split("'", 1)[0]
        spill = re.search(r"(\d+) bytes spill stores", part)
        regs = re.search(r"Used (\d+) registers", part)
        out.append({"kernel": ptxas_kernel(fn),
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "notes": sorted(set(notes.get(fn, [])))})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at 16 lanes x 2^14 rows with the "
                        "plain versions; prints no ok line")
    # train_ckpt's victim process (the script runs itself with it)
    p.add_argument("--ckpt-child", metavar="DIR", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cfg = CONFIG
    args.lanes = 16 if args.rehearse else cfg.n_vdpus
    args.rows = 2 ** 14 if args.rehearse else FULL_ROWS
    args.features, args.steps = cfg.reg_features, cfg.reg_steps
    args.cadence = cfg.merge_every
    args.cadence_steps = cfg.reg_steps // cfg.merge_every * cfg.merge_every
    args.linreg_steps, args.iters = LINREG_STEPS, TIMING_ITERS
    args.km_features, args.km_clusters = cfg.km_features, cfg.km_clusters
    args.km_iters = cfg.km_iters
    args.dt_features, args.dt_classes = cfg.dt_features, cfg.dt_classes
    args.dt_depth, args.dt_bins = cfg.dt_depth, cfg.dt_bins
    args.lm_seq = 256 if args.rehearse else LM_SEQ
    args.flash_slice = FLASH_SLICE_REHEARSE if args.rehearse else FLASH_SLICE
    args.flash_compare = {**args.flash_slice, **(
        FLASH_MOE_TRAIN_REHEARSE if args.rehearse else FLASH_MOE_TRAIN)}

    if args.rehearse:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script measures the "
                  "card (use --rehearse for a CPU dry run)", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
    if args.ckpt_child:
        return ckpt_child(args, dev, args.ckpt_child)
    smi = ("not measured (rehearsal on the CPU)" if args.rehearse
           else device_line())
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=(torch.cuda.get_device_name(0) if dev.type == "cuda"
               else "cpu"), nvidia_smi=smi)

    if dev.type == "cuda":
        t0 = time.perf_counter()
        logs = build.build_all()
        emit("build", seconds=time.perf_counter() - t0,
             built=sorted(logs), ptxas={k: ptxas_summary(v)
                                        for k, v in logs.items()})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    per_lane = args.rows // args.lanes
    emit("compare", fxp_matmul=compare_fxp(gen, args.lanes, per_lane,
                                           args.features),
         lut_activation=compare_lut(gen, args.lanes, per_lane))
    emit("compare", hybrid_matmul=compare_hybrid(gen, args.lanes, per_lane,
                                                 args.features),
         lut_activation_exp=compare_exp_lut(gen, args.lanes, per_lane))
    emit("compare", kmeans_assign=compare_km(
        gen, args.lanes, per_lane, args.km_features, args.km_clusters),
         split_hist=compare_sh(gen, args.lanes, per_lane, args.dt_features,
                               args.dt_bins, args.dt_classes))
    emit("compare", flash_attention=compare_flash(gen, args.lm_seq,
                                                  args.flash_compare))
    times = time_kernels(gen, args.lanes, per_lane, args.features,
                         args.iters)
    times["fxp_matmul"]["multinomial"] = {
        f"C={C}": time_fxp_multinomial(gen, args.lanes, per_lane,
                                       args.features, C, args.iters)
        for C in MN_CLASSES}
    times["kmeans_assign"] = time_km(gen, args.lanes, per_lane,
                                     args.km_features, args.km_clusters,
                                     args.iters)
    times["split_hist"] = time_sh(gen, args.lanes, per_lane,
                                  args.dt_features, args.dt_depth,
                                  args.dt_bins, args.dt_classes, args.iters)
    times["flash_attention"] = time_flash(gen, args.lm_seq, args.iters)
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    on_card = dev.type == "cuda"
    main_counts = {}
    wl, state, requests, seen, w_true = train(args, dev, smi)
    main_counts.update(fxp_matmul=seen["fxp_matmul"],
                       lut_activation=seen["lut_activation"])
    predict("logreg", wl, state, requests,
            expected(fxp_matmul=1, lut_activation=1), on_card)
    emit("predict", pad_invariance=pad_invariance(state, requests))
    with keeping_graph_nodes():
        serve_pim(args, dev, smi, wl, state, w_true)
    del state, requests
    wl, state, requests, seen = train_kmeans(args, dev, smi)
    main_counts["kmeans_assign"] = seen["kmeans_assign"]
    predict("kmeans", wl, state, requests, expected(), on_card)
    del state, requests
    wl, state, requests, seen = train_tree(args, dev, smi)
    main_counts["split_hist"] = seen["split_hist"]
    predict("dtree", wl, state, requests, expected(), on_card)
    del wl, state, requests
    main_counts["flash_attention"] = serve_lm(args, dev, smi)[
        "flash_attention"]
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    trained, times["flash_attention_bwd"] = train_lm(args, dev, smi)
    main_counts["flash_attention_bwd"] = trained["flash_attention_bwd"]
    times["flash_attention"]["train_lm_launches"] = trained["flash_attention"]
    times["flash_attention_bwd"]["launches_per_train_step"] = \
        trained["flash_attention_bwd"] // TRAIN_STEPS
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    for arch in REC_ARCHS:
        lm_recurrent(args, dev, smi, arch)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    slices = {ENCDEC_ARCH: lm_encdec(args, dev, smi),
              VLM_ARCH: lm_vlm(args, dev, smi)}
    for arch in MOE_ARCHS:
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        slices[arch] = lm_moe(args, dev, smi, arch)
    cases = {"whisper encoder": ENCDEC_ARCH, "llava": VLM_ARCH,
             **{case: arch for arch, case in MOE_CASES.items()}}
    for name in ("flash_attention", "flash_attention_bwd"):
        times[name]["slice_shapes"] = {
            case: slices[arch]["kernels"][name]
            for case, arch in cases.items()}
        times[name]["slice_launches"] = {
            arch: out["launches"] for arch, out in slices.items()}
    train_more(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_plans(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_wire(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_auto(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_mesh(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_ckpt(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_faults(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    train_stream(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    with keeping_graph_nodes():
        replayed = train_graph(args, dev, smi)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    tuned = autotune_phase(args, dev, smi)
    ops_phase(args, dev)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    shard_phase(args, dev, smi)

    kernels = []
    for name, t in times.items():
        src, replaces = SOURCES[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": main_counts[name],
                 "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t.get("library_ms"),
                 "library_note": LIBRARY_NOTES[name], "per": PER[name]}
        if name in tuned:
            # phase 15b: each tuned case's winner, its ms and the
            # heuristic's (a call each)
            entry["tuned"] = tuned[name]
        for run, (seen, steps) in replayed.items():
            if name in seen:
                # the main path's replays (train_graph, the graphs' kernel
                # nodes times their replays): the wrappers' "launches"
                # count a captured chunk's warm-up round and capture,
                # never a replay
                entry["replayed_launches"] = {"run": run, "steps": steps,
                                              "launches": seen[name]}
        for extra in ("single_call_ms", "host_ms", "parts", "multinomial", "int32_bins",
                      "split",
                      "float32_ms", "library_bf16_ms", "library_fp32_ms",
                      "library_max_abs_err", "library_fp32_max_abs_err",
                      "bit_equal_share",
                      "err_over_max_grad", "train_lm_launches",
                      "launches_per_train_step", "slice_shapes",
                      "slice_launches"):
            if extra in t:
                entry[extra] = t[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal finished; no result on the CPU",
              file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
