"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain version, train the d=1024/L=12 TransformerLM through
examples.lm.train(), run the lm_bench step, serve the same widths over
loopback Rpc and check the replies, serve them again through the
continuous-batching engine behind a broker-registered replica, run the
IMPALA learner at the reference Atari shape, fed once by EnvPool workers
through the Batcher,
then allreduce full-width ImpalaNet and TransformerLM gradients taken
from the card through the port's Broker and Group, train both in
two-learner Accumulator cohorts through the examples' own loops, run
the R2D2 agent's replay plane and learner at the JAX package's pixel
geometry, and then the fleet and durability plane: the LM stopped and
resumed from checkpoints, a distributed checkpoint committed by a
two-learner cohort and restored by one process, a profiler timeline of
the train step, and the shared kernel build cache; then the zero-crossing
actor plane: batched envs stepped on the card inside the act step, and
split over rank processes as Sebulba's actor and learner meshes; the
model-parallel LM meshes last.  After the engine, the same engine split
into a prefill rank and a decode rank.

    python3 chip_smoke.py [--seed N]

Before anything touches CUDA, an EnvPool of SyntheticAtariEnv (4 worker
processes, 32 envs, 2 batches) is forked for phase 9.  Phases (any failure
exits non-zero, and no result line is printed):

1. device — require CUDA; print the card's name and power limit.
2. build — compile every kernel source under moolib_tpu_torch/ops/csrc
   (one nvcc each, all at once); print ptxas's register and spill lines
   and, from `cuobjdump -sass` of each library, every kernel's
   tensor-core instructions (HGMMA, HMMA).  Fails if a bfloat16
   forward, dq or dk/dv kernel has none, or if a bfloat16 build of their
   CUDA-core kernels exists.
3. kernels — at the serving prefill shape, the training shape and others,
   causal and full, float32 and bfloat16: flash_fwd against its plain
   version, and the backward's dq and dk/dv kernels against the plain
   backward run in f32 on the same q, k, v, out, lse and cotangent; the
   backward twice, bitwise equal; one lse-cotangent case per shape.  One
   JSON line per case with the errors and CUDA-event times of the kernels,
   the plain versions and torch's scaled_dot_product_attention (timed as a
   yardstick only; the port never calls it): its forward, and its backward
   alone as the median, min and max of 5 timings of 10 calls.
4. model — small float32 TransformerLMs on the card: flash attention (the
   kernels) against dense attention (plain torch) on the same weights, in
   the forward, the greedy tokens and every parameter gradient; and the
   remat policies against no remat.
5. train — the slice: examples.lm.train() on lm.py's copy task at vocab
   32768, d_model 1024, 12 layers, 8 heads of 128, bf16, flash attention,
   B=16 x T=1024, 20 AdamW steps at learning rate 1e-4 (lm_bench's).  The
   losses must be finite and fall, and each flash kernel must have run at
   least 12 x 20 times.  Step times, tokens/s, peak memory and a
   torch.profiler window of one step.
6. lm_bench — benchmarks/lm_bench.py's step on the port: lm_head_xent with
   4096-wide vocab chunks, backward, AdamW(1e-4), at (T, B) = (1024, 16)
   with max_len 8192; the fused loss against the materialized one on the
   first step; step time and MFU counted as lm_bench counts it.
7. slice (serving) — the same widths with rotary positions served by
   examples.lm_serve.serve() to 4 concurrent 1024-token prompts from a
   client Rpc; replies must equal the port's own generate() on the same
   batch, and the prefill must have launched flash_fwd once per layer.
   Prefill and generate() times, the host's time to enqueue one prefill,
   and a torch.profiler window of each.
7b. engine — the continuous-batching serving tier at those widths
   (rotary, flash, bf16, max_len 1088): first flash_fwd against its plain
   version at every prefill bucket [1, Lb, 8, 128], Lb = 1 .. 1024, causal,
   bf16 and f32.  Then ContinuousBatchingEngine (8 slots, 16-token blocks,
   prompts to 1024, sequences to 1088: 545 blocks, a 428.6 MB bf16 pool)
   behind EngineService in a ServeReplica registered with a broker
   process; a ServeClient finds it through the broker.  Traffic (a): 32
   requests at once, prompt lengths uniform in 64..1024, budgets from
   {1, 8, 16, 32, 64}, greedy.  Every reply is its prompt plus its own
   budget of tokens; flash_fwd launches, counted from 0 after warmup(),
   equal 12 x 32 (one prefill per request); fewer decode steps than
   budgeted tokens; the pool drains (invariants hold, every block free, no
   slot active) and its data_ptr()s never move; each reply equals
   generate() of its prompt alone, or departs first where the reference's
   top-two logit gap is below 2e-2 x max(1, max|logit|).  An f32 run of
   the same engine with 2 layers (the CUDA-core forward) on 8 of the
   requests: replies equal generate() exactly.  Traffic (b): 16
   512-token prompts, budgets from {8, 16, 32, 64}, through the
   batch-synchronous replica (per-request budgets, cap 16) and then the
   engine replica.  Per arm: latency p50/p99 on the client's clock,
   emitted tokens/s, prefill ms by shape (CUDA events), decode ms per step,
   mean slot occupancy, padding tokens, iterations, peak memory; and the
   device idle share over a profiled window of 16 decode steps of each.
7c. disagg_engine — disaggregated prefill (slice 9c): the engine phase's
   LM from the same seed, ContinuousBatchingEngine(mesh=dp=2,
   prefill_devices=1) over two rank processes sharing the card over gloo:
   rank 0 prefills on the flash forward, rank 1 owns the engine, decodes,
   and serves traffic (a) through an engine replica as the engine phase
   does.  Checks: the replies equal the one-process engine's; flash_fwd
   launches, counted from 0 after warmup(), are exactly 12 x 32 on the
   prefill rank and 0 on the decode rank; the K/V bytes that crossed equal
   each joined request's [12, 2, Lb, 8, 128] bf16 rows and are counted
   once, by route.  Prints latency p50/p99, tokens/s, decode ms a step and
   the K/V handoff ms a request beside the one-process engine's.
8. impala_parity — ImpalaNet (feed-forward and LSTM, 84x84x4, f32 and
   bf16) and ActorCriticNet (LSTM, f32) on the card against the same model
   on the CPU, same weights and inputs: logits and baselines, then one
   step of examples.vtrace.experiment's compute_loss, backward and its
   clip + rmsprop update: the loss and every updated parameter, each
   within 1e-4 (f32) or 2e-2 (bf16) of max(1, max|CPU value|).
9. impala_learner — the slice: moolib_tpu_torch.bench's learner step
   (ImpalaNet (16, 32, 32) bf16, V-trace loss, backward, RMSProp) at
   T=20, B=32, 84x84x4, 6 actions, 200 steps: step times, frames/s,
   analytic TFLOP/s and MFU, peak memory, a torch.profiler window of 5
   steps (idle share, launches and device busy time per step, top device
   ops) and the host's time to issue one step.  Then the data
   path: actor forwards (T=1) and sampling on the card, actions back to the
   EnvPool through its CUDA-tensor seam, 21-step unrolls through
   Batcher(device="cuda") into 10 learner steps; each learner batch's
   frames must equal the shared-memory frames they came from.
10. cohort_impala — the cohort wire plane: a broker started with
   `python -m moolib_tpu_torch.broker` and four in-process peers (Rpc +
   Group).  Each holds one learner backward of the full-width ImpalaNet
   (bf16 compute, f32 parameters, no LSTM) at [T+1, B] = [21, 32] on its
   own seed's batch: 36 CUDA gradient leaves, 1,091,080 elements.  They
   reduce, as the dict of CUDA tensors it is, 20 rounds on each path: auto
   (the flat-bucket tree), the legacy tree, the ring, and the ring with the
   bf16 and q8 wires.  Every path: the four peers' result bytes equal, one
   pinned D2H staging event per peer round carrying every byte, and the
   result within rtol 1e-5, atol 1e-5 (f32 paths), 1e-2 x max|sum| (bf16)
   or 5e-2 x max|sum| (q8) of the float64 sum taken on the card.  Median
   round ms, the staging time and the bytes on the wire.  Then one
   GlobalStatsAccumulator round of the peers' losses and frames.
11. cohort_lm — two learner processes (spawned, each its own CUDA context
   on the card) build the d=1024 TransformerLM cut to CUT_LAYERS = 4 of
   its 12 blocks (the time budget's cut; max_len 1024, learned
   positions, bf16 compute, f32 parameters, flash attention) with the same
   weights, run one forward + backward each on their own B=4 x T=1024
   batch (the three flash kernels), and allreduce the f32 gradient 5
   times (auto: the flat-bucket tree).  Each result must equal
   grad_a + grad_b added on the card, bit for bit.  Round seconds,
   algorithm bandwidth, D2H staging and H2D-back times, peak memory.
12. accumulator_impala — the IMPALA training loop of slice 4b: two
   learner processes (spawned, one CUDA context each) run
   examples.vtrace.experiment.train(); learner 0 hosts the broker
   (--address), learner 1 joins (--connect).  Synthetic 84x84x4 uint8
   frames, the full-width ImpalaNet (16, 32, 32), no LSTM, bf16 compute,
   f32 parameters, 6 actions; unroll 20, learner batch 32, 2 actor batches
   of 32 envs over 4 env processes each, virtual batch 64, the device
   rollout, debug checksums on, to model version 50.  Both learners must
   end at the same version with bitwise-equal parameters (sha256 of the
   f32 parameters, compared here), zero checksum divergences, the
   non-leader synced through the chunked model transfer, and one
   buckets_d2h_events_total event per CUDA staging call.  SGD steps/s and
   learner frames/s across the cohort, count- and grad-round ms, model-sync
   bytes and ms, elections, env steps/s and act ms per learner, peak
   memory.
13. accumulator_lm — examples.lm's elastic path with the d=1024
   TransformerLM cut to 4 blocks (max_len 1024, learned positions, bf16,
   f32 parameters,
   flash attention) on B=4 x T=1024 per learner, virtual batch 8:
   learner 0 (--address) applies one step alone, then learner 1
   (--connect) joins, receives the f32 parameters and the AdamW state
   through the chunked model sync (the same blob sha as the leader's), and
   the two take 5 steps together.  Bitwise-equal parameters at the end;
   step and grad-round seconds, algorithm bandwidth, model-sync GB/s, mfu
   from telemetry.devmon, peak memory and each flash kernel's launches,
   counted from 0 in each learner.
14. r2d2_parity — the full-width pixel RecurrentQNet (18 actions, the
   (16, 32, 32) encoder, Dense 512, LSTM 512, dueling heads; 4,452,323
   parameters) on weights converted from the flax layout
   (models.convert.qnet_from_flax), at T+1 = 5, B = 4, f32 and bf16: q,
   the final core, examples.r2d2.td_loss's loss and priorities, and every
   gradient on the card against the CPU.  Values within 1e-5 (f32) or 2e-2
   (bf16) of max(1, max|CPU value|); gradients within 1e-4 (f32) or 5e-2
   (bf16) of the largest |CPU gradient|.  The CPU's max-pools take the
   inputs the card's took (PoolRoute; the windows that would choose
   differently are counted).
15. r2d2_learner — benchmarks/r2d2_bench.py's device arm at that
   geometry: a DeviceReplayShard of 4096 sequences of T = 80 (+1) at
   84x84x4 uint8 (9,383,809,024 B of ring on the card), filled from a pool
   of 64 synthetic items made from --seed, then 5 warm-up and 20 timed
   learner cycles (add 16, sample 64, time-major on the card, online and
   target forward, backward, clip_by_global_norm(40) + adam(1e-4), the
   target refreshed every 100 SGD steps, priority write-back of the device
   TD priorities).  Step ms (CUDA events and host clock), frames/s, the
   device ms of add, sample, update and write-back over a profiled window
   of 3 cycles, host issue against device busy, launches, peak memory,
   the update's counted FLOPs.  Checks: root = leaf sum, a 200-op schedule
   bitwise against the numpy SumTree fed the shard's own transform,
   last-wins duplicates, a short insert in bounds.
16. r2d2_replay — two ReplayShardService peers, each with a device shard,
   a ReplayPublisher and a DistributedReplay over ipc loopback: 4
   publishes of 32 x [21, 512] f32 counted once each (write-once memfd),
   both shards holding their stripes, a cohort draw's write-back landing
   on the owning shard; then examples.r2d2.train() on CartPole with the
   device shard for 3000 env steps (SGD steps, a finite loss, the shard
   on the card; env and SGD steps/s from the first log tick on).

17. durable_lm — examples.lm.train() at the train phase's widths cut to
   4 blocks and its batch with --checkpoint_dir in a fresh temporary directory: 10 steps,
   saved at 10; the example's resume() into a fresh model and AdamW
   equals the saved params and AdamW state bit for bit; a second train()
   resumes at 10 and goes to 20; then the newest checkpoint truncated
   (testing.faults), a third train() resumes from 10 and counts one
   checkpoint_corrupt_skipped.  Save and restore ms, GB written, launches.
18. dckpt_lm — two learner processes (spawned, one CUDA context each)
   hold the d=1024 LM cut to 4 blocks (B 4 x T 1024, bf16 compute, f32
   parameters)
   and AdamW on the card and take 6 steps through an Accumulator with
   enable_distributed_checkpoint(interval 1e-3, lead_steps 1, aux_fn
   steps).  The leader commits a cohort manifest; both shard reports carry
   its blob sha256.  This process restores it as a cohort of one (the
   2-host shards re-cut onto 1): the blob's sha equals the manifest's, the
   restored f32 parameters equal the learners' at that step (sha256) and
   give the same probe loss (one flash forward/backward on a fixed batch,
   compared exactly).  checkpoint_stall_seconds per capture,
   checkpoint_write_seconds, the restore's seconds.
19. timeline_lm — one telemetry.timeline window (a torch.profiler capture)
   over 5 train steps of the train phase's LM, each a
   devmon.dispatch_span: the trace names the three flash kernels 60 times
   each; every flash_fwd kernel starts after its step's dispatch began
   (the trace rebased through the window's clock marker); the compute,
   comm, host and idle seconds sum to the steps' wall time within 1%.
   Then a __telemetry_profile start/stop from a client Rpc over loopback
   writes a trace of one more step that names flash_fwd.
20. compile_cache — a child process with MOOLIB_COMPILE_CACHE at a fresh
   directory builds every kernel source there (nvcc seconds > 0); a second
   child, a restarted peer, loads every library from it (seconds 0.0).
21. anakin — the JAX package's Anakin operating point
   (benchmarks/agent_bench.py:167-176): catch_flat, ActorCriticNet (no
   LSTM), 256 x 2 = 512 envs on the card in one rollout, unroll 40, learner
   batch 128, virtual batch 512.  The seeding contract's draws (fold_in,
   split, bits, randint with a negative minval) for 4,096 keys, and
   JaxCatch and JaxProcCatch over 512 envs for 2,000 steps under a seeded
   action stream, on the card against the CPU: bitwise equal across every
   auto-reset.  AnakinRollout.unroll() against step() over two unrolls,
   bitwise.  At full width: the unroll's median ms (CUDA events), acting
   frames/s, launches per unroll and per body step (torch.profiler), the
   host's time to issue an unroll against the device's busy time; the
   actor_{h2d,d2h} and batcher_{h2d,d2h} byte counters must not move, and
   actor_stats_d2h_bytes_total must count exactly what stats() moved.
   Then examples.vtrace.experiment.train(--env_backend jax) at that
   configuration for the bench's 1.5M frames at learning rate 2e-2: sps,
   SGD steps, the mean episode return, which must clear the tier-1 bar
   (0.4), and again no byte across the boundary.

21b. sebulba — the Sebulba split (slice 9c) at the anakin point:
   examples.vtrace.experiment.train(--mesh dp=4 --actor_mesh 2), four rank
   processes sharing the card over gloo; ranks 0-1 are a dp=2 actor mesh
   of 256 envs each, ranks 2-3 the dp=2 learner (this process is rank 2,
   the loop), 400k frames.  Checks: the actor and learner ranks are
   disjoint; every unroll's columns reached their learner ranks byte for
   byte (sha256 per pair of ranks) and the handoff counted exactly the
   unrolls' bytes, d2d and staged by route; the actor ranks crossed no
   host-boundary bytes per frame; the learner ranks end with one set of
   parameters.  Prints each actor rank's unroll and handoff ms, the learn
   step ms, acting frames/s and sps beside the anakin phase's.
22. sharded_lm — the hierarchical learner: two elastic hosts through
   examples.lm.train() --shard_grads, each host 2 rank processes sharing
   the card over gloo (four processes, started once for the three arms),
   the d=1024 LM cut to 4 blocks (B 8 x T 1024 a host), host 0 one step
   alone, then 2 cohort steps; arm (a) --mesh dp=2 --overlap_grads (the
   hook-streamed backward), arm (b) --mesh dp=2 and the barrier step, arm
   (c) sp_overlap: --mesh sp=2 --attention ring --overlap_grads (the
   three flash kernels on each rank's ring chunks, [8, 512, 8, 128]).
   Checks: both hosts and every rank end with the same params sha, and
   the two dp arms too; the joiner host received the model and ships
   (N-1)/N of the flat payload a round (within half a bucket); every dp
   rank launches each flash kernel at least 4 x its learn steps, every sp
   rank exactly 4 x (sp rank + 1) x (learn steps + the warm-up); host 0's
   first loss, taken alone before the cohort forms, is the dp arms'
   within MP_LOSS_TOL relative.  Prints each arm's step seconds, exposed
   comm (step returned -> result ready) per round, accum_psum_seconds and
   host-staged collective bytes and peak memory per rank, and the phase's
   wall_s.
23. mp_lm — model parallelism (slice 9b's training half): three arms of
   examples.lm.train() at LM_WIDTHS (learned positions, bf16 compute, f32
   parameters, AdamW 1e-4), a warm-up step plus 2 steps, 4 rank processes
   (started once for the three arms) sharing the card over gloo: ring_lm (--mesh sp=4 --attention ring, B 1
   x T 4096, 4 blocks: the time budget's cut), moe_lm (--mesh dp=2,ep=2,
   8 experts on every second of 4 blocks, B 8 x T 1024), pipeline_lm (--mesh pp=4, 12 blocks as 3 laps of 4
   stages, 4 microbatches, B 4 x T 1024).  Checks: the warm-up step's
   global loss and every reduced gradient (experts gathered) against one
   process on the card with flash attention and every expert (the loss
   within MP_LOSS_TOL relative, each gradient leaf within MP_GRAD_TOL by
   its own relative norm); every rank ends with the same replicated parameters (experts
   per ep block); each flash kernel's launches per rank are exactly the
   path's count (ring: 4 x (sp rank + 1) a learn step, 4 x 10 over the
   group; moe: 4; pipeline: 3 blocks x 4 microbatches).  Prints step
   seconds, peak memory, host-staged bytes and ring hop seconds per rank,
   and the tokens over capacity in the last MoE step.
24. tp_lm — tensor parallelism (slice 9d) at LM_WIDTHS, 4 rank processes
   (started once for both arms) sharing the card over gloo.  tp_serve:
   examples.lm_serve.serve(mesh=) on a tp=4 mesh (every rank holds its
   blocks of the auto_shardings layout, attends its 2 of the 8 heads
   through the flash kernel and keeps those heads' KV cache) answers 4
   concurrent 1024-token prompts with 16 greedy tokens over Rpc.  Checks:
   one stacked batch; the last prompt position's prefill logits within
   TP_LOGIT_TOL of one process's; the replies equal one process's
   generate() up to a near-tie (reported); flash_fwd launched 12 times per
   rank; each rank holds a quarter of the cut leaves plus the replicated
   ones (both printed beside one process's bytes).  Prints prefill ms,
   decode ms per token, host-staged bytes and peak memory per rank.
   tp_train: parallel.make_train_step over dp=2 x tp=2 with
   params_sharding=auto_shardings, B 8 x T 1024 in all, AdamW 1e-4 on the
   copy task, a warm-up step plus 2.  Checks: the warm-up loss within
   MP_LOSS_TOL and every gathered gradient leaf within MP_GRAD_TOL of its
   norm against one process at the same global batch; replicated leaves
   equal on every rank and each block equal across dp; each flash kernel
   launched exactly 12 times a step per rank; every rank's peak memory
   below one process's.  The kernels phase also holds every kernel against
   its plain version at tp_lm's per-rank shapes, [4, 1024, 2, 128] and
   [4, 1024, 4, 128], and at sharded_lm's sp ring chunk, [8, 512, 8, 128].
25. serve_soak — the port's serving-plane soak (moolib_tpu_torch.scripts.
   serve_soak, its --engine arm) at the engine phase's LM (vocab 32768,
   d 1024, 12 x 8 heads of 128, bf16, flash attention; 8 slots of 16-token
   blocks): two lm_serve --engine replica processes on the card behind a
   broker, 512-token prompts with 16 new tokens for a 20 s window at 8
   requests/s (or half of what one replica sustains, measured during the
   warm-up, when that is less), one replica SIGKILLed at the seeded time
   and the full-width weights hot-swapped at 0.8 of the window.  Checks:
   every soak gate (zero lost requests, the swap installed, no admission
   rejects across it); the survivor's flash_fwd launches, counted from 0
   after its warm-up, exactly 12 x the prefills it ran, and no backward
   launch.  Prints the verdict's rate, latency, swap seconds and the card's
   free memory before and after.
26. chaos_soak — the port's seeded chaos soak (moolib_tpu_torch.scripts.
   chaos_soak --smoke), all four phases, its LM peers on the card at d 256,
   2 heads of 128, 2 blocks, vocab 4096, T 256, B 2, flash attention,
   --steps 30.  Its main() runs in a process of its own that never touches
   CUDA (so the EnvPool of its first phase forks its workers), started
   before mp_lm and running beside mp_lm, tp_lm and serve_soak.
   Checks: every soak gate (the EnvPool respawn; the respawned peer's
   recovery within its bound and the peer's seeded frame faults under
   MOOLIB_FAULTS; the resume from the newest intact checkpoint; no torn
   checkpoint eligible, the 1-host resume from the newest commit and the
   capture stall under 10% of a step); the resumed peer of phase 4 and the
   broker-hosting peer of phase 2 launched each kernel exactly 2 x (their
   learns + the warm-up).  The kernels phase also holds the kernels at the
   two soaks' shapes, [1, 512, 8, 128] and [2, 256, 2, 128].

The last two lines are the kernel summary {"kernels": [...]}, with each
kernel's time, TFLOP/s, share of bound and tensor-core instruction count
at the training shape and its launches on every path (the r2d2, anakin
and sebulba phases launch none: no Pallas kernel is on those paths; durable_lm,
dckpt_lm and timeline_lm are the LM's forward and backward), and {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from moolib_tpu_torch import bench, buckets, rollout, telemetry
from moolib_tpu_torch.batcher import Batcher
from moolib_tpu_torch.envpool import EnvPool
from moolib_tpu_torch.envs import SyntheticAtariEnv, _threefry, jax_envs
from moolib_tpu_torch.examples import lm, r2d2
from moolib_tpu_torch.examples.common import (GlobalStatsAccumulator, OptaxOptimizer, adam,
                                              clip_by_global_norm)
from moolib_tpu_torch.examples.lm_serve import serve
from moolib_tpu_torch.examples.vtrace import experiment
from moolib_tpu_torch.models.actor_critic import ActorCriticNet
from moolib_tpu_torch.models.convert import qnet_from_flax
from moolib_tpu_torch.models import impala as impala_model
from moolib_tpu_torch.models.impala import ImpalaNet
from moolib_tpu_torch.models.qnet import RecurrentQNet
from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import _build
from moolib_tpu_torch.ops import flash_attention as fa
from moolib_tpu_torch.ops.xent import lm_head_xent, naive_softmax_xent
from moolib_tpu_torch.group import Group
from moolib_tpu_torch.replay import (DeviceReplayShard, DistributedReplay, ReplayPublisher,
                                     ReplayShardService, SumTree, payload_bytes)
from moolib_tpu_torch.rpc import Rpc, serialization
from moolib_tpu_torch.utils import nest
from moolib_tpu_torch.utils.stats import StatMean, StatSum

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and float32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SHAPES = [(1, 128, 2, 64), (4, 1024, 8, 128), (16, 1024, 8, 128), (2, 1000, 8, 128),
                 (1, 4096, 8, 128), (4, 1024, 2, 128), (4, 1024, 4, 128), (8, 512, 8, 128),
                 (1, 512, 8, 128), (2, 256, 2, 128)]
SERVE_SHAPE = (4, 1024, 8, 128)  # the serving prefill: 4 prompts x 1024, 8 heads of 128
TRAIN_SHAPE = (16, 1024, 8, 128)  # the training step: 16 x 1024, 8 heads of 128
# tp_lm's shapes: a tp=4 rank's prefill (8 heads / 4), a dp=2 x tp=2 rank's
# training step (B 8 / 2, 8 heads / 2).
TP_SERVE_SHAPE = (4, 1024, 2, 128)
TP_TRAIN_SHAPE = (4, 1024, 4, 128)
# sharded_lm's sp_overlap arm: a ring chunk of an sp=2 rank (B 8, T 1024 / 2),
# causal on the diagonal chunk and not on the past one.
SP_CHUNK_SHAPE = (8, 512, 8, 128)
# The fleet soaks' shapes: serve_soak's prefill of one 512-token prompt,
# chaos_soak's LM peers' learn (B 2, T 256, 2 heads of 128).
SERVE_SOAK_SHAPE = (1, 512, 8, 128)
CHAOS_SOAK_SHAPE = (2, 256, 2, 128)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # fwd (out, lse) atol
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # backward, x max(1, max|ref|)
TRAIN_STEPS = 20
# The time budget's depth cuts (PERF.md §4): cohort_lm, accumulator_lm,
# durable_lm, dckpt_lm and mp_lm's ring and moe arms run CUT_LAYERS of the
# LM's 12 blocks, so that the whole script keeps its margin under the
# limit with tp_lm in it.
CUT_LAYERS = 4
# The repo's LM at lm_bench's widths (benchmarks/lm_bench.py:54-57,109-114).
LM_WIDTHS = ["--vocab", "32768", "--d_model", "1024", "--layers", "12", "--heads", "8"]
# impala_parity: card against CPU, error over max(1, max|CPU value|).
PARITY_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# impala_learner's data path: the actor fleet of one learner.
POOL = dict(num_processes=4, batch_size=32, num_batches=2)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_call_ms(fn, reps: int) -> tuple:
    """(median, min, max) milliseconds of single calls, each timed by CUDA
    events, after one warm-up call.  For host-bound work, whose time
    varies from call to call with the host's load."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def enqueue_ms(fn, reps: int) -> float:
    """Median host milliseconds to enqueue one call of ``fn``, the card idle
    at the start of each and not waited for at the end.  Where it is most of
    the call's CUDA-event time, the call is bound by the host."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(ops: float, nbytes: float, dtype) -> tuple:
    """The least time for the work: the larger of its operations over the
    peak rate for ``dtype`` and its bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def flash_bounds(B, T, H, D, dtype, causal: bool) -> dict:
    """(bound ms, bound by, operations) of the three kernels on these
    inputs.  Per attended (query, key) pair: the forward does 2 products of
    2*D operations, the dq pass 3 (s, dp, dq) and the dk/dv pass 4 (s, dp,
    dv, dk).  Bytes: each [B, T, H, D] tensor read or written once
    (forward: q, k, v, out; dq pass: q, k, v, dO, dq; dk/dv pass: q, k, v,
    dO, dk, dv) plus the f32 row tables (forward: lse; backward: lse and
    delta)."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    tensor = B * T * H * D * (torch.finfo(dtype).bits // 8)
    row = B * T * H * 4
    work = {"flash_fwd": (4 * D * pairs, 4 * tensor + row),
            "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * row),
            "flash_bwd_dkv": (8 * D * pairs, 6 * tensor + 2 * row)}
    return {name: (*bound_ms(ops, nbytes, dtype), ops) for name, (ops, nbytes) in work.items()}


def device_profile(fn, top: int = 10) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    device-busy total against the window's wall time, and launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, wall_ms, top)


def profile_summary(prof, wall_ms: float, top: int = 10, exclude=()) -> dict:
    """Device kernels by time over a profiled window; ``exclude`` names
    record_function ranges, which the trace may also list on the device."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in exclude]
    rows = sorted(((e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": sum(r[2] for r in rows),
            "top": [[name, ms, n] for name, ms, n in rows[:top]],
            # The flash kernels' own device time, wherever they rank.
            "flash": [[name, ms, n] for name, ms, n in rows if "flash_" in name]}


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    # References compute in true float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
         "name": torch.cuda.get_device_name(0), "smi": smi})
    return smi


def kernel_label(mangled: str) -> str:
    """``kernel<dtype,D,causal|full>`` from a mangled kernel name, which
    carries the template arguments (``Li<D>E``, ``Lb<0|1>E``) and the
    pointer types (``__nv_bfloat16`` or ``f``)."""
    kernel = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)(?:_wgmma)?_kernel)", mangled)
    d = re.search(r"Li(\d+)E", mangled)
    causal = re.search(r"Lb([01])E", mangled)
    return (f"{kernel.group(1) if kernel else mangled}"
            f"<{'bf16' if 'bfloat16' in mangled else 'f32'},"
            f"{d.group(1) if d else '?'},"
            f"{'causal' if causal and causal.group(1) == '1' else 'full'}>")


def ptxas_report(nvcc_log: str) -> dict:
    """ptxas -v's registers and spills per compiled kernel (its shared
    memory line counts static shared memory; these kernels take theirs
    dynamically, sized in the sources)."""
    out, name = {}, None
    for ln in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = []
        elif name is not None and ("spill" in ln or "Used" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def sass_report(lib_path: str) -> dict:
    """Tensor-core instructions (``HGMMA``: wgmma; ``HMMA``: mma.sync) in
    each kernel's machine code, read with cuobjdump from the built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in out[name]:
                out[name][op] += bool(re.search(rf"\b{op}\.", ln))
    return out


def check_tensor_cores(sass: dict) -> None:
    """Every bfloat16 instantiation of the three kernels runs on the tensor
    cores: a wgmma kernel for each (D, causal) with HGMMA instructions in
    it, and no bfloat16 build of their CUDA-core kernels."""
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                   "flash_bwd_dkv_wgmma_kernel"):
        for d in (64, 128):
            for mode in ("causal", "full"):
                name = f"{kernel}<bf16,{d},{mode}>"
                if not sass.get(name, {}).get("HGMMA"):
                    raise AssertionError(f"build: {name} has no HGMMA instruction ({sass.get(name)})")
    cuda_core = [n for n in sass if n.startswith(
        ("flash_fwd_kernel<bf16", "flash_bwd_dq_kernel<bf16", "flash_bwd_dkv_kernel<bf16"))]
    if cuda_core:
        raise AssertionError(f"build: bf16 CUDA-core kernels were built: {cuda_core}")


def phase_build() -> dict:
    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    sass = {name: sass_report(path) for name, path in paths.items()}
    log({"phase": "build", "seconds": seconds, "libraries": paths,
         "ptxas": {name: ptxas_report(info["log"])
                   for name, info in _build.build_info.items()},
         "sass_tensor_core_instructions": sass})
    merged = {k: v for lib in sass.values() for k, v in lib.items()}
    check_tensor_cores(merged)
    return merged


def _rel_err(got, want) -> tuple:
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def _sdpa_bwd_ms(q, k, v, g, causal: bool) -> dict:
    """SDPA's whole backward (the library row): its forward runs once with
    the graph kept, then only ``torch.autograd.grad(..., retain_graph=True)``
    is timed by CUDA events: the median, min and max ms of 5 timings of 10
    calls each.  Beside them the device time of one call's kernels
    (torch.profiler), which the host's time to issue the call cannot
    inflate."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out, gt = sdpa(qt, kt, vt, is_causal=causal), g.transpose(1, 2)

    def bwd():
        torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    times = [cuda_ms(bwd, reps=10, warmup=2 if i == 0 else 0) for i in range(5)]
    return {"sdpa_bwd_ms": float(np.median(times)), "sdpa_bwd_ms_min": min(times),
            "sdpa_bwd_ms_max": max(times),
            "sdpa_bwd_device_ms": device_profile(bwd)["device_busy_ms"]}


def phase_kernels(gen: torch.Generator) -> dict:
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = {}
    for B, T, H, D in KERNEL_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, g = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
                              for _ in range(4))
                out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
                torch.cuda.synchronize()
                p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(),
                                                             causal)
                err_out = (out.float() - p_out).abs().max().item()
                err_lse = (lse - p_lse).abs().max().item()
                tol_out, tol_lse = TOL[dtype]
                if not (err_out <= tol_out and err_lse <= tol_lse):
                    raise AssertionError(
                        f"flash_fwd {B, T, H, D} causal={causal} {dtype}: "
                        f"out err {err_out} (atol {tol_out}), lse err {err_lse} (atol {tol_lse})"
                    )
                worst["flash_fwd"] = max(worst["flash_fwd"], err_out, err_lse)
                del p_out, p_lse

                # Backward: the two kernels against the plain version in f32
                # on the same inputs, as the training step calls them (no
                # lse cotangent).
                ops = fa._bwd_operands(q, k, v, out, lse, g, None)
                dq = fa._flash_bwd_dq_cuda(*ops, causal)
                dk, dv = fa._flash_bwd_dkv_cuda(*ops, causal)
                torch.cuda.synchronize()
                plain = lambda g_lse=None: fa._flash_backward_plain(  # noqa: E731
                    q.float(), k.float(), v.float(), out.float(), lse, g.float(), g_lse, causal)
                errs = {}
                for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain()):
                    errs[name], rel = _rel_err(got, want)
                    if not rel <= BWD_TOL[dtype]:
                        raise AssertionError(
                            f"flash_bwd {B, T, H, D} causal={causal} {dtype}: {name} err "
                            f"{errs[name]} is {rel} of max(1, max|ref|) (tol {BWD_TOL[dtype]})")
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
                worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
                again = fa._flash_bwd_cuda(q, k, v, out, lse, g, None, causal)
                if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
                    raise AssertionError(f"flash_bwd {B, T, H, D} causal={causal} {dtype}: "
                                         "two runs on the same inputs are not bitwise equal")
                del again

                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal), reps=20)
                dq_ms = cuda_ms(lambda: fa._flash_bwd_dq_cuda(*ops, causal), reps=10)
                dkv_ms = cuda_ms(lambda: fa._flash_bwd_dkv_cuda(*ops, causal), reps=10)
                plain_ms = cuda_ms(lambda: fa._blockwise_attention_plain(q, k, v, causal),
                                   reps=2, warmup=1)
                plain_bwd_ms = cuda_ms(plain, reps=2, warmup=1)
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                sdpa_ms = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), reps=20)
                bounds = flash_bounds(B, T, H, D, dtype, causal)
                case = {"case": "flash", "shape": [B, T, H, D], "causal": causal,
                        "dtype": str(dtype).replace("torch.", ""), "err_out": err_out,
                        "err_lse": err_lse, "err_dq": errs["dq"], "err_dk": errs["dk"],
                        "err_dv": errs["dv"], "bitwise_repeat": True, "ms": ms,
                        "plain_ms": plain_ms, "sdpa_ms": sdpa_ms, "dq_ms": dq_ms,
                        "dkv_ms": dkv_ms, "plain_bwd_ms": plain_bwd_ms,
                        **_sdpa_bwd_ms(q, k, v, g, causal),
                        "bound_ms": {n: b[0] for n, b in bounds.items()},
                        "bound_by": {n: b[1] for n, b in bounds.items()},
                        "tflops": {n: bounds[n][2] / t / 1e9 for n, t in
                                   (("flash_fwd", ms), ("flash_bwd_dq", dq_ms),
                                    ("flash_bwd_dkv", dkv_ms))}}
                log(case)
                if dtype == torch.bfloat16 and (causal or (B, T, H, D) == SP_CHUNK_SHAPE):
                    cases[(B, T, H, D, causal)] = case
                del q, k, v, g, out, lse, ops, dq, dk, dv

        # A differentiable lse: its cotangent folds into delta.
        q, k, v, g = (torch.randn(B, T, H, D, generator=gen, device="cuda") for _ in range(4))
        g_lse = torch.randn(B, T, H, generator=gen, device="cuda")
        out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
        got = fa._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, True)
        want = fa._flash_backward_plain(q, k, v, out, lse, g, g_lse, True)
        rels = [_rel_err(a, b)[1] for a, b in zip(got, want)]
        if not max(rels) <= BWD_TOL[torch.float32]:
            raise AssertionError(f"flash_bwd {B, T, H, D} with g_lse: rel errs {rels}")
        log({"case": "flash_bwd_g_lse", "shape": [B, T, H, D], "rel_errs": rels})
        del q, k, v, g, g_lse, out, lse, got, want
    return {"worst": worst, "serve": cases[(*SERVE_SHAPE, True)],
            "train": cases[(*TRAIN_SHAPE, True)], "tp_serve": cases[(*TP_SERVE_SHAPE, True)],
            "tp_train": cases[(*TP_TRAIN_SHAPE, True)],
            "sp_diagonal": cases[(*SP_CHUNK_SHAPE, True)],
            "sp_past": cases[(*SP_CHUNK_SHAPE, False)],
            "serve_soak": cases[(*SERVE_SOAK_SHAPE, True)],
            "chaos_soak": cases[(*CHAOS_SOAK_SHAPE, True)]}


def _model_grads(model, tokens):
    logp = torch.log_softmax(model(tokens)[:, :-1], -1)
    loss = -logp.gather(-1, tokens[:, 1:, None]).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def phase_model(gen: torch.Generator) -> None:
    """The kernels inside the model: flash vs dense attention, same weights,
    forward, greedy tokens and gradients; then the remat policies."""
    cfg = dict(vocab_size=512, d_model=256, num_heads=2, num_layers=2, max_len=320,
               dtype=torch.float32, pos_embedding="rotary", device="cuda")

    def build(attention, **kw):
        return TransformerLM(attention=attention, generator=torch.Generator().manual_seed(1),
                             **cfg, **kw)

    flash, dense = build("flash"), build("dense")
    tokens = torch.randint(0, 512, (2, 300), generator=gen, device="cuda")
    with torch.inference_mode():
        lf, ld = flash(tokens), dense(tokens)
        gf, gd = generate(flash, tokens[:, :256], 16), generate(dense, tokens[:, :256], 16)
    err = (lf - ld).abs().max().item()
    if not (torch.isfinite(lf).all() and err <= 1e-3):
        raise AssertionError(f"model logits: flash vs dense max err {err} (atol 1e-3)")
    if not torch.equal(gf, gd):
        raise AssertionError("model: greedy tokens differ between flash and dense attention")

    (loss_f, grads_f), (loss_d, grads_d) = _model_grads(flash, tokens), _model_grads(dense, tokens)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    grad_rel = max((grads_f[n] - grads_d[n]).abs().max().item()
                   / grads_d[n].abs().max().item() for n in grads_d)
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-3):
        raise AssertionError(f"model gradients: flash vs dense loss rel {loss_rel} (1e-5), "
                             f"worst grad rel {grad_rel} (1e-3)")
    remat_err = {}
    for policy in ("full", "dots", "dots_no_batch"):
        _, grads_r = _model_grads(build("flash", remat=True, remat_policy=policy), tokens)
        remat_err[policy] = max((grads_r[n] - grads_f[n]).abs().max().item() for n in grads_f)
        if not remat_err[policy] <= 2e-5:
            raise AssertionError(f"remat {policy}: grads differ by {remat_err[policy]} (2e-5)")
    log({"phase": "model", "logits_max_abs_err": err, "atol": 1e-3, "tokens_equal": True,
         "loss_rel_err": loss_rel, "grad_worst_rel_err": grad_rel,
         "remat_grad_max_abs_err": remat_err})


def _counts() -> dict:
    return {"flash_fwd": fa.flash_fwd_launches(), "flash_bwd_dq": fa.flash_bwd_dq_launches(),
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches()}


def mfu(step_ms: float, n_matmul_params: int, B: int, T: int, L: int, d: int) -> dict:
    """lm_bench's accounting (benchmarks/lm_bench.py:119-126,188-202):
    6*N*tokens, plus 6*L*B*T^2*d for causal attention, over the bf16 peak."""
    flops = 6.0 * n_matmul_params * B * T
    attn = 6.0 * L * B * T * T * d
    sec = step_ms / 1e3
    return {"n_matmul_params": n_matmul_params, "tflop_6nd": flops / 1e12,
            "tflop_attn": attn / 1e12, "mfu_6nd": flops / sec / PEAK_FLOPS[torch.bfloat16],
            "mfu_attn": (flops + attn) / sec / PEAK_FLOPS[torch.bfloat16]}


def matmul_params(model) -> int:
    """Parameters that take part in matmuls: all but the embedding tables
    (lm_bench's N)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith(("embed.", "pos.")))


def lm_matmul_params(vocab: int, d: int, layers: int) -> int:
    """The same N from the widths: per block qkv, proj and the two MLP
    layers (12*d*d weights, 9*d biases) and two LayerNorms (4*d), then
    ln_f and lm_head.  184,743,936 at vocab 32768, d 1024, 12 layers."""
    return layers * (12 * d * d + 13 * d) + 2 * d + d * vocab + vocab


def phase_train(seed: int) -> dict:
    B, T = 16, 1024
    flags = lm.make_flags(LM_WIDTHS + [
        "--seq_len", str(T), "--batch_size", str(B), "--attention", "flash", "--mesh", "",
        "--steps", str(TRAIN_STEPS), "--log_interval", "1", "--learning_rate", "1e-4",
        "--seed", str(seed), "--quiet",
    ])
    stats, ends = [], []
    window = {}

    def on_stats(s):
        # Called after each step's loss reached the host (the log line's
        # sync), so consecutive events bracket one whole step.
        stats.append(s)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        if s["step"] == TRAIN_STEPS - 1:  # profile the last step
            from torch.profiler import ProfilerActivity, profile

            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        elif s["step"] == TRAIN_STEPS:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].__exit__(None, None, None)

    # The main path: counts start at 0 here and are read right after.
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = lm.train(flags, on_stats=on_stats)
    wall_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()

    losses = [s["loss"] for s in stats]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: first {losses[0]}, last {losses[-1]}")
    need = 12 * TRAIN_STEPS
    if min(launches.values()) < need:
        raise AssertionError(f"train: kernel launches {launches}, each must be >= {need}")
    # Steps 2 .. TRAIN_STEPS-1: the profiled last step is left out.
    step_ms = [a.elapsed_time(b) for a, b in zip(ends[:-2], ends[1:-1])]
    median_ms = float(np.median(step_ms))
    res = {"phase": "train", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 "
           "learned positions, flash attention", "batch": B, "seq_len": T,
           "learning_rate": 1e-4, "steps": out["steps"], "losses": losses, "acc": out["acc"],
           "launches": launches, "step_ms_median": median_ms, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "tokens_per_s_median": B * T / (median_ms / 1e3),
           "tokens_per_s_train": out["tokens_per_s"], "train_wall_s": wall_s,
           "max_memory_allocated": peak,
           **mfu(median_ms, lm_matmul_params(32768, 1024, 12), B, T, 12, 1024)}
    log(res)
    log({"phase": "train_profile", "window": "one train step (make_batch, forward, backward, "
         "AdamW, loss to host)", **profile_summary(window["prof"], window["wall_ms"])})
    return res


def phase_lm_bench(seed: int) -> dict:
    B, T, steps = 16, 1024, 6
    model = TransformerLM(
        vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, max_len=8192,
        attention="flash", dtype=torch.bfloat16, device="cuda",
        generator=torch.Generator().manual_seed(seed),
    )
    opt = lm.make_optimizer(model.parameters(), 1e-4)
    toks = torch.from_numpy(np.random.default_rng(T).integers(0, 32768, size=(B, T))).cuda()

    # The fused loss against the materialized one on the first step's weights.
    with torch.no_grad():
        fused = lm_head_xent(model, toks, chunk_size=4096).item()
        feats = model(toks, return_features=True)[:, :-1].reshape(B * (T - 1), -1)
        naive = naive_softmax_xent(feats, model.lm_head.kernel, model.lm_head.bias,
                                   toks[:, 1:].reshape(-1)).item()
        del feats
    rel = abs(fused - naive) / abs(naive)
    if not rel <= 1e-3:
        raise AssertionError(f"lm_bench: fused xent {fused} vs naive {naive}: rel {rel} (1e-3)")

    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        loss = lm_head_xent(model, toks, chunk_size=4096)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    med, lo, hi = median_call_ms(step, reps=steps)
    launches = _counts()
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)) or min(launches.values()) < 12 * steps:
        raise AssertionError(f"lm_bench: losses {losses}, launches {launches}")
    n_params = matmul_params(model)
    if n_params != lm_matmul_params(32768, 1024, 12):
        raise AssertionError(f"lm_bench: {n_params} matmul parameters")
    res = {"phase": "lm_bench", "xent": "fused", "xent_chunk": 4096, "T": T, "B": B,
           "max_len": 8192, "fused_loss": fused, "naive_loss": naive, "fused_rel_err": rel,
           "losses": losses, "launches": launches, "step_ms_median": med, "step_ms_min": lo,
           "step_ms_max": hi, "tokens_per_s": B * T / (med / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **mfu(med, n_params, B, T, 12, 1024)}
    log(res)
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_slice(seed: int) -> dict:
    B, Tp, new = 4, 1024, 32
    t0 = time.perf_counter()
    model = TransformerLM(
        vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, attention="flash",
        dtype=torch.bfloat16, pos_embedding="rotary", max_len=Tp + new, device="cuda",
        generator=torch.Generator().manual_seed(seed),
    ).eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(0, 32768, (B, Tp)).astype(np.int32)

    port = free_port()
    server, client = Rpc(), Rpc()
    server.set_name("lm_server")
    server.listen(f"127.0.0.1:{port}")
    client.set_name("lm_client")
    client.set_timeout(600)
    client.connect(f"127.0.0.1:{port}")
    try:
        # The serving path: counts start at 0 here and are read right after.
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        coro = serve(server, model, new, batch_size=B, total=B)
        t_send = time.perf_counter()
        futs = [client.async_("lm_server", "generate", p) for p in prompts]
        # All four must sit in the queue before the loop starts, so they are
        # served as one stacked batch.
        deadline = time.monotonic() + 60
        while client.sync("lm_server", "generate_stats")["depth_max"] < B:
            if time.monotonic() > deadline:
                raise TimeoutError("requests did not reach the server queue")
            time.sleep(0.01)
        result = {}
        th = threading.Thread(target=lambda: result.setdefault("it", asyncio.run(coro)))
        th.start()
        replies = [np.asarray(f.result(600)) for f in futs]
        latency_ms = (time.perf_counter() - t_send) * 1e3
        th.join(600)
        if th.is_alive():
            raise TimeoutError("serve loop did not finish")
        launches = fa.flash_fwd_launches()
        peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        client.close()
        server.close()

    if result.get("it") != 1:
        raise AssertionError(f"expected one stacked batch, served in {result.get('it')} iterations")
    if launches < model.num_layers:
        raise AssertionError(f"flash_fwd launched {launches} times in the serving path, "
                             f"expected >= {model.num_layers}")
    got = np.stack(replies)
    if got.shape != (B, Tp + new) or not np.array_equal(got[:, :Tp], prompts):
        raise AssertionError(f"replies have shape {got.shape} or lost their prompts")
    if not ((got >= 0) & (got < 32768)).all():
        raise AssertionError("reply tokens out of vocabulary range")
    with torch.inference_mode():
        batch = torch.from_numpy(prompts)
        want = generate(model, batch, new).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError("served replies differ from generate() on the same batch")
        # Phase times on the same batch, outside the served run.
        dev_batch = batch.cuda()
        prefill_ms, _, _ = median_call_ms(lambda: model.prefill(dev_batch), reps=5)
        prefill_enqueue_ms = enqueue_ms(lambda: model.prefill(dev_batch), reps=5)
        gen_ms, gen_min, gen_max = median_call_ms(lambda: generate(model, dev_batch, new),
                                                  reps=5)
        profile = device_profile(lambda: generate(model, dev_batch, new))
        prefill_profile = device_profile(lambda: model.prefill(dev_batch))
    decode_ms = (gen_ms - prefill_ms) / (new - 1)
    out = {"phase": "slice", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 rotary",
           "batch": B, "prompt_len": Tp, "max_new_tokens": new, "init_s": init_s,
           "flash_fwd_launches": launches, "request_latency_ms": latency_ms,
           "prefill_ms": prefill_ms, "prefill_enqueue_ms": prefill_enqueue_ms,
           "generate_ms": gen_ms, "generate_ms_min": gen_min,
           "generate_ms_max": gen_max, "decode_ms_per_token": decode_ms,
           "max_memory_allocated": peak_bytes, "native_codec": serialization.native_available(),
           "replies_equal_generate": True}
    log(out)
    log({"phase": "profile", "window": "generate(4 x 1024 prompt, 32 new tokens)", **profile})
    log({"phase": "prefill_profile", "window": "model.prefill(4 x 1024 prompt)",
         **prefill_profile})
    return out


# The engine phase: the d=1024/L=12 LM (rotary, flash, bf16 compute, f32
# parameters) behind the continuous-batching engine, sized so every slot can
# hold a 1024-token prompt and 64 new tokens: 545 blocks of 16 tokens.
ENGINE_LM = dict(vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, max_len=1088,
                 pos_embedding="rotary", attention="flash")
ENGINE = dict(slots=8, block_size=16, max_prompt_len=1024, max_seq_len=1088)
# Traffic (a): mixed prompts and budgets through the replica; traffic (b):
# the same 512-token prompts through the batch-synchronous replica and the
# engine replica; the f32 exactness run; the profiled decode windows.
ENGINE_TRAFFIC = dict(requests=32, prompt=(64, 1024), budgets=(1, 8, 16, 32, 64),
                      b_requests=16, b_prompt=512, b_budgets=(8, 16, 32, 64), b_batch=16,
                      exact_layers=2, exact_requests=8, window_steps=16)
LOGIT_MARGIN = 2e-2  # bf16: a divergence needs a top-two gap below this x max(1, max|logit|)


class _ServeTimer:
    """Server-side clocks of one model and engine, for the ``with`` block
    only: CUDA events around every ``model.prefill`` (by input shape),
    around every call of a batch-synchronous step, and the host clock and
    emitted count of every engine step (which ends in the step's one D2H).
    Leaving the block restores both methods."""

    def __init__(self, model, engine):
        self.model, self.engine = model, engine
        self.reset()

    def __enter__(self):
        prefill, step = self.model.prefill, self.engine.step

        def timed_prefill(tokens):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = prefill(tokens)
            end.record()
            self.prefills.append((tuple(tokens.shape), start, end))
            return out

        def timed_step():
            t0 = time.perf_counter()
            emissions, finished = step()
            self.steps.append(((time.perf_counter() - t0) * 1e3, len(emissions)))
            return emissions, finished

        self.model.prefill, self.engine.step = timed_prefill, timed_step
        return self

    def __exit__(self, *exc) -> None:
        del self.model.prefill, self.engine.step  # the class methods show again

    def reset(self) -> None:
        self.prefills, self.batches, self.steps = [], [], []

    def prefill_ms(self) -> dict:
        torch.cuda.synchronize()
        by_shape = {}
        for shape, start, end in self.prefills:
            by_shape.setdefault("x".join(map(str, shape)), []).append(start.elapsed_time(end))
        return {k: {"median_ms": float(np.median(v)), "calls": len(v)}
                for k, v in sorted(by_shape.items(), key=lambda kv: int(kv[0].split("x")[-1]))}


def _engine_flash_holds(shapes, H: int, D: int, device, gen) -> list:
    """flash_fwd against its plain version at the engine's prefill shapes
    [1, Lb, H, D], causal, in bf16 (traffic (a)) and f32 (the exactness
    run); times at the largest bucket."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for lb in shapes:
            q, k, v = (torch.randn(1, lb, H, D, generator=gen, device=device).to(dtype)
                       for _ in range(3))
            out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
            p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(), True)
            err_out = (out.float() - p_out).abs().max().item()
            err_lse = (lse - p_lse).abs().max().item()
            tol_out, tol_lse = TOL[dtype]
            if not (err_out <= tol_out and err_lse <= tol_lse):
                raise AssertionError(f"engine: flash_fwd [1, {lb}, {H}, {D}] {dtype}: out err "
                                     f"{err_out} ({tol_out}), lse err {err_lse} ({tol_lse})")
            row = {"shape": [1, lb, H, D], "dtype": str(dtype).replace("torch.", ""),
                   "err_out": err_out, "err_lse": err_lse}
            if lb == shapes[-1]:
                row["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, True), reps=20)
                row["plain_ms"] = cuda_ms(lambda: fa._blockwise_attention_plain(q, k, v, True),
                                          reps=2, warmup=1)
                row["bound_ms"], row["bound_by"], _ = flash_bounds(1, lb, H, D, dtype,
                                                                   True)["flash_fwd"]
            rows.append(row)
    return rows


def _first_divergence(model, prompt, got, want) -> tuple:
    """Where a reply first departs from generate()'s, and the reference's
    top-two logit gap there (a forward over the reference's prefix) with
    the margin it must fall under."""
    j = int(np.nonzero(got != want)[0][0])
    with torch.inference_mode():
        logits, _ = model.prefill(torch.from_numpy(want[None, :j]).to(model.device))
    last = logits[0, -1].float()
    top = torch.topk(last, 2).values
    gap = (top[0] - top[1]).item()
    limit = LOGIT_MARGIN * max(1.0, last.abs().max().item())
    return j - len(prompt), gap, limit


def _serve_arm(addr: str, name: str, group: str, make_service, reqs, cuda: bool) -> dict:
    """One serving arm: a ServeReplica (its ``make_service(rpc)``) registered
    with the broker at ``addr`` in ``group``; a ServeClient finds it there and
    submits every request of ``reqs`` [(prompt, budget)] at once; the service
    loop starts once all are queued and stops after the last reply.  Latency
    on the client's clock from submit to reply."""
    from moolib_tpu_torch.serving import ServeClient, ServeReplica

    rpc = Rpc()
    rpc.set_name(name)
    rpc.listen("127.0.0.1:0")
    replica = ServeReplica(rpc, None, None, service=make_service(rpc), broker=addr,
                           group=group)
    client = ServeClient(broker=addr, group=group, deadline_s=900.0, attempt_timeout=900.0,
                         refresh_interval=0.1)
    thread = threading.Thread(target=lambda: asyncio.run(replica.loop(total=len(reqs))))
    try:
        client.wait_for_replicas(1, timeout=60.0)
        pad0 = _counter("serve_pad_tokens_total")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t_sub, t_done, futs = [], [None] * len(reqs), []
        for i, (prompt, budget) in enumerate(reqs):
            t_sub.append(time.perf_counter())
            fut = client.submit(prompt, budget)
            fut.add_done_callback(lambda f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append(fut)
        deadline = time.monotonic() + 60
        while replica.service.stats()["depth"] < len(reqs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{name}: requests did not reach the queue")
            time.sleep(0.01)
        thread.start()
        replies = [np.asarray(f.result(900.0)) for f in futs]
        thread.join(900.0)
        if thread.is_alive():
            raise TimeoutError(f"{name}: the service loop did not finish")
        stats = replica.service.stats()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        client.close()
        replica.close()
        rpc.close()
    for (prompt, budget), reply in zip(reqs, replies):
        if reply.shape != (len(prompt) + budget,) or not np.array_equal(reply[:len(prompt)],
                                                                        prompt):
            raise AssertionError(f"{name}: a reply of shape {reply.shape} for a "
                                 f"{len(prompt)}-token prompt with budget {budget}")
    lat = np.array([(d - s) * 1e3 for s, d in zip(t_sub, t_done)])
    emitted = sum(budget for _, budget in reqs)
    return {"replies": replies, "requests": len(reqs), "emitted_tokens": emitted,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "tokens_per_s": emitted / (max(t_done) - t_sub[0]),
            "iterations": stats["iterations"], "padding_tokens":
            _counter("serve_pad_tokens_total") - pad0, "max_memory_allocated": peak,
            "stats": stats}


def _dense_decode_window(model, prompts: torch.Tensor, steps: int):
    """A closure running ``steps`` of generate()'s dense decode steps after
    its prefill (done here, outside the window), and the context it needs."""
    from moolib_tpu_torch.models.transformer import cast_weights_once

    ctx = cast_weights_once(model)
    ctx.__enter__()
    B, Tp = prompts.shape
    logits, kvs = model.prefill(prompts)
    cache_k = torch.zeros(model.num_layers, B, model.max_len, *kvs[0][0].shape[2:],
                          dtype=model.dtype, device=prompts.device)
    cache_v = torch.zeros_like(cache_k)
    for i, (k, v) in enumerate(kvs):
        cache_k[i, :, :Tp], cache_v[i, :, :Tp] = k, v
    first = torch.argmax(logits[:, -1], dim=-1)

    def window():
        tok = first
        for t in range(steps):
            tok = torch.argmax(model.decode_step(tok[:, None], cache_k, cache_v, Tp + t)[:, 0],
                               dim=-1)
        tok.cpu()

    return window, ctx


def phase_engine(seed: int, device="cuda", lm_cfg=None, engine_cfg=None, traffic=None) -> dict:
    from moolib_tpu_torch.engine import ContinuousBatchingEngine, EngineService
    from moolib_tpu_torch.serving import ServeService, bucket, bucket_shapes

    lm_cfg = dict(ENGINE_LM, **(lm_cfg or {}))
    ecfg = dict(ENGINE, **(engine_cfg or {}))
    tr = dict(ENGINE_TRAFFIC, **(traffic or {}))
    cuda = torch.device(device).type == "cuda"
    clock = [time.perf_counter()]
    seconds = {}

    def lap(name):  # host seconds of each stage of the phase
        now = time.perf_counter()
        seconds[name], clock[0] = now - clock[0], now

    V, H = lm_cfg["vocab_size"], lm_cfg["num_heads"]
    D = lm_cfg["d_model"] // H
    buckets_ = sorted(set(bucket_shapes(ecfg["max_prompt_len"])))
    holds = _engine_flash_holds(buckets_, H, D, device,
                                torch.Generator(device=device).manual_seed(seed))
    model = TransformerLM(dtype=torch.bfloat16, device=device,
                          generator=torch.Generator().manual_seed(seed), **lm_cfg).eval()
    L = model.num_layers
    lap("flash_holds_and_init")
    eng = ContinuousBatchingEngine(model, **ecfg)
    pools = eng.pools_k + eng.pools_v
    ptrs = [p.data_ptr() for p in pools]
    pool_bytes = sum(p.numel() * p.element_size() for p in pools)
    t0 = time.perf_counter()
    shapes = eng.warmup()
    warmup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lo, hi = tr["prompt"]
    reqs_a = _engine_requests(rng, V, tr)
    reqs_b = [(rng.integers(0, V, tr["b_prompt"]).astype(np.int32),
               int(rng.choice(tr["b_budgets"]))) for _ in range(tr["b_requests"])]

    port = free_port()
    broker = start_broker(port)
    addr = f"127.0.0.1:{port}"
    arms = {}
    try:
        with _ServeTimer(model, eng) as timer:
            # Traffic (a), the engine's main path: counts start at 0 here (after
            # warmup) and are read right after.
            fa.reset_launches()
            steps0 = eng.stats()["steps"]
            a = _serve_arm(addr, "engine_a", "serve_engine_a",
                           lambda rpc: EngineService(rpc, eng, max_queue=256), reqs_a, cuda)
            launches = _counts()
            a_steps = eng.stats()["steps"] - steps0
            a["prefill_ms_by_bucket"] = timer.prefill_ms()
            a["decode_steps"] = a_steps
            a["decode_ms_per_step"] = float(np.median([ms for ms, _ in timer.steps]))
            a["mean_slot_occupancy"] = float(np.mean([n for _, n in timer.steps])) / eng.slots
            want_launches = L * len(reqs_a) if cuda else 0
            if launches["flash_fwd"] != want_launches or launches["flash_bwd_dq"] or \
                    launches["flash_bwd_dkv"]:
                raise AssertionError(f"engine: launches {launches}, flash_fwd must be exactly "
                                     f"{want_launches} (one prefill per request)")
            budget_sum = sum(b for _, b in reqs_a)
            if not a_steps < budget_sum:
                raise AssertionError(f"engine: {a_steps} decode steps for {budget_sum} budgeted "
                                     "tokens")
            _check_drained(eng, ptrs, pools, "traffic (a)")
            arms["a_engine"] = a
            lap("warmup_and_traffic_a")

            # Traffic (b): the batch-synchronous replica, then the engine arm.
            timer.reset()
            cap = tr["b_batch"]
            max_budget = max(tr["b_budgets"])

            def step(_params, batch, budgets):
                mn = bucket(int(np.max(budgets)), max_budget)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                with torch.inference_mode():
                    out = generate(model, torch.from_numpy(batch), mn).cpu().numpy()
                end.record()
                timer.batches.append((len(batch), mn, int(np.sum(budgets)), start, end))
                return out.astype(batch.dtype, copy=False)

            b = _serve_arm(addr, "batch_b", "serve_batch_b", lambda rpc: ServeService(
                rpc, step, None, batch_size=cap, per_request_tokens=True,
                default_max_new=max_budget), reqs_b, cuda)
            torch.cuda.synchronize()
            b["prefill_ms_by_bucket"] = timer.prefill_ms()
            per_step, useful, slots = [], 0, 0
            for (rows, mn, used, start, end), (_, p_start, p_end) in zip(timer.batches,
                                                                        timer.prefills):
                per_step.append((start.elapsed_time(end) - p_start.elapsed_time(p_end))
                                / max(1, mn - 1))
                useful, slots = useful + used, slots + rows * mn
            b["decode_ms_per_step"] = float(np.median(per_step))
            b["mean_slot_occupancy"] = useful / slots
            arms["b_batch"] = b

            timer.reset()
            e = _serve_arm(addr, "engine_b", "serve_engine_b",
                           lambda rpc: EngineService(rpc, eng, max_queue=256), reqs_b, cuda)
            e["prefill_ms_by_bucket"] = timer.prefill_ms()
            e["decode_ms_per_step"] = float(np.median([ms for ms, _ in timer.steps]))
            e["mean_slot_occupancy"] = float(np.mean([n for _, n in timer.steps])) / eng.slots
            arms["b_engine"] = e
            _check_drained(eng, ptrs, pools, "traffic (b)")
            lap("traffic_b")
        exact = _engine_exactness(seed, device, lm_cfg, ecfg, tr, reqs_a, addr, cuda)
        lap("exact_f32")
    finally:
        stop_process(broker)

    # Parity of traffic (a) with generate() of each prompt alone.
    divergences, equal = [], 0
    with torch.inference_mode():
        for i, ((prompt, budget), got) in enumerate(zip(reqs_a, arms["a_engine"]["replies"])):
            want = generate(model, torch.from_numpy(prompt[None]), budget)[0].cpu().numpy()
            if np.array_equal(got, want):
                equal += 1
                continue
            pos, gap, limit = _first_divergence(model, prompt, got, want)
            divergences.append({"request": i, "position": pos, "gap": gap, "limit": limit})
            if not gap < limit:
                raise AssertionError(f"engine: request {i} departs from generate() at emitted "
                                     f"token {pos}, where the top-two gap is {gap} (margin "
                                     f"{limit})")
    b_equal = sum(np.array_equal(x, y) for x, y in zip(arms["b_batch"]["replies"],
                                                       arms["b_engine"]["replies"]))
    lap("parity")

    # Device idle share over one profiled window of decode steps per arm.
    n_win = tr["window_steps"]
    for prompt, _ in reqs_b[:eng.slots]:
        eng.submit(prompt, n_win + 4)
    eng.step(), eng.step()
    eng_profile = device_profile(lambda: [eng.step() for _ in range(n_win)])
    while eng.active_count():
        for s in eng.step()[1]:
            eng.retire(s)
    _check_drained(eng, ptrs, pools, "the profiled window")
    batch_prompts = torch.from_numpy(np.stack([p for p, _ in reqs_b[:cap]])).to(device)
    with torch.inference_mode():
        window, ctx = _dense_decode_window(model, batch_prompts, n_win)
        try:
            window()
            batch_profile = device_profile(window)
        finally:
            ctx.__exit__(None, None, None)
    del model, eng, pools, timer
    lap("profiles")
    a_replies = arms["a_engine"]["replies"]
    for arm in arms.values():
        del arm["replies"], arm["stats"]
    res = {"phase": "engine", "model": f"TransformerLM vocab={V} d={lm_cfg['d_model']} L={L} "
           f"H={H}x{D} bf16 rotary, flash attention, max_len {lm_cfg['max_len']}",
           "engine": ecfg, "num_blocks": 1 + ecfg["slots"] * -(-ecfg["max_seq_len"]
                                                               // ecfg["block_size"]),
           "pool_bytes": pool_bytes, "warmup_shapes": shapes, "warmup_s": warmup_s,
           "launches": launches, "traffic_a": {"requests": len(reqs_a), "prompt": [lo, hi],
                                               "budgets": list(tr["budgets"])},
           "traffic_b": {"requests": len(reqs_b), "prompt": tr["b_prompt"],
                         "budgets": list(tr["b_budgets"]), "batch_cap": cap},
           "arms": arms, "parity": {"replies_equal_generate": equal, "of": len(reqs_a),
                                    "divergences": divergences, "margin": LOGIT_MARGIN},
           "b_replies_equal_across_arms": b_equal, "exact_f32": exact,
           "pools_data_ptr_stable": True, "seconds": seconds, "flash_holds": holds}
    log(res)
    log({"phase": "engine_profile", "window": f"{n_win} engine decode steps, "
         f"{ecfg['slots']} slots of {tr['b_prompt']}-token prompts", **eng_profile})
    log({"phase": "batch_decode_profile", "window": f"{n_win} generate() decode steps, "
         f"batch {cap} of {tr['b_prompt']}-token prompts", **batch_profile})
    # Traffic (a)'s replies, for disagg_engine to hold its replies to.
    return dict(res, a_replies=a_replies)


def _engine_requests(rng, V: int, tr: dict) -> list:
    """Traffic (a): ``tr["requests"]`` prompts of lengths in ``tr["prompt"]``
    and budgets from ``tr["budgets"]``, the first draws of ``rng``."""
    lo, hi = tr["prompt"]
    return [(rng.integers(0, V, int(rng.integers(lo, hi + 1))).astype(np.int32),
             int(rng.choice(tr["budgets"]))) for _ in range(tr["requests"])]


def _check_drained(eng, ptrs, pools, when: str) -> None:
    eng.pool.check_invariants()
    if eng.pool.available() != eng.pool.num_blocks - 1 or eng.active_count():
        raise AssertionError(f"engine: after {when}, {eng.pool.available()} of "
                             f"{eng.pool.num_blocks - 1} blocks free, "
                             f"{eng.active_count()} slots active")
    if [p.data_ptr() for p in pools] != ptrs:
        raise AssertionError(f"engine: the KV pools moved during {when}")


def _engine_exactness(seed, device, lm_cfg, ecfg, tr, reqs, addr: str, cuda: bool) -> dict:
    """The same engine at the same widths with ``exact_layers`` layers in
    f32 (the CUDA-core flash forward), served as traffic (a) is: replies
    equal generate()'s exactly."""
    from moolib_tpu_torch.engine import ContinuousBatchingEngine, EngineService

    cfg = dict(lm_cfg, num_layers=tr["exact_layers"])
    model = TransformerLM(dtype=torch.float32, device=device,
                          generator=torch.Generator().manual_seed(seed + 1), **cfg).eval()
    eng = ContinuousBatchingEngine(model, **ecfg)
    reqs = reqs[:tr["exact_requests"]]
    replies = _serve_arm(addr, "engine_f32", "serve_engine_f32",
                         lambda rpc: EngineService(rpc, eng, max_queue=256), reqs, cuda)["replies"]
    with torch.inference_mode():
        for i, ((prompt, budget), got) in enumerate(zip(reqs, replies)):
            want = generate(model, torch.from_numpy(prompt[None]), budget)[0].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"engine (f32, L={cfg['num_layers']}): request {i} "
                                     "differs from generate()")
    return {"layers": cfg["num_layers"], "requests": len(reqs), "replies_equal_generate":
            len(reqs)}


def _rl_batch(T1: int, B: int, obs, num_actions: int, seed: int, frames: bool) -> dict:
    rng = np.random.default_rng(seed)
    done = rng.random((T1, B)) < 0.2
    done[0, 0] = True
    return {
        "state": (rng.integers(0, 256, (T1, B, *obs), dtype=np.uint8) if frames
                  else rng.normal(size=(T1, B, *obs)).astype(np.float32)),
        "reward": rng.normal(size=(T1, B)).astype(np.float32),
        "done": done,
        "prev_action": rng.integers(0, num_actions, (T1, B)),
        "action": rng.integers(0, num_actions, (T1, B)),
        "policy_logits": rng.normal(size=(T1, B, num_actions)).astype(np.float32),
    }


def _parity_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |card - CPU| over max(1, max |CPU|)."""
    want = want.detach().float()
    err = (got.detach().cpu().float() - want).abs().max().item()
    return err / max(1.0, want.abs().max().item())


def _learner_backward(model, device, batch: dict, state: tuple, flags) -> tuple:
    """Forward, then compute_loss and its backward: (outputs, loss); the
    gradients are left in the parameters' ``.grad``."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    state = tuple(torch.from_numpy(x).to(device) for x in state)
    with torch.no_grad():
        outputs, _ = model(batch, state)
    loss, _ = experiment.compute_loss(batch, state, model, flags)
    loss.backward()
    return outputs, loss.detach()


def _learner_run(model, device, batch: dict, state: tuple, flags) -> dict:
    """Forward, then one compute_loss + backward + clip/rmsprop step."""
    opt = experiment.make_optimizer(model.parameters(), flags)
    outputs, loss = _learner_backward(model, device, batch, state, flags)
    opt.step()
    return {**outputs, "loss": loss}


def phase_impala_parity(seed: int, device="cuda", obs=(84, 84, 4), T1: int = 5,
                        B: int = 4) -> dict:
    """The RL models and one learner step on the card against the CPU."""
    flags = experiment.make_flags([])  # lr 1e-3, clip 40, the JAX example's costs
    A = 6
    cases = {
        "impala_ff": (functools.partial(ImpalaNet, A, obs, use_lstm=False,
                                        dtype=torch.float32), obs),
        "impala_lstm": (functools.partial(ImpalaNet, A, obs, use_lstm=True,
                                          dtype=torch.float32), obs),
        "actor_critic_lstm": (functools.partial(ActorCriticNet, A, obs_size=8, use_lstm=True),
                              (8,)),
        "impala_ff_bf16": (functools.partial(ImpalaNet, A, obs, use_lstm=False,
                                             dtype=torch.bfloat16), obs),
    }
    out = {}
    for i, (name, (make, shape)) in enumerate(cases.items()):
        host = make(device="cpu", generator=torch.Generator().manual_seed(seed + i))
        card = make(device=device)
        card.load_state_dict(host.state_dict())
        batch = _rl_batch(T1, B, shape, A, seed + i, frames=len(shape) == 3)
        rng = np.random.default_rng(seed + 100 + i)
        state = tuple(rng.normal(size=(B, host.core.hidden)).astype(np.float32)
                      for _ in range(2)) if host.use_lstm else ()
        want = _learner_run(host, "cpu", batch, state, flags)
        got = _learner_run(card, device, batch, state, flags)
        errs = {k: _parity_err(got[k], want[k]) for k in ("policy_logits", "baseline", "loss")}
        params = dict(host.named_parameters())
        errs["updated_params"] = max(_parity_err(p, params[n])
                                     for n, p in card.named_parameters())
        tol = PARITY_TOL[host.dtype]
        if not max(errs.values()) <= tol:
            raise AssertionError(f"impala_parity {name}: errors {errs} (tol {tol})")
        out[name] = {"errors": errs, "tol": tol, "loss": want["loss"].item()}
    res = {"phase": "impala_parity", "obs": list(obs), "T+1": T1, "B": B,
           "step": "compute_loss + backward + clip_by_global_norm(40) + rmsprop(1e-3, 0.99, "
           "0.01)", "cases": out}
    log(res)
    return res


def max_pool_bytes(obs, channels, frames: int, itemsize: int = 2) -> int:
    """Least bytes the encoder's three SAME max-pools move in one learner
    step: forward reads each input and writes each output once; backward
    reads the output gradient and the input and writes the input
    gradient."""
    h, w, _ = obs
    total = 0
    for ch in channels:
        n_in, h, w = frames * h * w * ch, -(-h // 2), -(-w // 2)
        n_out = frames * h * w * ch
        total += (n_in + n_out) + (n_out + 2 * n_in)
    return total * itemsize


def _learner_bench(device, obs, T: int, B: int, steps: int, profile_steps: int) -> dict:
    """bench.py's learner step at [T+1, B]: times, rates, memory, profile."""
    dev = torch.device(device)
    step, _, _, _ = bench.build_step(dev, T, B, obs=obs)
    _, warm = bench.step_times_ms(step, 10, dev)
    torch.cuda.reset_peak_memory_stats()
    times, losses = bench.step_times_ms(step, steps, dev)
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: [step() for _ in range(profile_steps)], top=15)
    issue_ms = enqueue_ms(step, reps=10)
    losses = [float(x) for x in warm + losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"impala_learner: non-finite losses {losses}")
    median = float(np.median(times))
    flops = 3.0 * bench.analytic_forward_flops(bench.REF_CHANNELS, obs, T + 1, B)
    res = {"phase": "impala_learner", "model": "ImpalaNet (16, 32, 32) bf16, no LSTM, "
           "V-trace loss, rmsprop(1e-3, 0.99, 0.01)", "obs": list(obs), "T": T, "B": B,
           "metric": bench.metric_name(T, B, bench.REF_CHANNELS), "steps": steps,
           "step_ms_median": median, "step_ms_min": min(times), "step_ms_max": max(times),
           "frames_per_s": T * B / (median / 1e3), "model_tflop_per_step": flops / 1e12,
           "tflops": flops / (median / 1e3) / 1e12,
           "mfu": flops / (median / 1e3) / bench.PEAK_BF16_FLOPS,
           "max_memory_allocated": peak, "first_loss": losses[0], "last_loss": losses[-1],
           "launches_per_step": prof["kernel_launches"] / profile_steps,
           "idle_share": prof["idle_share"],
           # Host-bound where the host's time to issue a step exceeds the
           # device's busy time in one.
           "host_issue_ms_per_step": issue_ms,
           "device_busy_ms_per_step": prof["device_busy_ms"] / profile_steps,
           "max_pool_bound_ms_per_step": max_pool_bytes(obs, bench.REF_CHANNELS, (T + 1) * B)
           / PEAK_BYTES_PER_S * 1e3}
    log(res)
    log({"phase": "impala_learner_profile", "window": f"{profile_steps} learner steps", **prof})
    return res


def _data_path(pool: EnvPool, device, seed: int, T: int, learn_steps: int) -> dict:
    """Actors on the card step the pool; their unrolls go through the
    Batcher into learner steps."""
    dev = torch.device(device)
    obs = pool.obs_spec["state"][0]
    model, opt = bench.build_learner(dev, obs=obs, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb, envs = pool.num_batches, pool.batch_size
    batchers = [Batcher(T + 1, device=dev, host=True, name=f"learn{b}") for b in range(nb)]
    frames = [[] for _ in range(nb)]
    prev = [torch.zeros(envs, dtype=torch.int64, device=dev) for _ in range(nb)]
    futs = [pool.step(b, np.zeros(envs, np.int64)) for b in range(nb)]
    act_ms, learner_events, losses, env_steps = [], [], [], 0
    h2d = telemetry.get_registry().counter_values().get("batcher_h2d_bytes_total", 0.0)
    t0 = time.perf_counter()
    while len(losses) < learn_steps:
        for b in range(nb):
            env_out = futs[b].result()
            ta = time.perf_counter()
            # Copied before the next step() lets the workers overwrite them.
            host = {k: v.copy() for k, v in env_out.items()}
            inputs = {k: torch.from_numpy(v).to(dev)[None] for k, v in host.items()}
            inputs["prev_action"] = prev[b][None]
            with torch.no_grad():
                out, _ = model(inputs, (), sample_generator=gen)
            action = out["action"][0]
            futs[b] = pool.step(b, action)  # the CUDA-tensor seam
            act_ms.append((time.perf_counter() - ta) * 1e3)
            env_steps += envs
            batchers[b].stack({**host, "prev_action": prev[b], "action": action,
                               "policy_logits": out["policy_logits"][0]})
            frames[b].append(host["state"])
            prev[b] = action
            if batchers[b].empty() or len(losses) == learn_steps:
                continue
            batch = batchers[b].get()
            if batch["state"].device.type != dev.type:
                raise AssertionError(f"impala_learner: the learner batch is on "
                                     f"{batch['state'].device}, not {dev}")
            if not torch.equal(batch["state"].cpu(), torch.from_numpy(np.stack(frames[b]))):
                raise AssertionError("impala_learner: the learner batch's frames are not "
                                     "the shared-memory frames of its unroll")
            frames[b] = []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            losses.append(bench.learner_step(model, opt, batch))
            end.record()
            learner_events.append((start, end))
    for f in futs:
        f.result()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"impala_learner data path: non-finite losses {losses}")
    seam = all(p is not None for p in pool._stepper._pinned)
    if dev.type == "cuda" and not seam:
        raise AssertionError("impala_learner: actions did not pass the CUDA-tensor seam")
    res = {"phase": "impala_learner_data_path",
           "pool": {"num_processes": pool._num_processes, "batch_size": envs,
                    "num_batches": nb},
           "obs": list(obs), "unroll": T + 1, "learner_steps": len(losses),
           "env_steps": env_steps, "wall_s": wall_s, "env_steps_per_s": env_steps / wall_s,
           "act_ms_median": float(np.median(act_ms)),
           "learner_ms_median": float(np.median([a.elapsed_time(b)
                                                 for a, b in learner_events])),
           "losses": losses, "frames_equal_shm": True, "cuda_action_seam": seam,
           "batcher_h2d_bytes": telemetry.get_registry().counter_values().get(
               "batcher_h2d_bytes_total", 0.0) - h2d}
    log(res)
    return res


def phase_impala_learner(pool: EnvPool, seed: int, device="cuda", obs=(84, 84, 4),
                         T: int = 20, B: int = 32, steps: int = 200, profile_steps: int = 5,
                         learn_steps: int = 10) -> dict:
    # The slice's path: counts start at 0 here and are read right after.
    fa.reset_launches()
    res = _learner_bench(device, obs, T, B, steps, profile_steps)
    res["data_path"] = _data_path(pool, device, seed, T, learn_steps)
    res["flash_launches"] = _counts()
    return res


# ----------------------------------------------------------------- cohort
# cohort_impala: the reduce paths, and each one's tolerance against the
# float64 sum of the four peers' gradients computed on the card.  The f32
# paths hold tests/test_buckets.py's allclose; the compressed wires hold
# their error to a share of max|sum| over the whole payload (one scale per
# chunk spans many leaves).
COHORT_PATHS = {
    "auto": {},
    "tree": dict(bucketed=False, chunked=False),
    "ring": dict(chunked=True),
    "ring_bf16": dict(chunked=True, wire="bfloat16"),
    "ring_q8": dict(chunked=True, wire="q8"),
}
COHORT_F32_TOL = (1e-5, 1e-5)  # rtol, atol
COHORT_WIRE_TOL = {"ring_bf16": 1e-2, "ring_q8": 5e-2}  # x max|sum|
COHORT_PEERS = 4
COHORT_ROUNDS = 20
# cohort_lm: the repo's LM at lm_bench's widths, learned positions, one
# forward + backward of B x T tokens in each of two learner processes.
COHORT_LM = dict(vocab_size=32768, d_model=1024, num_heads=8, num_layers=12, max_len=1024)
COHORT_LM_BATCH = (4, 1024)
COHORT_LM_ROUNDS = 5
ROOT = os.path.dirname(os.path.abspath(__file__))


def start_broker(port: int) -> subprocess.Popen:
    """The port's broker CLI in its own process, listening once this returns."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.broker", "--address", f"127.0.0.1:{port}",
         "--interval", "0.05"],
        env=dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")),
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"broker exited {proc.returncode}: {proc.stderr.read()[-2000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return proc
        except OSError:
            time.sleep(0.1)
    stop_process(proc)
    raise RuntimeError("broker never listened")


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def _join_group(name: str, addr: str, group: str):
    rpc = Rpc()
    rpc.set_name(name)
    rpc.set_timeout(120)
    rpc.listen("127.0.0.1:0")
    rpc.connect(addr)
    g = Group(rpc, group)
    g.set_timeout(120)
    return rpc, g


def _pump(groups, until, seconds: float, what: str) -> None:
    deadline = time.time() + seconds
    while not until():
        if time.time() > deadline:
            raise AssertionError(f"{what}: timed out after {seconds} s")
        for g in groups:
            g.update()
        time.sleep(0.0005)


def _counter(prefix: str) -> float:
    return sum(v for k, v in telemetry.get_registry().counter_values().items()
               if k.startswith(prefix))


def _leaf_bytes(result) -> list:
    return [np.ascontiguousarray(x).tobytes() for x in nest.flatten(result)]


def _staging_ms(leaves, reps: int) -> dict:
    """buckets.BucketLayout.fill of one peer's gradient leaves into a pinned
    lease: CUDA-event time from before the copies to after them, and host
    time until the fill's event completed."""
    layout = buckets.BucketLayout([tuple(x.shape) for x in leaves], np.float32)
    flat = buckets.lease(layout.total, np.float32, pinned=leaves[0].is_cuda)
    dev_ms, host_ms = [], []
    try:
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            event = layout.fill(flat, leaves)
            end.record()
            if event is not None:
                event.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
    finally:
        buckets.release(flat)
    nbytes = layout.total * 4
    med = float(np.median(dev_ms))
    return {"bytes": nbytes, "d2h_ms_median": med, "host_ms_median": float(np.median(host_ms)),
            "d2h_GB_per_s": nbytes / (med / 1e3) / 1e9 if med > 0 else None}


def phase_cohort_impala(seed: int, device="cuda", obs=(84, 84, 4), T1: int = 21, B: int = 32,
                        rounds: int = COHORT_ROUNDS) -> dict:
    """Four in-process peers reduce four full-width ImpalaNet gradients,
    CUDA tensors as they stand, on each path; then one cohort stats round."""
    A = 6
    flags = experiment.make_flags([])
    model = ImpalaNet(A, obs, use_lstm=False, dtype=torch.bfloat16, device=device,
                      generator=torch.Generator().manual_seed(seed))
    grads, losses = [], []
    for i in range(COHORT_PEERS):
        model.zero_grad(set_to_none=True)
        _, loss = _learner_backward(model, device, _rl_batch(T1, B, obs, A, seed + i, True),
                                    (), flags)
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        losses.append(float(loss))
    names = list(grads[0])
    elements = sum(grads[0][n].numel() for n in names)
    ref = {n: sum(g[n].double() for g in grads).cpu().numpy() for n in names}
    ref_max = max(float(np.abs(v).max()) for v in ref.values())
    staging = _staging_ms([grads[0][n] for n in names], reps=rounds)

    port = free_port()
    broker = start_broker(port)
    peers = []
    try:
        peers = [_join_group(f"peer{i}", f"127.0.0.1:{port}", "cohort_impala")
                 for i in range(COHORT_PEERS)]
        groups = [g for _, g in peers]
        _pump(groups, lambda: all(g.active() and len(g.members()) == COHORT_PEERS
                                  for g in groups), 120, "cohort_impala: cohort")
        paths = {}
        for path, kw in COHORT_PATHS.items():
            times, err = [], 0.0
            ev0, d2h0 = _counter("buckets_d2h_events_total"), _counter("buckets_d2h_bytes_total")
            tx0 = _counter("rpc_tx_bytes_total")
            for r in range(rounds):
                t0 = time.perf_counter()
                futs = [g.all_reduce(f"{path}{r}", grd, **kw) for g, grd in zip(groups, grads)]
                _pump(groups, lambda: all(f.done() for f in futs), 120,
                      f"cohort_impala: {path} round {r}")
                times.append((time.perf_counter() - t0) * 1e3)
                results = [f.result(0) for f in futs]
                first = _leaf_bytes(results[0])
                if any(_leaf_bytes(x) != first for x in results[1:]):
                    raise AssertionError(f"cohort_impala {path}: peers' result bytes differ")
                out = results[0]
                if not all(isinstance(out[n], np.ndarray) for n in names):
                    raise AssertionError(f"cohort_impala {path}: results are not host arrays")
                err = max(err, max(float(np.abs(out[n] - ref[n]).max()) for n in names))
                if path in COHORT_WIRE_TOL:
                    if not err <= COHORT_WIRE_TOL[path] * ref_max:
                        raise AssertionError(f"cohort_impala {path}: max err {err} > "
                                             f"{COHORT_WIRE_TOL[path]} x max|sum| {ref_max}")
                else:
                    for n in names:
                        np.testing.assert_allclose(out[n], ref[n], *COHORT_F32_TOL,
                                                   err_msg=f"cohort_impala {path} {n}")
            events = _counter("buckets_d2h_events_total") - ev0
            d2h = _counter("buckets_d2h_bytes_total") - d2h0
            if torch.device(device).type == "cuda" and (
                    events != COHORT_PEERS * rounds or d2h != COHORT_PEERS * rounds * elements * 4):
                raise AssertionError(f"cohort_impala {path}: {events} staging events and {d2h} "
                                     f"D2H bytes; want one event and every byte per peer round")
            paths[path] = {"kwargs": kw, "round_ms_median": float(np.median(times)),
                           "round_ms_min": min(times), "round_ms_max": max(times),
                           "max_abs_err": err, "d2h_events": events, "d2h_bytes": d2h,
                           "rpc_tx_bytes_per_round": (_counter("rpc_tx_bytes_total") - tx0)
                           / rounds}
            if path in COHORT_WIRE_TOL:
                paths[path]["tol"] = f"{COHORT_WIRE_TOL[path]} x max|sum|"
            else:
                paths[path]["tol"] = {"rtol": COHORT_F32_TOL[0], "atol": COHORT_F32_TOL[1]}
        stats = _cohort_stats(groups, losses, T1 * B)
        ring_auto = groups[0].ring_auto(elements * 4)
    finally:
        for rpc, _ in peers:
            rpc.close()
        stop_process(broker)
    res = {"phase": "cohort_impala", "peers": COHORT_PEERS,
           "model": "ImpalaNet (16, 32, 32) bf16 compute, f32 parameters, no LSTM",
           "obs": list(obs), "T+1": T1, "B": B, "leaves": len(names), "elements": elements,
           "payload_bytes": elements * 4, "bucket_bytes": buckets.bucket_bytes(),
           "auto_path": "ring" if ring_auto else "bucketed",
           "max_abs_sum": ref_max, "rounds": rounds, "staging": staging, "paths": paths,
           "stats": stats}
    log(res)
    return res


def _cohort_stats(groups, losses, frames: int) -> dict:
    """One GlobalStatsAccumulator round over the cohort: each peer's loss
    (a StatMean), its frames (a StatSum) and its registry counters."""
    stats = [{"loss": StatMean(), "frames": StatSum(), "telemetry": telemetry.CohortCounters()}
             for _ in groups]
    accs = [GlobalStatsAccumulator(g, s) for g, s in zip(groups, stats)]
    for s, loss in zip(stats, losses):
        s["loss"] += loss
        s["frames"] += frames
    for a, s in zip(accs, stats):
        a.reduce(s)
    _pump(groups, lambda: all(a._inflight is None for a in accs), 60, "cohort stats")
    want = float(np.mean(losses))
    for s in stats:
        if s["loss"].count != len(groups) or s["frames"].value != frames * len(groups):
            raise AssertionError(f"cohort stats: count {s['loss'].count}, frames "
                                 f"{s['frames'].value}")
        if not abs(s["loss"].result() - want) <= 1e-6 * max(1.0, abs(want)):
            raise AssertionError(f"cohort stats: mean loss {s['loss'].result()} != {want}")
    return {"mean_loss": stats[0]["loss"].result(), "frames": stats[0]["frames"].value,
            "cohort_counter_series": len(stats[0]["telemetry"].result())}


def _lm_learner(rank: int, addr: str, seed: int, device: str, lm_cfg: dict, batch: tuple,
                rounds: int, out, leave) -> None:
    """One learner process of cohort_lm: the LM's gradient on this rank's
    batch, ``rounds`` auto allreduces of it over the group, and the check
    against the peer's gradient fetched over Rpc and added on the card.
    The learner reports, then stays in the cohort (its gradient still
    served) until the parent has both reports and sets ``leave``."""

    def report(rep):
        out.put((rank, rep))
        leave.wait(600)

    try:
        _lm_learner_run(rank, addr, seed, device, lm_cfg, batch, rounds, report)
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which fails
        import traceback

        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))


def _lm_learner_run(rank, addr, seed, device, lm_cfg, batch, rounds, report) -> None:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**lm_cfg, attention="flash", dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(seed))
    B, T = batch
    toks = torch.from_numpy(np.random.default_rng(seed + 1 + rank).integers(
        0, lm_cfg["vocab_size"], size=(B, T))).to(dev)
    fa.reset_launches()  # the path's launches: this rank's forward + backward
    loss = lm_head_xent(model, toks, chunk_size=4096)
    loss.backward()
    launches = _counts()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    names = list(grads)
    elements = sum(g.numel() for g in grads.values())
    flat = torch.cat([grads[n].reshape(-1) for n in names])

    rpc, g = _join_group(f"learner{rank}", addr, "cohort_lm")
    rpc.define("gradient", lambda: flat.cpu().numpy())
    try:
        _pump([g], lambda: g.active() and len(g.members()) == 2, 120, "cohort_lm: cohort")
        times, h2d_ms, results = [], [], []
        d2h0 = _counter("buckets_d2h_bytes_total")
        ev0 = _counter("buckets_d2h_events_total")
        tx0 = _counter("rpc_tx_bytes_total")
        for r in range(rounds):
            t0 = time.perf_counter()
            fut = g.all_reduce(f"grads{r}", grads)
            _pump([g], fut.done, 600, f"cohort_lm: round {r}")
            times.append(time.perf_counter() - t0)
            res = fut.result(0)
            if cuda:  # the caller's copy of the result back to the card
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                back = {n: torch.from_numpy(res[n]).to(dev, non_blocking=True) for n in names}
                end.record()
                end.synchronize()
                h2d_ms.append(start.elapsed_time(end))
                del back
            results.append(_leaf_bytes(res))
        tx = (_counter("rpc_tx_bytes_total") - tx0) / rounds
        if any(x != results[0] for x in results[1:]):
            raise AssertionError("cohort_lm: rounds of the same gradients differ")
        events = _counter("buckets_d2h_events_total") - ev0
        d2h = _counter("buckets_d2h_bytes_total") - d2h0
        if cuda and (events != rounds or d2h != rounds * elements * 4):
            raise AssertionError(f"cohort_lm: {events} staging events, {d2h} D2H bytes")
        other = torch.from_numpy(rpc.sync(f"learner{1 - rank}", "gradient")).to(dev)
        want, off = [], 0
        for n in names:
            k = grads[n].numel()
            want.append((grads[n] + other[off:off + k].view_as(grads[n])).cpu().numpy().tobytes())
            off += k
        if results[-1] != want:
            bad = [n for n, a, b in zip(names, results[-1], want) if a != b]
            raise AssertionError(f"cohort_lm: result differs from grad_a + grad_b in {bad[:5]}")
        staging = _staging_ms([grads[n] for n in names], reps=3) if cuda else None
        report({"rank": rank, "loss": float(loss.detach()), "leaves": len(names), "elements": elements,
                "round_s": times, "h2d_ms": h2d_ms, "staging": staging,
                "d2h_events": events, "launches": launches,
                "rpc_tx_bytes_per_round": tx, "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else 0,
                "equal_grad_a_plus_grad_b": True})
    finally:
        rpc.close()


def phase_cohort_lm(seed: int, device="cuda", lm_cfg=None, batch=COHORT_LM_BATCH,
                    rounds: int = COHORT_LM_ROUNDS, timeout: float = 600) -> dict:
    """Two learner processes (spawned, each its own CUDA context on the one
    card) allreduce the LM's full gradient through the port's Group."""
    import multiprocessing as mp

    lm_cfg = dict(COHORT_LM if lm_cfg is None else lm_cfg)
    port = free_port()
    broker = start_broker(port)
    ctx = mp.get_context("spawn")
    out, leave = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=_lm_learner, args=(rank, f"127.0.0.1:{port}", seed, device,
                                                   lm_cfg, batch, rounds, out, leave))
             for rank in range(2)]
    try:
        for p in procs:
            p.start()
        reports = {}
        deadline = time.time() + timeout
        while len(reports) < 2:
            try:
                rank, rep = out.get(timeout=5)
            except queue.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(f"cohort_lm: learners {[p.exitcode for p in procs]} "
                                         f"reported {sorted(reports)}")
                continue
            if "error" in rep:
                raise AssertionError(f"cohort_lm learner {rank}: {rep['error']}")
            reports[rank] = rep
        leave.set()  # both have fetched each other's gradient: the learners may close
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"cohort_lm: learner exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        stop_process(broker)
    nbytes = reports[0]["elements"] * 4
    med_s = float(np.median([t for r in reports.values() for t in r["round_s"]]))
    launches = {k: sum(r["launches"][k] for r in reports.values()) for k in reports[0]["launches"]}
    if torch.device(device).type == "cuda" and min(launches.values()) < 2 * lm_cfg["num_layers"]:
        raise AssertionError(f"cohort_lm: kernel launches {launches}, each must be >= "
                             f"{2 * lm_cfg['num_layers']}")
    res = {"phase": "cohort_lm", "processes": 2,
           "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention" if lm_cfg == COHORT_LM
           else f"TransformerLM {lm_cfg}", "batch": list(batch), "rounds": rounds,
           "gradient_elements": reports[0]["elements"], "payload_bytes": nbytes,
           "round_s_median": med_s, "algbw_GB_per_s": nbytes / med_s / 1e9,
           "launches": launches, "learners": [reports[0], reports[1]]}
    log(res)
    return res


# accumulator_impala / accumulator_lm: the training loops of slice 4b, two
# learner processes each (spawned, one CUDA context each on the one card).
ACC_IMPALA_ARGS = ["--env", "synthetic", "--unroll_length", "20", "--batch_size", "32",
                   "--actor_batch_size", "32", "--num_actor_batches", "2",
                   "--num_env_processes", "4", "--virtual_batch_size", "64"]
ACC_IMPALA_SGD = 50
ACC_LM_ARGS = ["--vocab", "32768", "--d_model", "1024", "--layers", "12", "--heads", "8",
               "--seq_len", "1024", "--batch_size", "4", "--virtual_batch_size", "8",
               "--attention", "flash", "--mesh", "", "--learning_rate", "1e-4"]
ACC_LM_STEPS = 6  # one step of learner 0 alone, then 5 of the cohort


def _cohort_child(kind: str, rank: int, argv: list, out, started=None) -> None:
    """One learner process of accumulator_impala / accumulator_lm: the
    example's own train() on ``argv``; its summary goes to the parent.
    Nothing touches CUDA before train() (its EnvPool forks first)."""
    try:
        t0 = time.time()
        ev0 = _counter("buckets_d2h_events_total")
        if kind == "impala":
            summary = experiment.train(experiment.make_flags(argv))
        else:
            fa.reset_launches()

            def on_stats(s):  # tells the parent that learner 0 has stepped
                if started is not None:
                    started.put(s["step"])

            summary = lm.train(lm.make_flags(argv), on_stats=on_stats)
            summary["launches"] = _counts()
        summary.update(
            rank=rank, wall_s=time.time() - t0,
            d2h_events=_counter("buckets_d2h_events_total") - ev0,
            env_steps=_counter("envpool_steps_total"),
            max_memory_allocated=torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)
        out.put((rank, summary))
    except BaseException as e:  # reported to the parent, which fails, then re-raised
        import traceback

        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))
        raise


def _run_cohort(kind: str, argvs: list, timeout: float, wait_first: bool) -> list:
    """Spawn the two learners (the second once the first has applied a step
    when ``wait_first``), collect both summaries, stop every process."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out, started = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_cohort_child, args=(kind, r, argvs[r], out, started))
             for r in range(2)]
    reports = {}
    deadline = time.time() + timeout

    def collect(block_s):
        try:
            rank, rep = out.get(timeout=block_s)
        except queue.Empty:
            if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                raise AssertionError(f"{kind}: learners {[p.exitcode for p in procs]} "
                                     f"reported {sorted(reports)}")
            return
        if "error" in rep:
            raise AssertionError(f"accumulator_{kind} learner {rank}: {rep['error']}")
        reports[rank] = rep

    try:
        procs[0].start()
        if wait_first:
            while True:
                try:
                    started.get(timeout=5)
                    break
                except queue.Empty:
                    collect(0.01)
                    if time.time() > deadline:
                        raise AssertionError(f"{kind}: learner 0 never stepped")
        procs[1].start()
        while len(reports) < 2:
            collect(5)
        while not started.empty():  # drained before the join (learner 0's step notes)
            started.get_nowait()
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"accumulator_{kind}: learner exit code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [reports[0], reports[1]]


def _cohort_checks(kind: str, reps: list, cuda: bool) -> tuple:
    """Both learners at the same model version with bitwise-equal
    parameters; the non-leader synced the model through the chunked
    transfer; on the card, one D2H event per staging call.  Returns
    (leader, joiner)."""
    if len({r["model_version"] for r in reps}) != 1:
        raise AssertionError(f"{kind}: versions {[r['model_version'] for r in reps]}")
    if reps[0]["params_sha256"] != reps[1]["params_sha256"]:
        raise AssertionError(f"{kind}: parameters differ after the last step")
    leaders = [r for r in reps if r["is_leader"]]
    joiners = [r for r in reps if not r["is_leader"]]
    if len(leaders) != 1:
        raise AssertionError(f"{kind}: leaders {[r['is_leader'] for r in reps]}")
    joiner = joiners[0]
    if joiner["recovery"]["model_sync_bytes_rx"] <= 0:
        raise AssertionError(f"{kind}: the joiner received no model-sync bytes")
    for r in reps:
        calls = r["accumulator"]["d2h_staged_calls"]
        if cuda and (calls == 0 or r["d2h_events"] != calls):
            raise AssertionError(f"{kind}: learner {r['rank']}: {r['d2h_events']} D2H events "
                                 f"for {calls} staging calls")
    return leaders[0], joiner


def phase_accumulator_impala(seed: int, device="cuda", args=None, sgd_steps: int = ACC_IMPALA_SGD,
                             timeout: float = 900) -> dict:
    """Two examples.vtrace.experiment.train() learners: learner 0 hosts the
    broker, learner 1 joins; synthetic Atari frames through the full-width
    ImpalaNet to a fixed count of SGD steps, debug checksums on."""
    port = free_port()
    common = list(ACC_IMPALA_ARGS if args is None else args) + [
        "--device", device, "--seed", str(seed), "--total_steps", str(10 ** 9),
        "--total_sgd_steps", str(sgd_steps), "--min_cohort", "2", "--debug_checksums",
        "--quiet", "--log_interval", "1e9"]
    argvs = [common + ["--address", f"127.0.0.1:{port}", "--local_name", "impala0"],
             common + ["--connect", f"127.0.0.1:{port}", "--local_name", "impala1"]]
    reps = _run_cohort("impala", argvs, timeout, wait_first=False)
    cuda = torch.device(device).type == "cuda"
    leader, joiner = _cohort_checks("accumulator_impala", reps, cuda)
    for r in reps:
        if r["accumulator"]["checksum_divergences"]:
            raise AssertionError(f"accumulator_impala: {r['accumulator']['checksum_divergences']} "
                                 f"checksum divergences on learner {r['rank']}")
    flags = experiment.make_flags(common)
    # Cohort rates over the steps both learners applied together: from the
    # joiner's first applied step to the last.
    times = [t for t, _ in joiner["sgd_times"]]
    span = times[-1] - times[0] if len(times) > 1 else float("nan")
    sgd_per_s = (len(times) - 1) / span
    frames = flags.virtual_batch_size * flags.unroll_length
    res = {"phase": "accumulator_impala", "processes": 2,
           "model": "ImpalaNet (16, 32, 32), no LSTM, bf16 compute, f32 parameters, "
           "84x84x4 uint8, 6 actions" if args is None else f"ImpalaNet {args}",
           "model_version": leader["model_version"], "sgd_steps_together": len(times),
           "sgd_steps_per_s": sgd_per_s, "learner_frames_per_s": sgd_per_s * frames,
           "params_sha256_equal": True, "checksum_divergences": 0,
           "checksum_failures": [r["accumulator"]["checksum_failures"] for r in reps],
           "model_sync": {"joiner": f"learner{joiner['rank']}",
                          "bytes": joiner["recovery"]["model_sync_bytes_rx"],
                          "ms": joiner["accumulator"]["model_sync_ms"]},
           "learners": [{
               "rank": r["rank"], "leader": r["is_leader"],
               "elections": r["accumulator"]["elections"],
               "count_round_ms": r["accumulator"]["round_ms"]["count"],
               "grad_round_ms": r["accumulator"]["round_ms"]["grad"],
               "rounds": r["accumulator"]["rounds"],
               # this learner's env steps over its span of applied SGD steps
               "env_steps_per_s": (r["sgd_times"][-1][1] - r["sgd_times"][0][1])
               / max(r["sgd_times"][-1][0] - r["sgd_times"][0][0], 1e-9),
               "env_steps_total": r["env_steps"],
               # The loop's StepTimer EMAs (alpha 0.05): act over thousands
               # of steps, learn and apply over ~50 (the first, cuDNN's
               # warm-up, fades to ~8% of its weight).
               "act_ms_ema": 1e3 * r["sections"].get("act", float("nan")),
               "learn_ms_ema": 1e3 * r["sections"].get("learn", float("nan")),
               "apply_ms_ema": 1e3 * r["sections"].get("apply", float("nan")),
               "d2h_events": r["d2h_events"],
               "d2h_staged_calls": r["accumulator"]["d2h_staged_calls"],
               "reduce_bytes": r["accumulator"]["reduce_bytes"],
               "mfu": r["mfu"],
               "max_memory_allocated": r["max_memory_allocated"],
               "wall_s": r["wall_s"]} for r in reps]}
    log(res)
    return res


def phase_accumulator_lm(seed: int, device="cuda", args=None, steps: int = ACC_LM_STEPS,
                         timeout: float = 900) -> dict:
    """Two examples.lm elastic learners: learner 0 hosts the broker and
    applies one step alone (its AdamW state then exists), learner 1 joins,
    syncs the model and AdamW state, and the two take the remaining steps
    together; the three flash kernels run in every forward and backward."""
    port = free_port()
    common = list(ACC_LM_ARGS if args is None else args) + [
        "--device", device, "--seed", str(seed), "--steps", str(steps),
        "--min_cohort", "2", "--quiet", "--log_interval", "1"]
    argvs = [common + ["--address", f"127.0.0.1:{port}", "--local_name", "lm0"],
             common + ["--connect", f"127.0.0.1:{port}", "--local_name", "lm1"]]
    reps = _run_cohort("lm", argvs, timeout, wait_first=True)
    cuda = torch.device(device).type == "cuda"
    leader, joiner = _cohort_checks("accumulator_lm", reps, cuda)
    if leader["rank"] != 0:
        raise AssertionError("accumulator_lm: learner 0 stepped first and must lead")
    if joiner["accumulator"]["model_sync_sha"] != leader["accumulator"]["model_sync_sha"]:
        raise AssertionError("accumulator_lm: the joiner's blob sha differs from the leader's")
    launches = {k: {f"learner{r['rank']}": r["launches"][k] for r in reps}
                for k in reps[0]["launches"]}
    layers = int(common[common.index("--layers") + 1])
    if cuda and any(v < 2 * layers for per in launches.values() for v in per.values()):
        raise AssertionError(f"accumulator_lm: flash launches {launches}")
    payload = leader["accumulator"]["reduce_bytes"]["rpc"] / max(
        1, leader["accumulator"]["rounds"]["grad"])
    grad_s = 1e-3 * leader["accumulator"]["round_ms"]["grad"]
    sync_s = 1e-3 * joiner["accumulator"]["model_sync_ms"]
    sync_bytes = joiner["recovery"]["model_sync_bytes_rx"]
    res = {"phase": "accumulator_lm", "processes": 2,
           "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention" if args is None
           else f"TransformerLM {args}",
           "batch_per_learner": [4, 1024] if args is None else None,
           "steps": steps, "model_version": leader["model_version"],
           "params_sha256_equal": True,
           "step_s": [r["step_s"] for r in reps], "grad_round_s": grad_s,
           "payload_bytes_per_learner_round": payload,
           "algbw_GB_per_s": payload / grad_s / 1e9 if grad_s else None,
           "model_sync": {"bytes": sync_bytes, "s": sync_s, "GB_per_s": sync_bytes / sync_s / 1e9,
                          "sha": joiner["accumulator"]["model_sync_sha"]},
           "mfu": [r["mfu"] for r in reps], "launches": launches,
           "learners": [{"rank": r["rank"], "leader": r["is_leader"], "loss": r["loss"],
                         "count_round_ms": r["accumulator"]["round_ms"]["count"],
                         "grad_round_ms": r["accumulator"]["round_ms"]["grad"],
                         "d2h_events": r["d2h_events"],
                         "d2h_staged_calls": r["accumulator"]["d2h_staged_calls"],
                         "max_memory_allocated": r["max_memory_allocated"],
                         "wall_s": r["wall_s"]} for r in reps]}
    log(res)
    return res


# -------------------------------------------------------------- sharded_lm
# The hierarchical learner (ROADMAP slice 9a): two elastic hosts, each a
# dp=2 mesh of rank processes sharing the one card over gloo, the LM at
# accumulator_lm's widths and per-rank batch (B 4 x T 1024 a rank, 8 a host);
# depth cut to 4 blocks (from 12) to keep the script inside its time limit.
SHARDED_LM_LAYERS = 4
SHARDED_LM_ARGS = ["--vocab", "32768", "--d_model", "1024", "--layers",
                   str(SHARDED_LM_LAYERS), "--heads", "8",
                   "--seq_len", "1024", "--batch_size", "8", "--attention", "flash",
                   "--mesh", "dp=2", "--shard_grads", "--learning_rate", "1e-4"]
SHARDED_LM_STEPS = 3  # one step of host 0 alone, then 2 of the cohort
# The sp_overlap arm (slice 9e): each host an sp=2 mesh, ring attention on the
# flash kernels, the hook-streamed gradients into the sharded rounds.
SHARDED_SP = 2


def _sp_args(args: list) -> list:
    """``args`` (a dp arm's) with ``--mesh sp=SHARDED_SP --attention ring``
    and ``--overlap_grads``."""
    out = list(args)
    out[out.index("--mesh") + 1] = f"sp={SHARDED_SP}"
    out[out.index("--attention") + 1] = "ring"
    return out + ["--overlap_grads"]


def _ring_launches(layers: int, sp_rank: int, learns: int) -> int:
    """Each flash kernel's launches on ``sp`` rank ``sp_rank`` of a causal
    ring for ``learns`` forward + backward passes: a chunk from a later rank
    launches nothing, so rank r runs r + 1 chunks a layer."""
    return layers * (sp_rank + 1) * learns


def _arm_delta(rank_summary: dict, before: dict) -> None:
    """A rank's counters in its summary as this arm's share: less their
    readings from before the arm (a rank process runs several arms)."""
    for k, v in before.items():
        if k in rank_summary:
            rank_summary[k] -= v


def _sharded_rank(proc: int, world: int, tasks, out, notes) -> None:
    """sharded_lm's rank process ``proc``, started once for every arm: mesh
    rank ``proc % 2`` of host ``proc // 2`` (``_mp_rank``'s loop over its
    host's two-rank group; a host's rank 0 notes its first applied step)."""
    _mp_rank(proc % 2, 2, tasks, out, notes, report_as=proc)


def _sharded_arm(ranks, seed: int, device: str, args: list, steps: int,
                 timeout: float) -> list:
    """One arm on the phase's four rank processes: host 0's ranks start,
    host 1's once host 0 has applied a step (it joins a running cohort).
    Returns the two hosts' summaries, each rank's counters read as the
    arm's delta."""
    port = free_port()
    common = list(args) + ["--device", device, "--seed", str(seed), "--steps", str(steps),
                           "--min_cohort", "2", "--quiet", "--log_interval", "1"]
    argvs = [common + ["--address", f"127.0.0.1:{port}", "--local_name", "host0"],
             common + ["--connect", f"127.0.0.1:{port}", "--local_name", "host1"]]
    for host in (0, 1):
        mesh_port = free_port()
        for local in (0, 1):
            ranks.tasks[2 * host + local].put((argvs[host], mesh_port))
        if host == 0 and ranks.note(timeout)[:2] != ("stepped", 0):
            raise AssertionError("sharded_lm: host 0 did not step first")
    reps = ranks.reports(timeout)
    while not ranks.notes.empty():  # host 1's first step
        ranks.notes.get_nowait()
    hosts = []
    for host in (0, 1):
        summary = dict(reps[2 * host]["summary"], rank=host)
        for x in summary["ranks"]:
            _arm_delta(x, reps[2 * host + x["rank"]]["before"])
        hosts.append(summary)
    return hosts


def phase_sharded_lm(seed: int, device="cuda", args=None, steps: int = SHARDED_LM_STEPS,
                     layers: int = SHARDED_LM_LAYERS, timeout: float = 400,
                     loss_tol: float = None) -> dict:
    """Two hosts x two ranks through examples.lm.train() (four rank
    processes, started once for the three arms), from the same seed: arm (a) dp=2 --overlap_grads, arm
    (b) dp=2 and the barrier step, arm (c) ``sp_overlap``: sp=2 ring
    attention with --overlap_grads.  Checks: both hosts and every rank end
    with equal params sha, and the two dp arms too (two terms per sum:
    exact in any order); the joiner host received the model and its
    scatter bytes per round are (N-1)/N of the flat payload within half a
    bucket (the range cut sits on the bucket grid); every dp rank launched
    each flash kernel at least layers x its learn steps times, every sp
    rank exactly as often as the causal ring's schedule gives (the warm-up
    included); host 0's first loss, computed alone before the cohort
    forms, is the dp arms' within ``loss_tol`` (relative; both arms see the
    same batch and weights)."""
    t_phase = time.perf_counter()
    args = SHARDED_LM_ARGS if args is None else args
    loss_tol = MP_LOSS_TOL if loss_tol is None else loss_tol
    arms = {}
    ranks = _MpRanks(world=4, target=_sharded_rank, name="sharded_lm")
    failed = True
    try:
        for name, argv in (("overlap", list(args) + ["--overlap_grads"]),
                           ("barrier", list(args)), ("sp_overlap", _sp_args(args))):
            arms[name] = _sharded_arm(ranks, seed, device, argv, steps, timeout)
        failed = False
    finally:
        ranks.close(failed)
    for name, reps in arms.items():
        if len({r["model_version"] for r in reps}) != 1:
            raise AssertionError(f"sharded_lm {name}: versions "
                                 f"{[r['model_version'] for r in reps]}")
        shas = {r["params_sha256"] for r in reps}
        shas |= {x["params_sha256"] for r in reps for x in r["ranks"]}
        if len(shas) != 1:
            raise AssertionError(f"sharded_lm {name}: parameters differ across hosts "
                                 f"or ranks: {sorted(shas)}")
        leaders = [r for r in reps if r["is_leader"]]
        if len(leaders) != 1 or leaders[0]["rank"] != 0:
            raise AssertionError(f"sharded_lm {name}: host 0 stepped first and must lead")
        joiner = reps[1]
        if joiner["recovery"]["model_sync_bytes_rx"] <= 0:
            raise AssertionError(f"sharded_lm {name}: the joiner host received no model")
    if arms["overlap"][0]["params_sha256"] != arms["barrier"][0]["params_sha256"]:
        raise AssertionError("sharded_lm: the overlap and barrier arms end with "
                             "different parameters")
    dp_loss, sp_loss = arms["barrier"][0]["first_loss"], arms["sp_overlap"][0]["first_loss"]
    loss_rel = abs(sp_loss - dp_loss) / abs(dp_loss)
    if not loss_rel <= loss_tol:
        raise AssertionError(f"sharded_lm sp_overlap: host 0's first loss {sp_loss} against "
                             f"the dp arms' {dp_loss}: {loss_rel:.3g} relative > {loss_tol}")
    payload = 4 * arms["barrier"][0]["n_params"]  # the f32 flat payload
    half_bucket = buckets.bucket_bytes() / 2
    out = {"phase": "sharded_lm", "hosts": 2, "dp": 2, "sp": SHARDED_SP, "steps": steps,
           "model": f"TransformerLM vocab=32768 d=1024 L={layers} H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention" if args is SHARDED_LM_ARGS
           else f"TransformerLM {args}",
           "batch_per_rank": [4, 1024] if args is SHARDED_LM_ARGS else None,
           "params_sha256_equal": True, "payload_bytes": payload,
           "first_loss": {"dp": dp_loss, "sp_overlap": sp_loss, "rel_err": loss_rel},
           "arms": {}}
    launches_total = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    sp_launches = dict(launches_total)
    for name, reps in arms.items():
        hosts = []
        for r in reps:
            info = r["accumulator"]
            rounds = info["rpc_reduces"]
            scatter = info["reduce_bytes"]["rpc"]
            if r["rank"] == 0:  # its first round ran alone: a full payload, no wire
                rounds, scatter = rounds - 1, scatter - payload
            per_round = scatter / max(1, rounds)
            if abs(per_round - payload / 2) > half_bucket:
                raise AssertionError(f"sharded_lm {name}: host {r['rank']} shipped "
                                     f"{per_round} B a round, want {payload / 2} +- {half_bucket}")
            learns = r["learns"]
            for x in r["ranks"]:
                want = (_ring_launches(layers, x["coords"]["sp"], learns + 1)
                        if name == "sp_overlap" else None)
                x["launches_expected"] = want
                for k, v in x["launches"].items():
                    (sp_launches if name == "sp_overlap" else launches_total)[k] += v
                    if device == "cpu":
                        continue
                    if want is not None and v != want:
                        raise AssertionError(f"sharded_lm {name}: host {r['rank']} rank "
                                             f"{x['rank']} launched {k} {v} times, the ring's "
                                             f"schedule gives {want} ({learns} learn steps "
                                             "and the warm-up)")
                    if want is None and v < layers * learns:
                        raise AssertionError(f"sharded_lm {name}: host {r['rank']} rank "
                                             f"{x['rank']} launched {k} {v} times for "
                                             f"{learns} learn steps")
            exposed = r["exposed_comm_s"]
            hosts.append({
                "host": r["rank"], "leader": r["is_leader"], "loss": r["loss"],
                "first_loss": r["first_loss"], "learns": learns,
                "step_s": r["step_s"], "rounds": info["rpc_reduces"],
                "scatter_bytes_per_round": per_round,
                "scatter_share_of_payload": per_round / payload,
                "exposed_comm_s_median": float(np.median(exposed)) if exposed else None,
                "exposed_comm_s": exposed,
                "launch_leads_max_s": max(info["last_launch_leads"], default=None),
                "model_sync_bytes_rx": r["recovery"]["model_sync_bytes_rx"],
                "ranks": [{"rank": x["rank"], "coords": x["coords"],
                           "max_memory_allocated": x["max_memory_allocated"],
                           "host_staged_bytes": x["host_staged_bytes"],
                           "psum_seconds": x["psum_seconds"], "launches": x["launches"],
                           "launches_expected": x["launches_expected"]}
                          for x in r["ranks"]],
                "wall_s": r["wall_s"]})
        out["arms"][name] = {"step_s": [h["step_s"] for h in hosts], "hosts": hosts,
                             "wall_s": max(h["wall_s"] for h in hosts)}
    out["launches"] = launches_total
    out["sp_launches"] = sp_launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(out)
    return out


# ------------------------------------------------------------------ mp_lm
# The model-parallel training half of slice 9b: examples.lm.train() on one
# card whose rank processes share it over gloo.  Each arm: the repo's LM at
# full width (LM_WIDTHS), learning rate 1e-4, a warm-up step plus
# MP_LM_STEPS steps: each arm's mesh, attention and batch flags.
MP_LM_ARMS = {
    "ring_lm": ["--mesh", "sp=4", "--attention", "ring", "--batch_size", "1",
                "--seq_len", "4096", "--layers", str(CUT_LAYERS)],
    "moe_lm": ["--mesh", "dp=2,ep=2", "--attention", "flash", "--moe_experts", "8",
               "--batch_size", "8", "--seq_len", "1024", "--layers", str(CUT_LAYERS)],
    "pipeline_lm": ["--mesh", "pp=4", "--attention", "flash", "--pp_repeats", "3",
                    "--microbatches", "4", "--batch_size", "4", "--seq_len", "1024"],
}
MP_LM_STEPS = 2
MP_LM_RANKS = 4  # every arm's mesh has 4 ranks; one set of rank processes runs them all
# bf16 parity of the mesh's warm-up step against one process on the card:
# the loss within MP_LOSS_TOL of the reference's (relative), and every
# gradient leaf within MP_GRAD_TOL of it by its own relative norm,
# ||g_mesh - g_ref|| / ||g_ref||.  Set from the H100's readings at full
# width: a loss off by at most 1.4e-5, the worst leaf of an arm by 0.0024 to
# 0.0149 (PERF.md, PR 13).
MP_LOSS_TOL, MP_GRAD_TOL = 1e-4, 5e-2


def _mp_rank(rank: int, world: int, tasks, out, notes=None, report_as=None) -> None:
    """One rank process of every mp_lm arm.  For each task ``(argv, port)``
    it joins that arm's process group as ``rank`` (torchrun's environment,
    so examples.lm.train() spawns nothing), counts the kernels' launches
    from 0, trains, leaves the group and reports its summary (rank 0's
    carries every rank's) with its counters' readings from before the arm.
    ``None`` ends it.  With ``report_as`` it reports under that number, and
    as rank 0 notes ``("stepped", report_as, step)`` at its first applied
    step (an elastic host)."""
    import gc

    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1")
    reg = telemetry.get_registry()
    while (task := tasks.get()) is not None:
        argv, port = task
        os.environ["MASTER_PORT"] = str(port)
        me = rank if report_as is None else report_as
        stepped = []

        def on_stats(s):
            if not stepped:
                stepped.append(s["step"])
                notes.put(("stepped", me, s["step"]))

        try:
            before = {"host_staged_bytes": lm._counter(reg, "collectives_host_staged_bytes_total"),
                      "ring_hop_seconds": lm._hist_sum(reg, "ring_hop_seconds"),
                      "psum_seconds": lm._hist_sum(reg, "accum_psum_seconds")}
            if torch.cuda.is_initialized():
                torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            t0 = time.time()
            summary = lm.train(lm.make_flags(argv), on_stats=on_stats
                               if report_as is not None and rank == 0 else None)
            summary["wall_s"] = time.time() - t0
            out.put({"rank": me, "summary": summary, "before": before})
        except BaseException as e:  # reported to the parent, which fails, then re-raised
            import traceback

            out.put({"rank": me, "error": f"{e!r}\n{traceback.format_exc()}"})
            raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()


class _MpRanks:
    """MP_LM_RANKS rank processes, started once for every arm of a phase
    (a process takes seconds to reach the card).  ``target(rank, world,
    tasks, out, notes)`` is each one's loop: ``tasks`` its own queue,
    ``out`` the reports, ``notes`` messages a rank sends mid-task."""

    def __init__(self, world: int = MP_LM_RANKS, target=None, name: str = "mp_lm"):
        import multiprocessing as mp

        self.name = name
        ctx = mp.get_context("spawn")
        self.out, self.notes = ctx.Queue(), ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=target or _mp_rank,
                                  args=(r, world, self.tasks[r], self.out, self.notes))
                      for r in range(world)]
        for proc in self.procs:
            proc.start()

    def run(self, argv, timeout: float) -> list:
        """Every rank's report of one arm (task ``argv``), in rank order."""
        self.start(argv)
        return self.reports(timeout)

    def start(self, task) -> None:
        port = free_port()
        for q in self.tasks:
            q.put((task, port))

    def note(self, timeout: float):
        """The next mid-task message of a rank (a rank's error fails it)."""
        deadline = time.time() + timeout
        while True:
            try:
                return self.notes.get(timeout=5)
            except queue.Empty:
                pass
            try:
                rep = self.out.get_nowait()
            except queue.Empty:
                rep = {}
            if "error" in rep:
                raise AssertionError(f"{self.name}: rank {rep['rank']}: {rep['error']}")
            dead = [p.exitcode for p in self.procs if p.exitcode is not None]
            if dead or time.time() > deadline:
                raise AssertionError(f"{self.name}: no rank wrote within {timeout} s "
                                     f"(exit codes {dead})")

    def reports(self, timeout: float) -> list:
        """Every rank's report of the task in flight, in rank order."""
        reps, deadline = {}, time.time() + timeout
        while len(reps) < len(self.procs):
            try:
                rep = self.out.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if p.exitcode is not None]
                if time.time() > deadline or dead:
                    raise AssertionError(f"{self.name}: {len(reps)} of {len(self.procs)} ranks "
                                         f"reported (exit codes {dead})")
                continue
            if "error" in rep:
                raise AssertionError(f"{self.name}: rank {rep['rank']}: {rep['error']}")
            reps[rep["rank"]] = rep
        return [reps[r] for r in sorted(reps)]

    def close(self, failed: bool) -> None:
        """Stop the ranks: after a failure at once (the others may wait in
        a collective), else once they have left their loops."""
        for q in self.tasks:
            q.put(None)
        for proc in self.procs:
            proc.join(timeout=0 if failed else 60)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)


def _mp_reference(flags, device) -> tuple:
    """The warm-up step's loss and gradients in one process on the card:
    the same weights (the seed's) and tokens (the seed's first batch), the
    mesh-free model (flash attention over the whole sequence, every
    expert), the JAX example's loss."""
    ref = lm.make_flags(["--vocab", str(flags.vocab), "--d_model", str(flags.d_model),
                         "--layers", str(flags.layers), "--heads", str(flags.heads),
                         "--mesh", "", "--attention", "flash",
                         "--moe_experts", str(flags.moe_experts), "--batch_size",
                         str(flags.batch_size), "--seq_len", str(flags.seq_len),
                         "--seed", str(flags.seed), "--device", device])
    model = lm.make_model(ref, torch.device(device))
    tokens = torch.from_numpy(lm.make_batch(np.random.default_rng(flags.seed), ref)).to(device)
    loss, _ = lm.copy_task_loss(model(tokens), tokens, flags.seq_len // 2)
    if model.aux_losses:
        loss = loss + flags.moe_aux_weight * sum(model.aux_losses)
    loss.backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    return float(loss.detach()), grads


def _mp_expected_launches(name: str, flags, learn_steps: int, ranks: list) -> dict:
    """The flash launches each kernel must show, per rank, for
    ``learn_steps`` forward + backward passes (the warm-up included)."""
    L = flags.layers
    if name == "ring_lm":  # rank r runs r + 1 chunks a layer: n(n+1)/2 over sp
        return {r["rank"]: L * (r["coords"]["sp"] + 1) * learn_steps for r in ranks}
    if name == "pipeline_lm":  # bubble ticks skipped: each block once per microbatch
        mb = flags.microbatches
        S = len(ranks)
        return {r["rank"]: (L // S) * mb * learn_steps for r in ranks}
    return {r["rank"]: L * learn_steps for r in ranks}  # moe_lm: every layer, every rank


def _mp_grad_errors(got: dict, ref: dict) -> dict:
    """Each leaf's ||g_mesh - g_ref|| / ||g_ref|| (0 where both are 0)."""
    errs = {}
    for k, g in ref.items():
        g = g.double()
        diff = float((got[k].to(g.device).double() - g).norm())
        norm = float(g.norm())
        errs[k] = diff / norm if norm > 0 else (0.0 if diff == 0 else float("inf"))
    return errs


def phase_mp_lm(seed: int, device="cuda", arms=None, steps: int = MP_LM_STEPS,
                widths=None, timeout: float = 600,
                tols: tuple = (MP_LOSS_TOL, MP_GRAD_TOL)) -> dict:
    """Three arms of examples.lm.train() over model-parallel meshes on the
    one card (rank processes, gloo, every collective through pinned host
    memory), one set of rank processes for them all.  Checks per arm: the
    warm-up step's global loss and every reduced gradient leaf (experts
    gathered) against one process on the card within ``tols`` (the loss's
    relative error, each leaf's relative norm); every rank ends with the same replicated parameters
    (experts: per ep block); each flash kernel's launches are exactly the
    count the path implies (_mp_expected_launches)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    arms = MP_LM_ARMS if arms is None else arms
    widths = LM_WIDTHS if widths is None else widths
    res = {"phase": "mp_lm", "steps": steps, "arms": {}}
    launches_by_path = {}
    ranks_procs = _MpRanks()
    failed = True
    try:
        for name, arm in arms.items():
            probe = tempfile.mkdtemp(prefix=f"mp_lm_{name}_")
            try:
                argv = [*widths, *arm, "--device", device, "--seed", str(seed), "--steps",
                        str(steps), "--quiet", "--learning_rate", "1e-4", "--probe_dir", probe]
                flags = lm.make_flags(argv)
                t_arm = time.perf_counter()
                reps = ranks_procs.run(argv, timeout)
                arm_s = time.perf_counter() - t_arm
                got = torch.load(os.path.join(probe, "step0.pt"))
            finally:
                shutil.rmtree(probe, ignore_errors=True)
            rep = reps[0]["summary"]
            ranks = rep["ranks"]
            for r in ranks:
                _arm_delta(r, reps[r["rank"]]["before"])
            if len({r["params_sha256"] for r in ranks}) != 1:
                raise AssertionError(f"mp_lm {name}: replicated parameters differ across ranks")
            if flags.moe_experts and any("ep" in r["coords"] for r in ranks):
                for e in {r["coords"]["ep"] for r in ranks}:
                    if len({r["experts_sha256"] for r in ranks if r["coords"]["ep"] == e}) != 1:
                        raise AssertionError(f"mp_lm {name}: experts of ep block {e} differ")
            want = _mp_expected_launches(name, flags, steps + 1, ranks)
            for r in ranks:
                for k, v in r["launches"].items():
                    if device != "cpu" and v != want[r["rank"]]:
                        raise AssertionError(f"mp_lm {name}: rank {r['rank']} launched {k} {v} "
                                             f"times, want {want[r['rank']]}")
            launches_by_path[name] = {k: sum(r["launches"][k] for r in ranks)
                                      for k in ranks[0]["launches"]}
            # One-process reference on the card (the ranks hold no model now).
            torch.cuda.empty_cache() if device == "cuda" else None
            t_ref = time.perf_counter()
            ref_loss, ref_grads = _mp_reference(flags, device)
            if set(got["grads"]) != set(ref_grads):
                raise AssertionError(f"mp_lm {name}: gradient leaves differ: "
                                     f"{sorted(set(got['grads']) ^ set(ref_grads))[:4]}")
            errs = _mp_grad_errors(got["grads"], ref_grads)
            del ref_grads
            worst_leaf = max(errs, key=errs.get)
            loss_err = abs(got["loss"] - ref_loss) / abs(ref_loss)
            if loss_err > tols[0] or errs[worst_leaf] > tols[1]:
                raise AssertionError(f"mp_lm {name}: loss {got['loss']} vs {ref_loss} "
                                     f"(rel {loss_err}), gradient leaf {worst_leaf} off by "
                                     f"{errs[worst_leaf]} of its norm")
            res["arms"][name] = {
                "flags": arm, "ranks": len(ranks), "loss_step0": got["loss"],
                "loss_step0_reference": ref_loss, "loss_rel_err": loss_err,
                "grad_rel_err_max": errs[worst_leaf], "grad_worst_leaf": worst_leaf,
                "grad_rel_err_median": float(np.median(list(errs.values()))),
                "step_s": rep["step_s"], "loss": rep["loss"], "acc": rep["acc"],
                "mfu": rep["mfu"],
                "launches_per_rank": {r["rank"]: r["launches"]["flash_fwd"] for r in ranks},
                "launches_want_per_rank": want, "launches": launches_by_path[name],
                "max_memory_allocated": {r["rank"]: r["max_memory_allocated"] for r in ranks},
                "host_staged_bytes": {r["rank"]: r["host_staged_bytes"] for r in ranks},
                "ring_hop_seconds": {r["rank"]: r["ring_hop_seconds"] for r in ranks},
                "moe_dropped_last_step": ranks[0]["moe_dropped_last_step"],
                "arm_wall_s": arm_s, "reference_s": time.perf_counter() - t_ref}
            log({"phase": "mp_lm", "arm": name, **res["arms"][name]})
            torch.cuda.empty_cache() if device == "cuda" else None
        failed = False
    finally:
        ranks_procs.close(failed)
    res["launches"] = launches_by_path
    res["wall_s"] = time.perf_counter() - t_phase
    log({k: v for k, v in res.items() if k != "arms"})
    return res


# ------------------------------------------------------------------ tp_lm
# Tensor parallelism (slice 9d) at the LM's full width (LM_WIDTHS, bf16,
# flash) on the one card: four rank processes, started once for both arms,
# share it over gloo.  tp_serve: lm_serve.serve(mesh=) over a tp=4 mesh
# answers the slice phase's traffic (4 concurrent 1024-token prompts, 16
# greedy tokens each).  tp_train: make_train_step over dp=2 x tp=2 with the
# auto_shardings layout, B 8 x T 1024 in all, AdamW 1e-4 on the copy task,
# a warm-up step plus TP_LM_STEPS.
TP_SERVE = dict(tp=4, batch=4, prompt=1024, new=16)
TP_TRAIN_ARGS = ["--batch_size", "8", "--seq_len", "1024", "--learning_rate", "1e-4"]
TP_LM_STEPS = 2
# bf16: the last prompt position's prefill logits of the tp=4 server within
# TP_LOGIT_TOL x max(1, max|logit|) of one process's on the same card; its
# replies equal one process's generate() up to a position where that
# process's top-two logits lie within the same margin (LOGIT_MARGIN's rule).
TP_LOGIT_TOL = 2e-2


def _tp_serve_model(widths: list, sv: dict, device, seed: int) -> TransformerLM:
    """The serving LM (phase_slice's configuration at ``widths``)."""
    f = lm.make_flags(widths)
    return TransformerLM(
        vocab_size=f.vocab, d_model=f.d_model, num_heads=f.heads, num_layers=f.layers,
        attention="flash", dtype=torch.bfloat16, pos_embedding="rotary",
        max_len=sv["prompt"] + sv["new"], device=device,
        generator=torch.Generator().manual_seed(seed)).eval()


def _tp_prompts(seed: int, vocab: int, sv: dict) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (sv["batch"], sv["prompt"])).astype(np.int32)


def _synced_ms(fn, dev, reps: int) -> float:
    """Median wall ms of ``fn`` with the card synchronised around each call
    (every rank calls it together: collectives inside)."""
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def _tp_rank(rank: int, world: int, tasks, out, notes) -> None:
    """One rank process of both tp_lm arms: for each task ``((kind, cfg),
    port)`` it joins that arm's process group, runs the arm's part and
    reports; ``None`` ends it."""
    import gc

    import torch.distributed as dist

    from moolib_tpu_torch import parallel

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1")
    reg = telemetry.get_registry()
    while (task := tasks.get()) is not None:
        (kind, cfg), port = task
        try:
            parallel.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                            device=cfg["device"])
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if cfg["device"] == "cuda" else torch.device("cpu")
            staged0 = lm._counter(reg, "collectives_host_staged_bytes_total")
            arm = _tp_serve_rank if kind == "serve" else _tp_train_rank
            rep = arm(rank, cfg, dev, tasks, notes)
            rep["host_staged_bytes"] = lm._counter(
                reg, "collectives_host_staged_bytes_total") - staged0
            rep["max_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                           if dev.type == "cuda" else None)
            out.put({"rank": rank, **rep})
        except BaseException as e:  # reported to the parent, which fails, then re-raised
            import traceback

            out.put({"rank": rank, "error": f"{e!r}\n{traceback.format_exc()}"})
            raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            gc.collect()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()


def _tp_serve_rank(rank: int, cfg: dict, dev, tasks, notes) -> dict:
    """tp_serve on one rank: rank 0 serves the parent's requests over Rpc
    (serve(mesh=)), the others follow; then every rank times the sharded
    prefill and generate on the same prompts, rank 0 keeping the last
    position's prefill logits."""
    import torch.distributed as dist

    from moolib_tpu_torch import parallel
    from moolib_tpu_torch.examples import lm_serve
    from moolib_tpu_torch.parallel import tensor_parallel

    sv = cfg["serve"]
    mesh = parallel.make_mesh({"tp": sv["tp"]}, device_type=dev.type)
    model = _tp_serve_model(cfg["widths"], sv, dev, cfg["seed"])
    tensor_parallel.shard_model(model, mesh)
    new = sv["new"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # The served path: counts start at 0 here and are read right after.
    fa.reset_launches()
    served = None
    if rank == 0:
        server = Rpc()
        server.set_name("tp_server")
        server.listen(cfg["addr"])
        try:
            coro = serve(server, model, new, mesh=mesh, batch_size=sv["batch"],
                         total=sv["batch"])
            notes.put("listening")
            if tasks.get() != "go":  # the parent's requests sit in the queue
                raise RuntimeError("tp_serve: expected the parent's go")
            served = asyncio.run(coro)
            if tasks.get() != "replied":  # hold the server until the replies arrived
                raise RuntimeError("tp_serve: expected the parent's replied")
        finally:
            server.close()
    else:
        lm_serve.follow(model, new, mesh)
    launches = _counts()
    prompts = torch.from_numpy(_tp_prompts(cfg["seed"], model.vocab_size, sv)).to(dev)
    dist.barrier()
    with torch.inference_mode():
        logits = model.prefill(prompts)[0][:, -1].float().cpu()
        prefill_ms = _synced_ms(lambda: model.prefill(prompts), dev, 2)
        gen_ms = _synced_ms(lambda: generate(model, prompts, new), dev, 1)
    return {"iterations": served, "launches": launches,
            "param_bytes": tensor_parallel.param_bytes(model),
            "cache_kv_heads": model.cache_kv_heads(),
            "prefill_ms": prefill_ms, "generate_ms": gen_ms,
            "decode_ms_per_token": (gen_ms - prefill_ms) / (new - 1),
            "logits": logits if rank == 0 else None}


def _tp_train_rank(rank: int, cfg: dict, dev, tasks, notes) -> dict:
    """tp_train on one rank: the warm-up step's loss and its gradients
    gathered onto rank 0 (written to the probe file), then TP_LM_STEPS
    AdamW steps; the replicated leaves' and the blocks' sha256."""
    from moolib_tpu_torch import parallel
    from moolib_tpu_torch.parallel import tensor_parallel

    flags = lm.make_flags(cfg["argv"])
    mesh = parallel.make_mesh({"dp": 2, "tp": 2}, device_type=dev.type)
    model = lm.make_model(flags, dev)
    layout = parallel.auto_shardings(dict(model.named_parameters()), mesh)
    held = tensor_parallel.shard_model(model, mesh, layout)
    named = dict(model.named_parameters())
    opt = lm.make_optimizer(named.values(), flags.learning_rate)
    half = flags.seq_len // 2
    step = parallel.make_train_step(
        lambda p, b, r: lm.copy_task_loss(model(b), b, half), opt, mesh=mesh,
        params_sharding=layout, batch_spec=parallel.PartitionSpec("dp", None))
    tokens = torch.from_numpy(lm.make_batch(np.random.default_rng(flags.seed), flags)).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # The tp_train path: counts start at 0 here and are read right after.
    fa.reset_launches()
    loss0, _ = step.grads(named, tokens, None)
    grads = parallel.gather_full(tensor_parallel.as_dtensors(
        model, {k: p.grad for k, p in named.items()}))
    if rank == 0:
        torch.save({"loss": float(loss0), "grads": {k: v.cpu() for k, v in grads.items()}},
                   cfg["probe"])
    del grads
    step_s, losses = [], []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        _, _, loss, _ = step(named, None, tokens, None)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    launches = _counts()
    rep_keys = [k for k in named if k not in held]
    return {"coords": {a: mesh.get_local_rank(a) for a in ("dp", "tp")},
            "launches": launches, "step_s": step_s, "losses": losses,
            "param_bytes": tensor_parallel.param_bytes(model),
            "replicated_sha256": lm.params_sha256({k: named[k] for k in rep_keys}),
            "blocks_sha256": lm.params_sha256({k: named[k] for k in held})}


def _tp_reference_train(flags, device) -> tuple:
    """One process at the same global batch: the warm-up's loss and
    gradients (``_mp_reference``) and its peak memory with one AdamW step."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = lm.make_model(flags, torch.device(device))
    tokens = torch.from_numpy(lm.make_batch(np.random.default_rng(flags.seed), flags)).to(device)
    loss, _ = lm.copy_task_loss(model(tokens), tokens, flags.seq_len // 2)
    loss.backward()
    lm.make_optimizer(model.parameters(), flags.learning_rate).step()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    return float(loss.detach()), grads, peak


def phase_tp_lm(seed: int, device="cuda", widths=None, timeout: float = 600,
                tols: tuple = (TP_LOGIT_TOL, MP_LOSS_TOL, MP_GRAD_TOL), serve_cfg=None,
                train_args=None, steps: int = TP_LM_STEPS) -> dict:
    """The tensor-parallel arms on the one card (see TP_SERVE above).
    tp_serve checks: one stacked batch; the last prompt position's prefill
    logits against one process (``tols[0]``); the replies equal one
    process's generate() up to a near-tie (reported); flash_fwd launched
    exactly once a block per rank in the served run; each rank holds 1/tp
    of the cut leaves plus the replicated ones.  tp_train checks: the
    warm-up loss (``tols[1]``, relative) and every gathered gradient leaf
    (``tols[2]`` of its own norm) against one process at the same global
    batch; the replicated leaves equal on every rank and each block equal
    across dp; each flash kernel launched exactly once a block a step per
    rank; each rank's peak memory below one process's."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    widths = LM_WIDTHS if widths is None else widths
    sv = TP_SERVE if serve_cfg is None else serve_cfg
    train_args = TP_TRAIN_ARGS if train_args is None else train_args
    wf = lm.make_flags(widths)
    res = {"phase": "tp_lm"}
    launches = {}
    ranks = _MpRanks(target=_tp_rank, name="tp_lm")
    failed = True
    probe = tempfile.mkdtemp(prefix="tp_lm_")
    try:
        # ---- tp_serve
        addr = f"127.0.0.1:{free_port()}"
        t_arm = time.perf_counter()
        ranks.start(("serve", {"widths": widths, "seed": seed, "device": device, "addr": addr,
                               "serve": sv}))
        if ranks.note(timeout) != "listening":
            raise AssertionError("tp_lm: rank 0 did not start serving")
        prompts = _tp_prompts(seed, wf.vocab, sv)
        B = sv["batch"]
        client = Rpc()
        client.set_name("tp_client")
        client.set_timeout(600)
        client.connect(addr)
        try:
            t_send = time.perf_counter()
            futs = [client.async_("tp_server", "generate", p) for p in prompts]
            deadline = time.monotonic() + 120
            while client.sync("tp_server", "generate_stats")["depth_max"] < B:
                if time.monotonic() > deadline:
                    raise TimeoutError("tp_serve: requests did not reach the server queue")
                time.sleep(0.01)
            ranks.tasks[0].put("go")
            replies = np.stack([np.asarray(f.result(timeout)) for f in futs])
            latency_ms = (time.perf_counter() - t_send) * 1e3
            ranks.tasks[0].put("replied")
        finally:
            client.close()
        reps = ranks.reports(timeout)
        serve_s = time.perf_counter() - t_arm
        if reps[0]["iterations"] != 1:
            raise AssertionError(f"tp_serve: served in {reps[0]['iterations']} iterations, not 1")
        n = sv["tp"]
        for r in reps:
            if device != "cpu" and r["launches"]["flash_fwd"] != wf.layers:
                raise AssertionError(f"tp_serve: rank {r['rank']} launched flash_fwd "
                                     f"{r['launches']['flash_fwd']} times, want {wf.layers}")
            b = r["param_bytes"]
            if b["sharded"] * n + b["replicated"] != b["whole"]:
                raise AssertionError(f"tp_serve: rank {r['rank']} holds {b}, not 1/{n} "
                                     "of the cut leaves")
        launches["tp_serve"] = {k: sum(r["launches"][k] for r in reps) for k in reps[0]["launches"]}
        if replies.shape != (B, sv["prompt"] + sv["new"]) or \
                not np.array_equal(replies[:, :sv["prompt"]], prompts):
            raise AssertionError(f"tp_serve: replies have shape {replies.shape} or lost their prompts")
        # One process on the card (the ranks hold no model now).
        t_ref = time.perf_counter()
        ref = _tp_serve_model(widths, sv, torch.device(device), seed)
        with torch.inference_mode():
            dev_prompts = torch.from_numpy(prompts).to(device)
            want_logits = ref.prefill(dev_prompts)[0][:, -1].float().cpu()
            want = generate(ref, dev_prompts, sv["new"]).cpu().numpy()
        got_logits = reps[0]["logits"]
        logit_err = (got_logits - want_logits).abs().max().item()
        logit_limit = tols[0] * max(1.0, want_logits.abs().max().item())
        if not logit_err <= logit_limit:
            raise AssertionError(f"tp_serve: prefill logits off by {logit_err} (limit {logit_limit})")
        divergences = []
        for i in range(B):
            if not np.array_equal(replies[i], want[i]):
                j, gap, limit = _first_divergence(ref, prompts[i], replies[i], want[i])
                if not gap < limit:
                    raise AssertionError(f"tp_serve: prompt {i} departs at new token {j} where "
                                         f"the top-two gap is {gap} (margin {limit})")
                divergences.append({"prompt": i, "new_token": j, "top2_gap": gap})
        del ref
        torch.cuda.empty_cache() if device == "cuda" else None
        res["tp_serve"] = {
            "tp": n, "batch": B, "prompt_len": sv["prompt"],
            "max_new_tokens": sv["new"], "request_latency_ms": latency_ms,
            "prefill_logit_err": logit_err, "prefill_logit_limit": logit_limit,
            "replies_equal_generate": not divergences, "near_tie_divergences": divergences,
            "prefill_ms": {r["rank"]: r["prefill_ms"] for r in reps},
            "decode_ms_per_token": {r["rank"]: r["decode_ms_per_token"] for r in reps},
            "host_staged_bytes": {r["rank"]: r["host_staged_bytes"] for r in reps},
            "max_memory_allocated": {r["rank"]: r["max_memory_allocated"] for r in reps},
            "param_bytes_per_rank": reps[0]["param_bytes"]["total"],
            "param_bytes_one_process": reps[0]["param_bytes"]["whole"],
            "param_bytes": {r["rank"]: r["param_bytes"] for r in reps},
            "cache_kv_heads_per_rank": reps[0]["cache_kv_heads"],
            "launches_per_rank": {r["rank"]: r["launches"]["flash_fwd"] for r in reps},
            "arm_wall_s": serve_s, "reference_s": time.perf_counter() - t_ref}
        log({"phase": "tp_lm", "arm": "tp_serve", **res["tp_serve"]})

        # ---- tp_train
        argv = [*widths, *train_args, "--mesh", "", "--attention", "flash",
                "--seed", str(seed), "--device", device]
        flags = lm.make_flags(argv)
        t_arm = time.perf_counter()
        ranks.start(("train", {"argv": argv, "device": device, "steps": steps,
                               "probe": os.path.join(probe, "step0.pt")}))
        reps = ranks.reports(timeout)
        train_s = time.perf_counter() - t_arm
        got = torch.load(os.path.join(probe, "step0.pt"))
        if len({r["replicated_sha256"] for r in reps}) != 1:
            raise AssertionError("tp_train: replicated parameters differ across ranks")
        for t in {r["coords"]["tp"] for r in reps}:
            if len({r["blocks_sha256"] for r in reps if r["coords"]["tp"] == t}) != 1:
                raise AssertionError(f"tp_train: the blocks of tp rank {t} differ across dp")
        want_n = flags.layers * (steps + 1)
        for r in reps:
            for k, v in r["launches"].items():
                if device != "cpu" and v != want_n:
                    raise AssertionError(f"tp_train: rank {r['rank']} launched {k} {v} times, "
                                         f"want {want_n}")
        launches["tp_train"] = {k: sum(r["launches"][k] for r in reps) for k in reps[0]["launches"]}
        torch.cuda.empty_cache() if device == "cuda" else None
        t_ref = time.perf_counter()
        ref_loss, ref_grads, ref_peak = _tp_reference_train(flags, device)
        if set(got["grads"]) != set(ref_grads):
            raise AssertionError("tp_train: gradient leaves differ")
        errs = _mp_grad_errors(got["grads"], ref_grads)
        del ref_grads
        worst = max(errs, key=errs.get)
        loss_err = abs(got["loss"] - ref_loss) / abs(ref_loss)
        if loss_err > tols[1] or errs[worst] > tols[2]:
            raise AssertionError(f"tp_train: loss {got['loss']} vs {ref_loss} (rel {loss_err}), "
                                 f"gradient leaf {worst} off by {errs[worst]} of its norm")
        peaks = {r["rank"]: r["max_memory_allocated"] for r in reps}
        if ref_peak is not None and not max(peaks.values()) < ref_peak:
            raise AssertionError(f"tp_train: peak memory per rank {peaks} not below one "
                                 f"process's {ref_peak}")
        res["tp_train"] = {
            "mesh": {"dp": 2, "tp": 2}, "batch": flags.batch_size, "seq_len": flags.seq_len,
            "loss_step0": got["loss"], "loss_step0_reference": ref_loss, "loss_rel_err": loss_err,
            "grad_rel_err_max": errs[worst], "grad_worst_leaf": worst,
            "grad_rel_err_median": float(np.median(list(errs.values()))),
            "step_s": reps[0]["step_s"], "losses": reps[0]["losses"],
            "tokens_per_s": flags.batch_size * flags.seq_len / float(np.median(reps[0]["step_s"])),
            "launches_per_rank": {r["rank"]: r["launches"] for r in reps},
            "max_memory_allocated": peaks, "max_memory_allocated_one_process": ref_peak,
            "host_staged_bytes": {r["rank"]: r["host_staged_bytes"] for r in reps},
            "param_bytes": {r["rank"]: r["param_bytes"] for r in reps},
            "arm_wall_s": train_s, "reference_s": time.perf_counter() - t_ref}
        log({"phase": "tp_lm", "arm": "tp_train", **res["tp_train"]})
        failed = False
    finally:
        ranks.close(failed)
        shutil.rmtree(probe, ignore_errors=True)
    res["launches"] = launches
    res["wall_s"] = time.perf_counter() - t_phase
    log({k: v for k, v in res.items() if k not in ("tp_serve", "tp_train")})
    return res


# -------------------------------------------------------------------- r2d2
# The JAX package's pixel R2D2 geometry (moolib_tpu/models/qnet.py:1-10,
# benchmarks/r2d2_bench.py): 18 actions, the (16, 32, 32) IMPALA encoder,
# Dense 512 -> LSTM 512, dueling heads, bf16 compute; 64 sequences of
# T = 80 (+1) at 84x84x4 uint8; clip_by_global_norm(40) then adam(1e-4),
# discount 0.997.  4,452,323 parameters.
R2D2_NET = dict(num_actions=18, encoder="impala", channels=(16, 32, 32), hidden_size=512,
                core_size=512)
R2D2_OBS = (84, 84, 4)
R2D2_DISCOUNT = 0.997
# r2d2_parity, card against CPU.  Values (q, the final core, td_loss's loss
# and priorities): the error over max(1, max|CPU value|).  Gradients: the
# largest error over every parameter, over the largest |CPU gradient|
# element of the model.
R2D2_VALUE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
R2D2_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
R2D2_LABELS = ("r2d2_add", "r2d2_sample", "r2d2_update", "r2d2_write_back")  # profiler ranges


def r2d2_item_bytes(obs=R2D2_OBS, T: int = 80, core: int = 512) -> int:
    """Bytes of one replay item: state [T+1, *obs] uint8, done [T+1] bool,
    action [T+1] int32, reward [T+1] f32 and the stored LSTM state, two
    [core] f32 (2,290,969 B at the full-width geometry)."""
    T1 = T + 1
    return T1 * int(np.prod(obs)) + T1 * (1 + 4 + 4) + 2 * core * 4


def qnet_forward_flops(obs, channels, hidden: int, core: int, num_actions: int,
                       frames: int) -> float:
    """Forward FLOPs of the pixel RecurrentQNet on ``frames`` frames, 2·m·k·n
    for every conv and matmul: the encoder as ``bench.analytic_forward_flops``
    counts it, Dense_0, Dense_1, the LSTM's input and hidden projections
    (4·core gates each) and the two dueling heads."""
    h, w, cin = obs
    flops = 0.0
    for ch in channels:
        flops += 2.0 * frames * h * w * 9 * cin * ch
        h, w = -(-h // 2), -(-w // 2)
        flops += 4 * 2.0 * frames * h * w * 9 * ch * ch  # two residual blocks, two convs each
        cin = ch
    flops += 2.0 * frames * (h * w * cin) * hidden + 2.0 * frames * hidden * core
    flops += 2 * 2.0 * frames * core * 4 * core
    flops += 2.0 * frames * core * (1 + num_actions)
    return flops


def r2d2_update_flops(obs, channels, hidden: int, core: int, num_actions: int,
                      frames: int) -> float:
    """The learner update's FLOPs: the online forward, the target forward and
    the backward at twice the forward: 4 x :func:`qnet_forward_flops`."""
    return 4 * qnet_forward_flops(obs, channels, hidden, core, num_actions, frames)


def r2d2_items(rng, n: int, obs, T: int, num_actions: int, core: int) -> list:
    """``n`` synthetic replay items of the example's layout (time-major per
    sequence, the stored initial LSTM state as a tuple)."""
    return [{"state": rng.integers(0, 256, (T + 1, *obs), dtype=np.uint8),
             "done": rng.random(T + 1) < 0.01,
             "action": rng.integers(0, num_actions, T + 1).astype(np.int32),
             "reward": rng.normal(size=T + 1).astype(np.float32),
             "core": tuple((0.1 * rng.normal(size=core)).astype(np.float32) for _ in range(2))}
            for _ in range(n)]


def qnet_flax_tree(model) -> dict:
    """A RecurrentQNet's weights as the flax parameter tree of numpy arrays,
    the inverse of models.convert.qnet_from_flax (conv kernels [kh, kw, in,
    out], the LSTM as OptimizedLSTMCell's eight gate tensors)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    tree: dict = {}
    for key, v in sd.items():
        if key.startswith("core."):
            continue
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
    if "core.bias" in sd:
        H = sd["core.hidden_kernel"].shape[0]
        cell = {}
        for i, g in enumerate("ifgo"):
            cols = slice(i * H, (i + 1) * H)
            cell[f"i{g}"] = {"kernel": sd["core.input_kernel"][:, cols]}
            cell[f"h{g}"] = {"kernel": sd["core.hidden_kernel"][:, cols],
                             "bias": sd["core.bias"][cols]}
        tree["Scan_Core_0"] = {"OptimizedLSTMCell_0": cell}
    return {"params": tree}


def _r2d2_batch(T1: int, B: int, obs, num_actions: int, core: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    done = rng.random((T1, B)) < 0.2
    done[1, 0] = True
    return {"state": rng.integers(0, 256, (T1, B, *obs), dtype=np.uint8), "done": done,
            "action": rng.integers(0, num_actions, (T1, B)).astype(np.int32),
            "reward": rng.normal(size=(T1, B)).astype(np.float32),
            "is_weight": (rng.random(B) + 0.5).astype(np.float32),
            "core": tuple(rng.normal(size=(B, core)).astype(np.float32) for _ in range(2))}


class PoolRoute:
    """Stands in for ``models.impala.max_pool_same`` while two runs of one
    model are compared.  The first run pools as the port does and records
    which input each window took; the second takes those same inputs (a
    differentiable gather), so both route the gradient alike.  A window
    whose two largest inputs lie within rounding of each other may pick
    another input on each device, and one such pick moves the encoder's f32
    gradients by ~1e-3 of their scale; ``flips`` counts the windows where the
    second run's own choice differs from the first's, and ``gap`` is the
    largest difference, in the second run, between its own choice and the
    input it took instead."""

    def __init__(self):
        self.taken, self.replay, self.flips, self.gap = [], None, 0, 0.0

    def __call__(self, x):
        (hl, hh), (wl, wh) = (impala_model.same_pool_padding(n) for n in x.shape[2:])
        xp = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
        idx = F.max_pool2d(xp.detach(), 3, 2, return_indices=True)[1]
        if self.replay is None:
            self.taken.append(idx.cpu())
            return self.pool(x)
        want = self.replay.pop(0).to(x.device)
        flipped = want != idx
        if flipped.any():
            flat = xp.detach().float().flatten(2)
            gaps = flat.gather(2, idx.flatten(2)) - flat.gather(2, want.flatten(2))
            self.flips += int(flipped.sum())
            self.gap = max(self.gap, gaps[flipped.flatten(2)].max().item())
        # Gathered in f32, so that the overlapping windows' gradients add up
        # in f32 and round once, as the pool's own backward does.
        taken = xp.float().flatten(2).gather(2, want.flatten(2))
        return taken.view(idx.shape).to(x.dtype)

    def compare(self, first, second):
        """(first(), second()) with the second run on the first's routes."""
        self.pool, impala_model.max_pool_same = impala_model.max_pool_same, self
        try:
            a = first()
            self.replay = self.taken
            b = second()
        finally:
            impala_model.max_pool_same = self.pool
        if self.replay:
            raise AssertionError(f"PoolRoute: {len(self.replay)} recorded pools not replayed")
        return a, b


def _r2d2_run(make, weights: tuple, batch: dict, device) -> dict:
    """q and the final core of a forward, then td_loss and its backward."""
    model, target = make(device=device), make(device=device)
    model.load_state_dict(weights[0])
    target.load_state_dict(weights[1])
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k != "core"}
    b["core"] = tuple(torch.from_numpy(c).to(device) for c in batch["core"])
    with torch.no_grad():
        out, (c, h) = model(b, b["core"])
    loss, prio = r2d2.td_loss(model, target, b, R2D2_DISCOUNT)
    loss.backward()
    return {"q": out["q"], "core_c": c, "core_h": h, "loss": loss.detach(), "prio": prio,
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def phase_r2d2_parity(seed: int, device="cuda", obs=R2D2_OBS, T1: int = 5, B: int = 4,
                      net=None) -> dict:
    """The full-width RecurrentQNet and examples.r2d2.td_loss on the card
    against the CPU, on weights converted from the flax layout; the CPU's
    max-pools take the windows' inputs the card's took (:class:`PoolRoute`)."""
    net = R2D2_NET if net is None else net
    out = {}
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        make = functools.partial(RecurrentQNet, dtype=dtype, obs_shape=obs, **net)
        weights = []
        for k in range(2):  # the online and the target network
            src = make(device="cpu", generator=torch.Generator().manual_seed(seed + 2 * i + k))
            converted = qnet_from_flax(qnet_flax_tree(src))
            if not all(torch.equal(converted[n], v) for n, v in src.state_dict().items()):
                raise AssertionError("r2d2_parity: qnet_from_flax(flax tree) != the weights")
            weights.append(converted)
        batch = _r2d2_batch(T1, B, obs, net["num_actions"], net["core_size"], seed + i)
        route = PoolRoute()
        got, want = route.compare(lambda: _r2d2_run(make, weights, batch, device),
                                  lambda: _r2d2_run(make, weights, batch, "cpu"))
        own = _r2d2_run(make, weights, batch, "cpu")["grads"]  # the CPU's own pool choices
        errs = {k: _parity_err(got[k], want[k]) for k in ("q", "core_c", "core_h", "loss", "prio")}
        scale = max(g.abs().max().item() for g in want["grads"].values())
        by_param = {n: (got["grads"][n].cpu().float() - g.float()).abs().max().item()
                    for n, g in want["grads"].items()}
        errs["grads"] = max(by_param.values()) / scale
        own_routes = max((got["grads"][n].cpu().float() - g.float()).abs().max().item()
                         for n, g in own.items()) / scale
        peak = {n: max(g.abs().max().item(), 1e-30) for n, g in want["grads"].items()}
        worst = sorted(by_param, key=lambda n: -by_param[n] / peak[n])
        name = "f32" if dtype == torch.float32 else "bf16"
        out[name] = {"errors": errs, "tol": {"values": R2D2_VALUE_TOL[dtype],
                                             "grads": R2D2_GRAD_TOL[dtype]},
                     "grad_scale": scale, "loss": want["loss"].item(),
                     "pool_windows_chosen_differently": route.flips,
                     "pool_largest_gap": route.gap,
                     # the gradients' error where the CPU pools by its own choices
                     "grads_with_own_pool_choices": own_routes,
                     # each parameter's error over its own largest |gradient|
                     "worst_params": {n: by_param[n] / peak[n] for n in worst[:3]}}
        log({"phase": "r2d2_parity_case", "dtype": name, **out[name]})
        tol = {k: R2D2_GRAD_TOL[dtype] if k == "grads" else R2D2_VALUE_TOL[dtype] for k in errs}
        bad = {k: e for k, e in errs.items() if not e <= tol[k]}
        if bad:
            raise AssertionError(f"r2d2_parity {name}: errors {bad} over tolerance")
    res = {"phase": "r2d2_parity", "net": {k: list(v) if isinstance(v, tuple) else v
                                           for k, v in net.items()},
           "obs": list(obs), "T+1": T1, "B": B,
           "params": sum(p.numel() for p in make(device="cpu").parameters()),
           "step": f"forward, then td_loss (double-Q, IS weights, discount {R2D2_DISCOUNT}) "
           "and its backward", "cases": out}
    log(res)
    return res


def check_priority_bitexact(device, ops: int = 200, seed: int = 7) -> bool:
    """benchmarks/r2d2_bench.py's check on the port: a seeded add/update
    schedule through a 128-slot shard and the numpy SumTree (f32) fed the
    shard's own transform; the trees compared bitwise."""
    shard = DeviceReplayShard(128, seed=seed, name="r2d2_check", device=device)
    ref = SumTree(128, dtype=np.float32)
    rng = np.random.default_rng(seed)

    def tf(p):
        return shard.priority_transform(np.asarray(p, np.float32)).cpu().numpy()

    for op in range(ops):
        if op % 2 == 0:
            items = [{"x": rng.normal(size=4).astype(np.float32)} for _ in range(8)]
            prios = (rng.random(8) * 2).astype(np.float32)
            ref.set(np.asarray(shard.add(items, prios)), tf(prios))
        elif len(shard) >= 16:
            idxs = rng.choice(len(shard), size=16, replace=False)
            prios = (rng.random(16) * 3).astype(np.float32)
            shard.update_priorities(idxs.astype(np.int32), prios)
            ref.set(idxs, tf(prios))
            shard.sample(16)
    return bool(np.array_equal(shard.tree.cpu().numpy(), ref.tree))


def _shard_checks(device) -> dict:
    """The shard's hazards on the device: last-wins duplicates, and a short
    insert that writes nothing past its lanes (no device-side assert)."""
    shard = DeviceReplayShard(32, alpha=1.0, name="r2d2_dup", device=device)
    shard.add([{"x": np.full(2, 1.0, np.float32)} for _ in range(8)], np.ones(8, np.float32))
    dup = np.asarray([3, 5, 3, 3, 7, 5, 0, 3], np.int64)
    prios = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], np.float32)
    shard.update_priorities(torch.from_numpy(dup).to(device), torch.from_numpy(prios).to(device))
    leaves = shard.leaf_priorities().cpu().numpy()
    want = np.ones(32, np.float32)
    want[8:] = 0
    want[dup] = prios[[7, 5, 7, 7, 4, 5, 6, 7]]
    if not np.array_equal(leaves, want):
        raise AssertionError(f"r2d2_learner: duplicate write-back is not last-wins: {leaves[:8]}")
    shard.add([{"x": np.full(2, 5.0, np.float32)} for _ in range(3)], np.full(3, 4.0, np.float32))
    ring = shard._ring[0].cpu()
    if not (torch.equal(ring[8:11], torch.full((3, 2), 5.0))
            and torch.equal(ring[11:], torch.zeros(21, 2))
            and shard.leaf_priorities().cpu()[11:].abs().sum().item() == 0):
        raise AssertionError("r2d2_learner: a short insert wrote past its lanes")
    if device.type == "cuda":
        torch.cuda.synchronize()  # a device-side assert would raise here
    return {"duplicates_last_wins": True, "short_insert_in_bounds": True}


def _r2d2_profile(cycle, cycles: int) -> dict:
    """One torch.profiler window of ``cycles`` learner cycles: the device
    time of each part of a cycle, and the window's busy time, idle share and
    top kernels.  add, sample and write-back are the kernels launched inside
    their record_function ranges; the update is the rest of the busy time
    (its backward runs on autograd's own thread, outside any range)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cycles):
            cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cpu = torch.autograd.DeviceType.CPU
    ranged = {name: sum(e.device_time_total for e in prof.events()
                        if e.name == name and e.device_type == cpu) / 1e3 / cycles
              for name in R2D2_LABELS}
    summary = profile_summary(prof, wall_ms, top=15, exclude=R2D2_LABELS)
    parts = {"add": ranged["r2d2_add"], "sample": ranged["r2d2_sample"],
             "write_back": ranged["r2d2_write_back"]}
    parts["update"] = summary["device_busy_ms"] / cycles - sum(parts.values())
    parts["update_forward_in_range"] = ranged["r2d2_update"]
    return {"parts_device_ms": parts, **summary}


def phase_r2d2_learner(seed: int, device="cuda", obs=R2D2_OBS, net=None, capacity: int = 4096,
                       T: int = 80, B: int = 64, insert: int = 16, pool: int = 64,
                       warmup: int = 5, cycles: int = 20, profile_cycles: int = 3,
                       target_update_interval: int = 100) -> dict:
    """benchmarks/r2d2_bench.py's device arm at the full-width geometry: a
    4096-sequence DeviceReplayShard on the card, then the learner cycle
    add -> sample -> time-major -> update -> priority write-back."""
    net = R2D2_NET if net is None else net
    dev = torch.device(device)
    A, core = net["num_actions"], net["core_size"]
    items = r2d2_items(np.random.default_rng(seed), pool, obs, T, A, core)
    shard = DeviceReplayShard(capacity, seed=seed, name="r2d2_learner", device=dev)
    turn = [0]

    def next_items():
        k = turn[0] * insert % pool
        turn[0] += 1
        return items[k : k + insert]

    t0 = time.perf_counter()
    while len(shard) < capacity:
        shard.add(next_items())
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    ring_bytes = shard.ring_bytes()
    if ring_bytes != capacity * r2d2_item_bytes(obs, T, core):
        raise AssertionError(f"r2d2_learner: the ring holds {ring_bytes} B, not "
                             f"{capacity} x {r2d2_item_bytes(obs, T, core)}")
    make = functools.partial(RecurrentQNet, dtype=torch.bfloat16, obs_shape=obs, device=dev, **net)
    model = make(generator=torch.Generator().manual_seed(seed))
    target = make().requires_grad_(False)
    params, target_params = list(model.parameters()), list(target.parameters())
    torch._foreach_copy_(target_params, params)
    opt = OptaxOptimizer(params, clip_by_global_norm(40.0), adam(1e-4))
    sgd = [0]

    def cycle():
        with torch.profiler.record_function("r2d2_add"):
            shard.add(next_items())
        with torch.profiler.record_function("r2d2_sample"):
            batch_items, idx, w = shard.sample(B)
            batch = r2d2.time_major(batch_items, w, dev)
        with torch.profiler.record_function("r2d2_update"):
            opt.zero_grad()
            loss, prio = r2d2.td_loss(model, target, batch, R2D2_DISCOUNT)
            loss.backward()
            opt.step()
            sgd[0] += 1
            if sgd[0] % target_update_interval == 0:
                torch._foreach_copy_(target_params, params)
        with torch.profiler.record_function("r2d2_write_back"):
            shard.update_priorities(idx, prio)
        return loss.detach()

    losses = [cycle() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(cycles)]
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        losses.append(cycle())
        end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / cycles
    peak = torch.cuda.max_memory_allocated()
    times = [a.elapsed_time(b) for a, b in events]
    prof = _r2d2_profile(cycle, profile_cycles)
    issue_ms = enqueue_ms(cycle, reps=5)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"r2d2_learner: non-finite losses {losses}")
    if shard.tree.device.type != dev.type or any(t.device.type != dev.type for t in shard._ring):
        raise AssertionError("r2d2_learner: the shard's tensors are not on the card")
    total = shard.total_host()
    leaf_sum = shard.leaf_priorities().double().sum().item()
    if not abs(total - leaf_sum) <= 1e-4 * leaf_sum:
        raise AssertionError(f"r2d2_learner: root {total} != leaf sum {leaf_sum}")
    if not check_priority_bitexact(dev):
        raise AssertionError("r2d2_learner: the shard's tree diverged from the numpy SumTree")
    checks = _shard_checks(dev)
    median = float(np.median(times))
    frames = T * B
    flops = r2d2_update_flops(obs, net["channels"], net["hidden_size"], core, A, (T + 1) * B)
    res = {"phase": "r2d2_learner",
           "model": "RecurrentQNet impala (16, 32, 32), 512/512, 18 actions, bf16 compute, "
           "f32 parameters; td_loss; clip_by_global_norm(40) + adam(1e-4); target every "
           f"{target_update_interval} SGD steps",
           "obs": list(obs), "T": T, "B": B, "capacity": capacity, "insert": insert,
           "item_bytes": r2d2_item_bytes(obs, T, core), "ring_bytes": ring_bytes,
           "host_pool_bytes": payload_bytes(items), "fill_s": fill_s,
           "fill_gb_per_s": ring_bytes / fill_s / 1e9, "cycles": cycles,
           "step_ms_median": median, "step_ms_min": min(times), "step_ms_max": max(times),
           "step_ms_host_clock": host_ms, "frames_per_s": frames / (median / 1e3),
           "frames_per_s_host_clock": frames / (host_ms / 1e3),
           "update_tflop": flops / 1e12,
           "update_flops_count": "4 x forward (online + target forward, backward at 2x); "
           "2mkn per conv and matmul at (T+1) x B frames",
           "tflops": flops / (median / 1e3) / 1e12,
           "mfu": flops / (median / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "parts_device_ms": prof["parts_device_ms"],
           "host_issue_ms_per_cycle": issue_ms,
           "device_busy_ms_per_cycle": prof["device_busy_ms"] / profile_cycles,
           "idle_share": prof["idle_share"],
           "launches_per_cycle": prof["kernel_launches"] / profile_cycles,
           "max_memory_allocated": peak, "first_loss": losses[0], "last_loss": losses[-1],
           "root_vs_leaf_sum": [total, leaf_sum], "priority_bitexact_200_ops": True, **checks}
    log(res)
    log({"phase": "r2d2_learner_profile", "window": f"{profile_cycles} learner cycles", **prof})
    return res


def _replay_cohort(device, item_shape, n_items: int, publishes: int, seed: int) -> dict:
    """Two ReplayShardService peers, each serving a device shard, a
    ReplayPublisher and a learner-side DistributedReplay over ipc loopback."""
    hub = Rpc()
    hub.set_name("r2d2-learner")
    hub.set_timeout(30)
    hub.listen(":0")
    addr = next(a for a in hub._listen_addrs if a.startswith("ipc://"))
    names = [f"r2d2-shard{i}" for i in range(2)]
    spokes, services = [], []
    try:
        for i, name in enumerate(names):
            r = Rpc()
            r.set_name(name)
            r.set_timeout(30)
            services.append(ReplayShardService(
                r, "replay", DeviceReplayShard(256, alpha=1.0, seed=seed + i, name=name,
                                               device=device), shard_index=i, num_shards=2))
            r.connect(addr)
            spokes.append(r)
        pub = ReplayPublisher(hub, names, "replay")
        deadline = time.time() + 10
        while not pub.multicast_ready() and time.time() < deadline:
            time.sleep(0.01)
        multicast = pub.multicast_ready()
        rng = np.random.default_rng(seed)
        items = [{"state": rng.normal(size=item_shape).astype(np.float32)}
                 for _ in range(n_items)]
        per_publish = payload_bytes(items)
        out0, in0 = _counter('replay_bytes_total{direction="ingest_out"}'), _counter(
            'replay_bytes_total{direction="ingest_in"}')
        t0 = time.perf_counter()
        for _ in range(publishes):
            pub.publish(items).result(30)
        publish_ms = (time.perf_counter() - t0) * 1e3 / publishes
        out_b = _counter('replay_bytes_total{direction="ingest_out"}') - out0
        in_b = _counter('replay_bytes_total{direction="ingest_in"}') - in0
        rep = DistributedReplay(rpc=hub, remote_peers=names, name="replay", seed=seed)
        sizes = [st["size"] for st in rep.stats()]  # drains the queued stripes
        stripe = n_items // 2 * publishes
        if not (multicast and out_b == per_publish * publishes and in_b == out_b
                and sizes == [stripe, stripe]):
            raise AssertionError(f"r2d2_replay: multicast {multicast}, ingest_out {out_b} "
                                 f"(payload x publishes {per_publish * publishes}), ingest_in "
                                 f"{in_b}, shard sizes {sizes} (stripes {stripe})")
        if any(s._shard.tree.device.type != torch.device(device).type for s in services):
            raise AssertionError("r2d2_replay: a shard's tree is not on the card")
        before = [st["total"] for st in rep.stats()]
        t0 = time.perf_counter()
        batch, ref, w = rep.sample(8)
        sample_ms = (time.perf_counter() - t0) * 1e3
        rep.update_priorities(ref, np.full(8, 50.0, np.float32))
        deadline = time.time() + 10
        while time.time() < deadline:  # the remote write-back is fire-and-forget
            after = [st["total"] for st in rep.stats()]
            if after[ref.shard] > before[ref.shard]:
                break
            time.sleep(0.05)
        if not (after[ref.shard] > before[ref.shard] and after[1 - ref.shard] == before[
                1 - ref.shard] and np.asarray(batch["state"]).shape == (8, *item_shape)):
            raise AssertionError(f"r2d2_replay: write-back to shard {ref.shard} did not land "
                                 f"there: totals {before} -> {after}")
        return {"shards": 2, "items_per_publish": n_items, "item_shape": list(item_shape),
                "publishes": publishes, "payload_bytes_per_publish": per_publish,
                "ingest_out_bytes": out_b, "ingest_in_bytes": in_b, "multicast_ready": multicast,
                "write_once": True, "shard_sizes": sizes, "publish_ms": publish_ms,
                "cohort_sample_ms": sample_ms, "write_back_shard": ref.shard,
                "totals_before": before, "totals_after": after}
    finally:
        for r in spokes:
            r.close()
        hub.close()


def phase_r2d2_replay(seed: int, device="cuda", item_shape=(21, 512), n_items: int = 32,
                      publishes: int = 4, agent_steps: int = 3000) -> dict:
    """The replay wire plane on the card, then examples.r2d2.train()."""
    cohort = _replay_cohort(device, item_shape, n_items, publishes, seed)
    ticks = []  # (host clock, env steps, SGD steps) at each of train()'s log ticks
    t0 = time.perf_counter()
    stats = r2d2.train(r2d2.make_flags([
        "--total_steps", str(agent_steps), "--min_replay", "32", "--quiet", "--device", device,
        "--seed", str(seed), "--log_interval", "0.5"]),
        on_stats=lambda st: ticks.append((time.perf_counter(), st["steps"], st["sgd_steps"])))
    end = time.perf_counter()
    if not (stats["sgd_steps"] > 0 and np.isfinite(stats["loss"])
            and stats["replay_device"].split(":")[0] == torch.device(device).type):
        raise AssertionError(f"r2d2_replay agent: sgd_steps {stats['sgd_steps']}, loss "
                             f"{stats['loss']}, replay on {stats['replay_device']}")
    # Rates from the first log tick on: the EnvPool's start is set-up.
    t1, steps1, sgd1 = ticks[0] if ticks else (t0, 0, 0)
    agent = {"env": "CartPole", "store": "DeviceReplayShard", "env_steps": stats["steps"],
             "sgd_steps": stats["sgd_steps"], "wall_s": end - t0, "setup_s": t1 - t0,
             "env_steps_per_s": (stats["steps"] - steps1) / (end - t1),
             "sgd_steps_per_s": (stats["sgd_steps"] - sgd1) / (end - t1),
             "loss": stats["loss"], "episodes": stats["episodes"],
             "replay_device": stats["replay_device"]}
    res = {"phase": "r2d2_replay", "cohort": cohort, "agent": agent}
    log(res)
    return res


# ----------------------------------------------------- fleet and durability
# durable_lm: three examples.lm.train() runs over one --checkpoint_dir: save
# at step 10, resume to 20, then (the newest truncated) fall back to 10.
DURABLE_STEPS = (10, 20, 10)
DCKPT_STEPS = 6  # dckpt_lm: applied steps of the two-learner cohort
TIMELINE_STEPS = 5


def _trees_equal(a, b) -> bool:
    """Bitwise equality of two checkpoint trees: the same structure, tensor
    leaves equal in dtype and bytes, every other leaf equal."""
    la, da = nest.tree_flatten(a)
    lb, db = nest.tree_flatten(b)
    if da != db:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
                return False
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def _params_sha(named: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(named):
        h.update(named[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_durable_lm(seed: int, device="cuda", widths=None, batch=(16, 1024),
                     steps=DURABLE_STEPS) -> dict:
    """examples.lm.train() with --checkpoint_dir: run 1 saves at step 10;
    the example's resume() into a fresh model and AdamW gives the saved
    params and AdamW state bit for bit; run 2 resumes and trains to 20;
    the newest checkpoint truncated, run 3 resumes from step 10 and counts
    one checkpoint_corrupt_skipped."""
    import shutil
    import tempfile

    from moolib_tpu_torch.checkpoint import Checkpointer
    from moolib_tpu_torch.testing import FaultPlan

    B, T = batch
    d = tempfile.mkdtemp(prefix="durable_lm-")
    base = list(LM_WIDTHS if widths is None else widths) + [
        "--seq_len", str(T), "--batch_size", str(B), "--attention", "flash", "--mesh", "",
        "--learning_rate", "1e-4", "--seed", str(seed), "--quiet", "--log_interval", str(10 ** 9),
        "--device", device, "--checkpoint_dir", d, "--checkpoint_interval", "1e9"]
    dev = torch.device(device)
    try:
        # The main path: counts start at 0 here and are read right after.
        fa.reset_launches()
        t0 = time.perf_counter()
        out1 = lm.train(lm.make_flags(base + ["--steps", str(steps[0])]))
        ck = Checkpointer(d)
        if out1["steps"] != steps[0] or ck.all_steps() != [steps[0]]:
            raise AssertionError(f"durable_lm: run 1 {out1['steps']} steps, saved {ck.all_steps()}")
        saved = ck.restore(map_location=dev)
        flags = lm.make_flags(base + ["--steps", str(steps[1])])
        model = lm.make_model(flags, dev)
        opt = lm.make_optimizer(model.parameters(), flags.learning_rate)
        if lm.resume(ck, model, opt, dev) != steps[0]:
            raise AssertionError("durable_lm: resume() did not find step 10")
        bit_exact = _trees_equal(lm.checkpoint_state(model, opt, steps[0]), saved)
        if not bit_exact:
            raise AssertionError("durable_lm: the resumed params or AdamW state differ from "
                                 "the saved ones")
        del model, opt, saved
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out2 = lm.train(flags)
        if (out2["start_step"], out2["steps"]) != (steps[0], steps[1]):
            raise AssertionError(f"durable_lm: run 2 went {out2['start_step']} -> {out2['steps']}")
        victim = FaultPlan(seed).truncate_checkpoint(d)
        skipped0 = _counter("checkpoint_corrupt_skipped")
        out3 = lm.train(lm.make_flags(base + ["--steps", str(steps[2])]))
        skipped = _counter("checkpoint_corrupt_skipped") - skipped0
        wall_s = time.perf_counter() - t0
        launches = _counts()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if (out3["start_step"], out3["steps"], skipped) != (steps[0], max(steps[0], steps[2]), 1):
        raise AssertionError(f"durable_lm: run 3 went {out3['start_step']} -> {out3['steps']} "
                             f"with {skipped} corrupt checkpoints skipped")
    losses = [o["loss"] for o in (out1, out2, out3) if o["steps"] > o["start_step"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"durable_lm: losses {losses}")
    # Every train() step (and each run's discarded warm-up pass) runs the
    # three kernels once per layer.
    layers = lm.make_flags(base).layers
    need = layers * (steps[1] + max(0, steps[2] - steps[0]))
    if dev.type == "cuda" and min(launches.values()) < need:
        raise AssertionError(f"durable_lm: kernel launches {launches}, each must be >= {need}")
    c1, c2, c3 = out1["checkpoint"], out2["checkpoint"], out3["checkpoint"]
    res = {"phase": "durable_lm", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 "
           "compute, f32 parameters, flash attention, AdamW" if widths is None
           else f"TransformerLM {widths}", "batch": B, "seq_len": T, "runs": [
               {"steps": f"{o['start_step']}->{o['steps']}", "loss": o["loss"]}
               for o in (out1, out2, out3)],
           "bit_exact_resume": bit_exact, "truncated": os.path.basename(victim or ""),
           "corrupt_skipped": skipped,
           "save_ms": [1e3 * c["save_s"] for c in (c1, c2, c3) if c["saves"]],
           "restore_ms": [1e3 * c["restore_s"] for c in (c2, c3)],
           "checkpoint_bytes": c1["bytes"],
           "gb_written": sum(c["bytes"] * c["saves"] for c in (c1, c2, c3) if c["saves"]) / 1e9,
           "save_GB_per_s": c1["bytes"] / c1["save_s"] / 1e9,
           "restore_GB_per_s": c2["bytes"] / c2["restore_s"] / 1e9,
           "launches": launches, "wall_s": wall_s}
    log(res)
    return res


def _dckpt_learner(rank, addr, seed, device, lm_cfg, batch, steps, ckpt_dir, out) -> None:
    try:
        _dckpt_learner_run(rank, addr, seed, device, lm_cfg, batch, steps, ckpt_dir, out)
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which fails
        import traceback

        out.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))


def _dckpt_learner_run(rank, addr, seed, device, lm_cfg, batch, steps, ckpt_dir, out) -> None:
    """One learner of dckpt_lm: the LM and AdamW on the card in an
    Accumulator cohort with the distributed checkpoint plane on; at every
    version it captures at, the probe loss (one flash forward/backward on a
    fixed batch) and the sha256 of its f32 parameters."""
    from moolib_tpu_torch import Accumulator
    from moolib_tpu_torch.checkpoint import DistributedCheckpointer
    from moolib_tpu_torch.examples.common import copy_into, finish_together

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**lm_cfg, attention="flash", dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(seed))
    opt = lm.make_optimizer(model.parameters(), 1e-4)
    named = dict(model.named_parameters())
    B, T = batch
    rng = np.random.default_rng(seed + 1 + rank)
    probe = _probe_tokens(seed, lm_cfg, batch, dev)

    def loss_of(tokens):
        return lm.copy_task_loss(model(tokens), tokens, T // 2)[0]

    acc = Accumulator("dckpt_lm", named)
    acc.set_name(f"dckpt{rank}")
    acc.listen()
    acc.connect(addr)
    ck = DistributedCheckpointer(ckpt_dir, max_to_keep=1)
    applied = [0]
    acc.enable_distributed_checkpoint(ck, interval=1e-3, lead_steps=1, timeout=300.0,
                                      aux_fn=lambda: {"steps": applied[0]})
    fa.reset_launches()  # this learner's path: its steps, probes included
    stalls, history = [], {}
    deadline = time.time() + 600
    try:
        while True:
            if time.time() > deadline:
                raise AssertionError(f"dckpt_lm learner {rank}: no commit by the deadline "
                                     f"(applied {applied[0]}, {ck.stats()}, aborts "
                                     f"{_counter('checkpoint_aborts_total')})")
            acc.update()
            before = ck.stats()
            acc.checkpoint_tick(state_fn=lambda: {"opt_state": opt.state_dict()})
            after = ck.stats()
            if after["captures"] > before["captures"]:
                stalls.append(after["stall_s"] - before["stall_s"])
                opt.zero_grad(set_to_none=True)
                loss = loss_of(probe)
                loss.backward()
                opt.zero_grad(set_to_none=True)
                history[acc.model_version()] = (float(loss.detach()), _params_sha(named))
            if acc.wants_state():
                acc.set_state({"opt_state": opt.state_dict(), "steps": applied[0]})
            if acc.has_new_state():
                st = acc.state()
                if st is not None:
                    copy_into(named, acc.parameters())
                    lm._load_adamw_state(opt, st["opt_state"])
                    acc.set_parameters(named)
            if not acc.connected() or acc.cohort_size() < 2:
                time.sleep(0.01)
                continue
            if applied[0] >= steps:
                # The steps are done: wait (briefly) for a commit and for
                # this learner's own captures to be written.
                if deadline > time.time() + 180:
                    deadline = time.time() + 180
                st = ck.stats()
                if ck.committed_steps() and st["writes"] == st["captures"]:
                    break
                time.sleep(0.01)
            elif acc.has_gradients():
                grads = acc.gradients()
                for k, p in named.items():
                    p.grad = grads[k]
                opt.step()
                acc.set_parameters(named)
                acc.zero_gradients()
                applied[0] += 1
            elif acc.wants_gradients():
                tokens = torch.from_numpy(rng.integers(2, lm_cfg["vocab_size"], size=(B, T))).to(dev)
                opt.zero_grad(set_to_none=True)
                loss_of(tokens).backward()
                acc.reduce_gradients(B, {k: p.grad for k, p in named.items()})
            else:
                time.sleep(0.002)
        finish_together(acc._group, [acc])
        hist = telemetry.get_registry().snapshot().get("checkpoint_write_seconds", {})
        writes = [s["value"] for s in hist.get("series", ())]
        out.put((rank, {
            "rank": rank, "leader": acc.is_leader(), "model_version": acc.model_version(),
            "applied": applied[0], "history": {str(k): v for k, v in history.items()},
            "stall_s": stalls, "stats": ck.stats(),
            "write_s_sum": sum(w["sum"] for w in writes),
            "write_count": sum(w["count"] for w in writes),
            "aborts": _counter("checkpoint_aborts_total"), "launches": _counts(),
            "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else 0}))
    finally:
        ck.close()
        acc.close()


def _probe_tokens(seed, lm_cfg, batch, dev):
    B, T = batch
    return torch.from_numpy(np.random.default_rng(seed + 100).integers(
        2, lm_cfg["vocab_size"], size=(B, T))).to(dev)


def phase_dckpt_lm(seed: int, device="cuda", lm_cfg=None, batch=COHORT_LM_BATCH,
                   steps: int = DCKPT_STEPS, timeout: float = 900) -> dict:
    """Two learner processes commit a distributed checkpoint of the LM and
    its AdamW state; this process restores it as a cohort of one (the
    2-host shards re-cut onto 1) and checks the blob, the parameters and
    the probe loss against the learners'."""
    import multiprocessing as mp
    import shutil
    import tempfile

    from moolib_tpu_torch.checkpoint import DistributedCheckpointer

    lm_cfg = dict(COHORT_LM if lm_cfg is None else lm_cfg)
    d = tempfile.mkdtemp(prefix="dckpt_lm-")
    port = free_port()
    broker = start_broker(port)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_dckpt_learner, args=(r, f"127.0.0.1:{port}", seed, device,
                                                      lm_cfg, batch, steps, d, out))
             for r in range(2)]
    try:
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        reports = {}
        deadline = time.time() + timeout
        while len(reports) < 2:
            try:
                rank, rep = out.get(timeout=5)
            except queue.Empty:
                if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(f"dckpt_lm: learners {[p.exitcode for p in procs]} "
                                         f"reported {sorted(reports)}")
                continue
            if "error" in rep:
                raise AssertionError(f"dckpt_lm learner {rank}: {rep['error']}")
            reports[rank] = rep
        for p in procs:
            p.join(timeout=120)
            if p.exitcode != 0:
                raise AssertionError(f"dckpt_lm: learner exit code {p.exitcode}")
        cohort_s = time.perf_counter() - t0

        reader = DistributedCheckpointer(d)
        step = reader.latest_committed_step()
        with open(os.path.join(d, f"step_{step}", "cohort_manifest.json")) as f:
            cohort = json.load(f)
        shard_shas = []
        for r in range(cohort["world"]):
            with open(os.path.join(d, f"step_{step}", f"manifest_{r}.json")) as f:
                shard_shas.append(json.load(f)["blob_sha256"])
        if cohort["world"] != 2 or set(shard_shas) != {cohort["blob_sha256"]}:
            raise AssertionError(f"dckpt_lm: world {cohort['world']}, shard shas {shard_shas}, "
                                 f"cohort sha {cohort['blob_sha256']}")
        dev = torch.device(device)
        t1 = time.perf_counter()
        got_step, (params, _buffers, state) = reader.restore(step=step, map_location=dev)
        restore_s = time.perf_counter() - t1
        import hashlib

        blob = reader.last_restored[2]
        blob_sha = hashlib.sha256(blob).hexdigest()
        nbytes = len(blob)
        del blob
        if got_step != step or blob_sha != cohort["blob_sha256"]:
            raise AssertionError(f"dckpt_lm: restored step {got_step} sha {blob_sha[:16]}, "
                                 f"committed {step} sha {cohort['blob_sha256'][:16]}")
        model = TransformerLM(**lm_cfg, attention="flash", dtype=torch.bfloat16, device=dev)
        named = dict(model.named_parameters())
        if sorted(named) != sorted(params):
            raise AssertionError("dckpt_lm: restored parameter names differ from the model's")
        with torch.no_grad():
            for k, p_ in named.items():
                p_.copy_(params[k])
        want = [r["history"].get(str(step)) for r in reports.values()]
        if any(w is None for w in want) or len({tuple(w) for w in want}) != 1:
            raise AssertionError(f"dckpt_lm: the learners' records at step {step}: {want}")
        want_loss, want_sha = want[0]
        got_sha = _params_sha(named)
        probe = _probe_tokens(seed, lm_cfg, batch, dev)
        loss = lm.copy_task_loss(model(probe), probe, batch[1] // 2)[0]
        loss.backward()
        got_loss = float(loss.detach())
        if got_sha != want_sha or got_loss != want_loss:
            raise AssertionError(f"dckpt_lm: restored params sha {got_sha[:16]} loss {got_loss}, "
                                 f"learners' {want_sha[:16]} {want_loss}")
        if "opt_state" not in state or "steps" not in state:
            raise AssertionError(f"dckpt_lm: restored state keys {sorted(state)}")
        aux_steps = state["steps"]
        del model, named, params, state, loss
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        stop_process(broker)
        shutil.rmtree(d, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in reports.values()) for k in reports[0]["launches"]}
    if dev.type == "cuda" and min(launches.values()) < 2 * lm_cfg["num_layers"] * steps:
        raise AssertionError(f"dckpt_lm: kernel launches {launches}")
    stalls = [x for r in reports.values() for x in r["stall_s"]]
    res = {"phase": "dckpt_lm", "processes": 2,
           "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 max_len 1024, learned "
           "positions, bf16 compute, f32 parameters, flash attention, AdamW" if lm_cfg == COHORT_LM
           else f"TransformerLM {lm_cfg}", "batch_per_learner": list(batch), "steps": steps,
           "committed_step": step, "blob_bytes": nbytes, "blob_sha16": cohort["blob_sha256"][:16],
           "shard_reports_one_sha": True, "restored_as_world": 1, "restore_s": restore_s,
           "restored_params_sha_equal": True, "probe_loss": got_loss,
           "probe_loss_equal": True, "aux_steps": aux_steps,
           "checkpoint_stall_seconds": stalls,
           "checkpoint_write_seconds_mean": sum(r["write_s_sum"] for r in reports.values())
           / max(1, sum(r["write_count"] for r in reports.values())),
           "captures": [r["stats"]["captures"] for r in reports.values()],
           "commits": [r["stats"]["commits"] for r in reports.values()],
           "aborts": [r["aborts"] for r in reports.values()],
           "launches": launches, "cohort_wall_s": cohort_s,
           "max_memory_allocated": [r["max_memory_allocated"] for r in reports.values()]}
    log(res)
    return res


def phase_timeline_lm(seed: int, device="cuda", widths=None, batch=(16, 1024),
                      steps: int = TIMELINE_STEPS) -> dict:
    """One timeline window (telemetry.timeline.begin_window/end_window: a
    torch.profiler capture) over 5 train steps of the LM, each step a
    devmon.dispatch_span: the trace names the three flash kernels, each
    kernel starts after its step's dispatch began, the buckets partition
    the steps' wall time; then a __telemetry_profile window over loopback
    Rpc writes a trace of one more step."""
    from moolib_tpu_torch.telemetry import devmon, timeline

    B, T = batch
    dev = torch.device(device)
    flags = lm.make_flags(list(LM_WIDTHS if widths is None else widths) + [
        "--seq_len", str(T), "--batch_size", str(B), "--attention", "flash", "--mesh", "",
        "--seed", str(seed)])
    model = lm.make_model(flags, dev)
    opt = lm.make_optimizer(model.parameters(), 1e-4)
    rng = np.random.default_rng(seed)
    batches = [torch.from_numpy(lm.make_batch(rng, flags)).to(dev) for _ in range(steps + 2)]

    def step(tokens):
        with devmon.dispatch_span("lm.step"):
            opt.zero_grad(set_to_none=True)
            loss = lm.copy_task_loss(model(tokens), tokens, T // 2)[0]
            loss.backward()
            opt.step()

    step(batches[-1])  # warm-up outside the window
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fa.reset_launches()  # the path: the window's steps
    if not timeline.begin_window():
        raise AssertionError("timeline_lm: the window did not open")
    t0 = time.perf_counter()
    for tokens in batches[:steps]:
        step(tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rep = timeline.end_window()
    window_s = time.perf_counter() - t0
    launches = _counts()
    if rep is None or rep["steps"] != steps:
        raise AssertionError(f"timeline_lm: report {rep and rep['steps']} steps")
    row = rep["fns"]["lm.step"]
    total = row["total_seconds"]
    parts = sum(row["seconds"].values())
    if abs(parts - total) > 0.01 * total:
        raise AssertionError(f"timeline_lm: buckets {row['seconds']} sum to {parts}, "
                             f"steps' wall time {total}")
    slices = timeline.load_profiler_trace(rep["logdir"])
    kernels = {}
    for name in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel"):
        kernels[name] = sorted(s["ts_us"] for s in slices if name in s["name"])
    per_step = flags.layers
    if dev.type == "cuda":
        # The launch counters say how many ran; the trace must name each
        # kernel and hold no more records than were launched.  CUPTI may
        # lose a device record (one flash_fwd of 60 in one full run), so
        # the trace's count is reported beside the launches, not held to it.
        if any(not 0 < len(v) <= per_step * steps for v in kernels.values()):
            raise AssertionError(f"timeline_lm: kernels in the trace "
                                 f"{ {k: len(v) for k, v in kernels.items()} }, "
                                 f"{per_step * steps} launched each")
        # Clock alignment: the k-th flash_fwd record is the j-th launch for
        # some j >= k (records are only ever lost), so it belongs to step
        # k // layers or later and must start after that step's dispatch.
        unix_ns, perf_ns = rep["anchor"]
        starts = [(unix_ns + t0_ns - perf_ns) / 1e3 for _n, t0_ns, _t1 in rep["dispatches"]]
        gaps = [ts - starts[k // per_step]
                for k, ts in enumerate(kernels["flash_fwd_wgmma_kernel"])]
        if min(gaps) < -100.0:
            raise AssertionError(f"timeline_lm: a flash_fwd kernel starts {min(gaps):.1f} us "
                                 "before its step's dispatch")
    else:
        gaps = []

    # The RPC surface: a window opened and closed by a peer over loopback.
    host, client = Rpc(), Rpc()
    port = free_port()
    try:
        host.set_name("profiled")
        host.listen(f"127.0.0.1:{port}")
        telemetry.install_rpc_handlers(host)
        client.set_name("profiler")
        client.connect(f"127.0.0.1:{port}")
        import tempfile

        logdir = tempfile.mkdtemp(prefix="telemetry_profile-")
        started = client.sync("profiled", "__telemetry_profile", "start", logdir)
        if not started.get("ok"):
            raise AssertionError(f"timeline_lm: __telemetry_profile start: {started}")
        step(batches[steps])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stopped = client.sync("profiled", "__telemetry_profile", "stop")
        if not stopped.get("ok") or not os.path.exists(stopped["trace"]):
            raise AssertionError(f"timeline_lm: __telemetry_profile stop: {stopped}")
        with open(stopped["trace"]) as f:
            rpc_names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        rpc_kernel = any("flash_fwd_wgmma_kernel" in n for n in rpc_names)
        if dev.type == "cuda" and not rpc_kernel:
            raise AssertionError("timeline_lm: the RPC window's trace names no flash_fwd kernel")
        rpc_trace_bytes = os.path.getsize(stopped["trace"])
    finally:
        client.close()
        host.close()
    del model, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res = {"phase": "timeline_lm", "model": "TransformerLM vocab=32768 d=1024 L=12 H=8x128 bf16 "
           "compute, flash attention, AdamW" if widths is None else f"TransformerLM {widths}",
           "batch": B, "seq_len": T, "steps": rep["steps"], "window_s": window_s,
           "fractions": row["fractions"], "seconds": row["seconds"], "total_seconds": total,
           "device_slices": rep["slices"], "bubble": rep["bubble"],
           "kernels_in_trace": {k: len(v) for k, v in kernels.items()},
           "kernel_after_dispatch_min_gap_us": min(gaps) if gaps else None,
           "rpc_window": {"trace_bytes": rpc_trace_bytes, "names_flash_fwd": rpc_kernel,
                          "duration_s": stopped["duration_s"]},
           "launches": launches}
    log(res)
    return res


_CACHE_CHILD = r"""
import json, sys, time
sys.path.insert(0, %(root)r)
from moolib_tpu_torch.utils import init_compile_cache
d = init_compile_cache()
from moolib_tpu_torch.ops import _build
t0 = time.perf_counter()
_build.build_all()
# build_info after the builds (a later load() finds the library and says 0.0)
seconds = {n: i["seconds"] for n, i in _build.build_info.items()}
libs = {n: _build.load(n) for n in _build.kernel_names()}
print("RESULT=" + json.dumps({"dir": d, "wall_s": time.perf_counter() - t0,
      "seconds": seconds}), flush=True)
"""


def phase_compile_cache(timeout: float = 600) -> dict:
    """A child process with MOOLIB_COMPILE_CACHE at a fresh directory builds
    every kernel there (seconds > 0); a second child, a restarted peer,
    loads each library from it (build_info seconds 0.0)."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="kernel-cache-")
    env = dict(os.environ, MOOLIB_COMPILE_CACHE=d,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    runs = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", _CACHE_CHILD % {"root": ROOT}],
                                  capture_output=True, text=True, env=env, timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"compile_cache: child failed:\n{proc.stderr[-4000:]}")
            line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT=")][-1]
            runs.append(dict(json.loads(line[len("RESULT="):]),
                             process_s=time.perf_counter() - t0))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    first, second = runs
    names = sorted(first["seconds"])
    if first["dir"] != d or not all(first["seconds"][n] > 0 for n in names):
        raise AssertionError(f"compile_cache: first child {first}")
    if second["seconds"] != {n: 0.0 for n in names}:
        raise AssertionError(f"compile_cache: the restarted child rebuilt: {second['seconds']}")
    res = {"phase": "compile_cache", "kernels": names,
           "first": {"build_wall_s": first["wall_s"], "process_s": first["process_s"],
                     "nvcc_s": first["seconds"]},
           "restart": {"load_wall_s": second["wall_s"], "process_s": second["process_s"],
                       "nvcc_s": second["seconds"]}}
    log(res)
    return res


# anakin: the JAX package's Anakin operating point
# (benchmarks/agent_bench.py:167-176): catch_flat, ActorCriticNet, 256 x 2
# actor envs in one rollout, unroll 40, learner batch 128, virtual batch 512.
ANAKIN = {"actor_batch_size": 256, "num_actor_batches": 2, "batch_size": 128,
          "virtual_batch_size": 512, "unroll_length": 40}
ANAKIN_KEYS = 4096
ANAKIN_ENV_STEPS = 2000
# The learning check: the JAX bench's frame budget (agent_bench.py:177) at
# learning rate 2e-2, held to the tier-1 bar of tests/test_torch_jax_envs.py
# (mean episode return above 0.4).  The budget is 73 SGD steps of 20,480
# frames each, too few to learn Catch at the default 1e-3.
ANAKIN_FRAMES = 1_500_000
ANAKIN_LR = 0.02
ANAKIN_BAR = 0.4
BOUNDARY = experiment.BOUNDARY


def _boundary() -> dict:
    return {name: _counter(name) for name in BOUNDARY}


def _check_no_crossing(before: dict, what: str) -> dict:
    """The boundary counters' deltas since ``before``; raises unless all 0."""
    deltas = {k: v - before[k] for k, v in _boundary().items()}
    if any(deltas.values()):
        raise AssertionError(f"anakin: {what} moved bytes across the host boundary: {deltas}")
    return deltas


def _threefry_holds(device, n: int, seed: int) -> list:
    """The seeding contract's draws on the card against the port's CPU
    draws (the tier-1 tests hold those to jax.random), bit for bit."""
    keys = _threefry.fold_in(_threefry.seed(seed), torch.arange(n))
    data = (torch.arange(n) * 7919) % 100_003
    draws = {"fold_in": lambda k, d: _threefry.fold_in(k, d),
             "split_3": lambda k, d: _threefry.split(k, 3),
             "bits": lambda k, d: _threefry.random_bits(k),
             "randint_0_5": lambda k, d: _threefry.randint(k, 0, 5),
             "randint_-1_2": lambda k, d: _threefry.randint(k, -1, 2)}
    for name, fn in draws.items():
        want, got = fn(keys, data), fn(keys.to(device), data.to(device)).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"anakin: _threefry {name} differs on the card at "
                                 f"{int((got != want).sum())} of {want.numel()} words")
    return sorted(draws)


def _env_run(env, key, actions) -> tuple:
    """(obs, reward, done) of ``env`` stepped over ``actions`` [S, B], on
    the actions' device, kept there until the end."""
    S, B = actions.shape
    dev = actions.device
    state = jax_envs.batch_init(env, key.to(dev), B)
    obs = torch.empty((S, B, *env.obs_spec[0]), dtype=torch.uint8, device=dev)
    reward = torch.empty((S, B), dtype=torch.float32, device=dev)
    done = torch.empty((S, B), dtype=torch.bool, device=dev)
    for t in range(S):
        state, ts = jax_envs.batch_step(env, state, actions[t])
        obs[t], reward[t], done[t] = ts["state"], ts["reward"], ts["done"]
    return obs, reward, done


def _envs_hold(device, B: int, steps: int, seed: int) -> dict:
    """JaxCatch and JaxProcCatch, B envs for ``steps`` steps under a seeded
    action stream, on the card against the CPU: obs, reward and done
    bitwise equal across every auto-reset."""
    actions = torch.randint(0, 3, (steps, B), generator=torch.Generator().manual_seed(seed))
    key = _threefry.seed(seed)
    out = {}
    for name in ("catch_flat", "catch_proc"):
        env = jax_envs.make_jax_env(name)
        t0 = time.perf_counter()
        want = _env_run(env, key, actions)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = _env_run(env, key, actions.to(device))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        for field, g, w in zip(("obs", "reward", "done"), got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"anakin: {name} {field} differs between the card and "
                                     f"the CPU at {int((g.cpu() != w).sum())} places")
        out[name] = {"episodes": int(want[2].sum()), "card_ms_per_step": card_s / steps * 1e3,
                     "cpu_ms_per_step": cpu_s / steps * 1e3}
    return out


def _anakin_rollout(device, B: int, T: int, seed: int):
    model = ActorCriticNet(3, obs_size=50, use_lstm=False, device=device,
                           generator=torch.Generator().manual_seed(seed))
    return rollout.AnakinRollout(model, jax_envs.JaxCatch(), B, T,
                                 env_key=_threefry.seed(seed), act_seed=seed + 1)


def _unroll_equals_step(device, B: int, T: int, seed: int) -> None:
    """Two whole unrolls against 2T+1 per-step calls, same seeds: bitwise."""
    whole, stepped = _anakin_rollout(device, B, T, seed), _anakin_rollout(device, B, T, seed)
    for i, n in enumerate((T + 1, T)):
        got = whole.unroll()
        for _ in range(n):
            stepped.step()
        want = stepped.take_unroll()
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"anakin: unroll {i} {k}: unroll() differs from step()")


def _anakin_train(device, seed: int, cfg: dict, frames: int, lr: float, bar: float) -> dict:
    """examples.vtrace.experiment.train(--env_backend jax) at ``cfg`` for
    ``frames`` frames: the frames reach the learn Batcher on the card with
    no host crossing, and the mean episode return clears ``bar``."""
    argv = ["--env", "catch_flat", "--env_backend", "jax", "--device", str(device), "--quiet",
            "--seed", str(seed), "--total_steps", str(frames), "--learning_rate", str(lr),
            "--address", f"127.0.0.1:{free_port()}"]
    for k, v in cfg.items():
        argv += [f"--{k}", str(v)]
    before = _boundary()
    t0 = time.perf_counter()
    out = experiment.train(experiment.make_flags(argv))
    wall_s = time.perf_counter() - t0
    crossed = _check_no_crossing(before, "experiment.train(--env_backend jax)")
    ret = out["mean_episode_return"]
    if ret is None or not ret > bar:
        raise AssertionError(f"anakin: train reached a mean episode return of {ret}, not above "
                             f"the bar {bar} ({out['sgd_steps']} SGD steps)")
    return {"frames": out["steps"], "sps": out["sps"], "steady_sps": out["steady_sps"],
            "sgd_steps": out["sgd_steps"], "episodes": out["episodes"],
            "mean_episode_return": ret, "bar": bar, "learning_rate": lr, "wall_s": wall_s,
            "boundary_bytes": crossed}


def phase_anakin(seed: int, device="cuda", cfg=None, keys: int = ANAKIN_KEYS,
                 env_steps: int = ANAKIN_ENV_STEPS, frames: int = ANAKIN_FRAMES,
                 lr: float = ANAKIN_LR, bar: float = ANAKIN_BAR) -> dict:
    """The zero-crossing actor plane at the JAX package's Anakin operating
    point: the seeding contract and both envs on the card against the CPU,
    unroll() against step(), the unroll's time, launches and boundary bytes
    at full width, then the IMPALA loop on it."""
    t0 = time.perf_counter()
    cfg = dict(ANAKIN if cfg is None else cfg)
    B, T = cfg["actor_batch_size"] * cfg["num_actor_batches"], cfg["unroll_length"]
    res = {"phase": "anakin", "config": cfg, "envs": B, "unroll_length": T,
           "threefry_equal": _threefry_holds(device, keys, seed), "threefry_keys": keys,
           "env_steps": env_steps, "envs_equal": _envs_hold(device, B, env_steps, seed)}
    _unroll_equals_step(device, B, T, seed)
    res["unroll_equals_step"] = True

    roll = _anakin_rollout(device, B, T, seed)
    roll.unroll()  # the bootstrap unroll (T+1 steps); the timed ones take T
    before = _boundary()
    median, lo, hi = median_call_ms(roll.unroll, reps=6)
    issue_ms = enqueue_ms(roll.unroll, reps=3)
    prof = device_profile(roll.unroll, top=8)
    crossed = _check_no_crossing(before, "AnakinRollout.unroll()")
    stats_before = _counter("actor_stats_d2h_bytes_total")
    snap = roll.stats()
    moved = _counter("actor_stats_d2h_bytes_total") - stats_before
    if moved != 8 * (2 * B + 3):
        raise AssertionError(f"anakin: stats() counted {moved} bytes, moved {8 * (2 * B + 3)}")
    if snap["episodes"] <= 0 or snap["len_sum"] != 9 * snap["episodes"]:
        raise AssertionError(f"anakin: device episode stats {snap['episodes']} episodes, "
                             f"{snap['len_sum']} steps (catch episodes are 9 steps)")
    res["unroll"] = {"ms_median": median, "ms_min": lo, "ms_max": hi,
                     "acting_frames_per_s": B * T / (median / 1e3),
                     "launches": prof["kernel_launches"],
                     "launches_per_body_step": prof["kernel_launches"] / T,
                     "host_issue_ms": issue_ms, "device_busy_ms": prof["device_busy_ms"],
                     "idle_share": prof["idle_share"],
                     "boundary_bytes": crossed,
                     "stats_d2h_bytes": moved, "stats_episodes": snap["episodes"]}
    res["train"] = _anakin_train(device, seed, cfg, frames, lr, bar)
    res["wall_s"] = time.perf_counter() - t0
    log(res)
    log({"phase": "anakin_profile", "window": "one unroll", **prof})
    return res


# The Sebulba split at the Anakin operating point: 4 rank processes on the
# card over gloo, the first 2 an actor mesh of 256 envs each, the other 2 the
# dp=2 learner; the frame budget gives ~20 unrolls.
SEBULBA = dict(ANAKIN, mesh="dp=4", actor_mesh=2)
SEBULBA_FRAMES = 400_000


def _median_ms(seconds: list) -> float:
    return float(np.median(seconds) * 1e3)


def phase_sebulba(seed: int, device="cuda", cfg=None, frames: int = SEBULBA_FRAMES,
                  anakin=None) -> dict:
    """examples.vtrace.experiment.train(--mesh dp=4 --actor_mesh 2) at the
    Anakin operating point: this process is the learner's first rank (the
    loop), it spawns the two actor ranks and the second learner rank.
    Checks: the actor and learner ranks are disjoint; every byte of every
    unroll reached its learner rank as sent (the pairs' sha256 digests),
    and the handoff counted exactly the unrolls' bytes, by route; the actor
    ranks crossed no host-boundary bytes per frame; the learner ranks end
    with one set of parameters.  Prints each actor rank's unroll and
    handoff times, the learn step, acting frames/s and sps, beside the
    anakin phase's (``anakin``: its result)."""
    t0 = time.perf_counter()
    cfg = dict(SEBULBA if cfg is None else cfg)
    argv = ["--env", "catch_flat", "--env_backend", "jax", "--device", str(device), "--quiet",
            "--seed", str(seed), "--total_steps", str(frames), "--learning_rate", str(ANAKIN_LR),
            "--address", f"127.0.0.1:{free_port()}"]
    for k, v in cfg.items():
        argv += [f"--{k}", str(v)]
    out = experiment.train(experiment.make_flags(argv))
    wall_s = time.perf_counter() - t0
    seb = out["sebulba"]
    A, T = cfg["actor_mesh"], cfg["unroll_length"]
    actors, learners = seb["actors"], seb["learners"]
    if [a.get("role") for a in actors] != ["actor"] * A or \
            [a["rank"] for a in actors] != list(range(A)) or \
            any(rk.get("role") == "actor" for rk in learners):
        raise AssertionError(f"sebulba: ranks {[a.get('rank') for a in actors]} are not the "
                             f"{A} actor ranks, or a learner rank acted")
    for a, actor in enumerate(actors):
        if actor["unrolls"] != seb["unrolls"]:
            raise AssertionError(f"sebulba: actor rank {a} made {actor['unrolls']} of the "
                                 f"{seb['unrolls']} ticketed unrolls")
        if any(actor["boundary_bytes"].values()):
            raise AssertionError(f"sebulba: actor rank {a} crossed the host boundary: "
                                 f"{actor['boundary_bytes']}")
        for j, learner in enumerate(learners):
            if actor["digests"][f"tx:{A + j}"] != learner["digests"][f"rx:{a}"]:
                raise AssertionError(f"sebulba: the columns actor rank {a} sent learner rank "
                                     f"{A + j} did not arrive as sent")
    moved = {k: sum(rk["handoff_bytes"][k] for rk in learners) for k in
             ("batcher_d2d_bytes_total", "batcher_staged_bytes_total")}
    want = seb["unrolls"] * seb["unroll_bytes"]
    if sum(moved.values()) != want or (seb["route"] != "direct" and moved[
            "batcher_d2d_bytes_total"]):
        raise AssertionError(f"sebulba: the handoff counted {moved} for {want} unroll bytes "
                             f"over the {seb['route']} route")
    shas = {rk["params_sha256"] for rk in learners} | {out["params_sha256"]}
    if len(shas) != 1:
        raise AssertionError(f"sebulba: the learner ranks' parameters differ: {sorted(shas)}")
    per_actor = []
    for actor in actors:
        act = actor["seconds"]["act"][1:] or actor["seconds"]["act"]  # past the T+1 bootstrap
        ms = _median_ms(act)
        per_actor.append({"rank": actor["rank"], "envs": actor["envs"], "unroll_ms": ms,
                          "handoff_ms": _median_ms(actor["seconds"]["handoff"]),
                          "acting_frames_per_s": actor["envs"] * T / (ms / 1e3),
                          "param_refreshes": actor["param_refreshes"]})
    res = {"phase": "sebulba", "config": cfg, "route": seb["route"], "frames": out["steps"],
           "unrolls": seb["unrolls"], "unroll_bytes": seb["unroll_bytes"], "handoff_bytes": moved,
           "window": seb["window"], "param_refreshes": seb["param_refreshes"],
           "param_bytes": seb["param_bytes"], "sgd_steps": out["sgd_steps"],
           "columns_bitwise": True, "params_sha256_equal": True, "actor_boundary_bytes": 0,
           "actors": per_actor,
           "acting_frames_per_s": sum(a["acting_frames_per_s"] for a in per_actor),
           "learn_step_ms": _median_ms(seb["learn_s"][1:] or seb["learn_s"]),
           "learn_steps": len(seb["learn_s"]),
           "sps": out["sps"], "steady_sps": out["steady_sps"],
           "mean_episode_return": out["mean_episode_return"], "wall_s": wall_s}
    if anakin is not None:
        res["anakin"] = {"unroll_ms": anakin["unroll"]["ms_median"],
                         "acting_frames_per_s": anakin["unroll"]["acting_frames_per_s"],
                         "sps": anakin["train"]["sps"], "steady_sps": anakin["train"]["steady_sps"]}
    log(res)
    return res


def _hist(name: str) -> tuple:
    """(count, sum) of this process's histogram ``name``."""
    fam = telemetry.get_registry().snapshot().get(name) or {}
    vals = [s["value"] for s in fam.get("series", ()) if isinstance(s.get("value"), dict)]
    return sum(v.get("count", 0) for v in vals), sum(v.get("sum", 0.0) for v in vals)


def _disagg_run(rank: int, world: int, cfg: dict) -> dict:
    """One rank of the disagg_engine phase: the engine phase's LM from the
    same seed, split over ``world`` ranks (the first ``prefill`` prefill).
    A prefill rank serves and counts its launches from 0 after the warm-up's
    prefills; the owner warms up and serves traffic (a) through an engine
    replica registered with the broker at ``cfg["broker"]``."""
    from moolib_tpu_torch import parallel
    from moolib_tpu_torch.engine import ContinuousBatchingEngine, EngineService
    from moolib_tpu_torch.serving import bucket, bucket_shapes

    device, lm_cfg, ecfg = cfg["device"], cfg["lm"], cfg["engine"]
    cuda = torch.device(device).type == "cuda"
    parallel.initialize_distributed(None, None, None, device=device)
    mesh = parallel.make_mesh({"dp": world}, device_type=torch.device(device).type)
    model = TransformerLM(dtype=torch.bfloat16, device=device,
                          generator=torch.Generator().manual_seed(cfg["seed"]), **lm_cfg).eval()
    eng = ContinuousBatchingEngine(model, mesh=mesh, prefill_devices=cfg["prefill"], **ecfg)
    n_warm = len(set(bucket_shapes(ecfg["max_prompt_len"])))
    if rank < cfg["prefill"]:
        prefill, calls = eng._prefill, [0]

        def counted(toks, tp):
            calls[0] += 1
            if calls[0] == n_warm + 1:  # the first request after the warm-up
                fa.reset_launches()
            return prefill(toks, tp)

        eng._prefill = counted
        eng.follow()
        return {"role": "prefill", "prefills": calls[0] - n_warm, "launches": _counts()}
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    fa.reset_launches()
    reqs = _engine_requests(np.random.default_rng(cfg["seed"]), lm_cfg["vocab_size"],
                            cfg["traffic"])
    names = ("batcher_d2d_bytes_total", "batcher_staged_bytes_total")
    before, hist0 = experiment.counters(names), _hist("serve_engine_kv_handoff_seconds")
    with _ServeTimer(model, eng) as timer:
        arm = _serve_arm(cfg["broker"], "engine_disagg", "serve_engine_disagg",
                         lambda rpc: EngineService(rpc, eng, max_queue=256), reqs, cuda)
    after, hist1 = experiment.counters(names), _hist("serve_engine_kv_handoff_seconds")
    launches = _counts()
    H = lm_cfg["num_heads"]
    rows = sum(lm_cfg["num_layers"] * 2 * bucket(len(p), ecfg["max_prompt_len"]) * H
               * (lm_cfg["d_model"] // H) * 2 for p, b in reqs if b > 1)
    n = hist1[0] - hist0[0]
    st = eng.stats()
    eng.close()
    arm["replies"] = [r.tolist() for r in arm["replies"]]
    arm.pop("stats")
    return {"role": "decode", "arm": arm, "launches": launches, "warmup_s": warmup_s,
            "decode_ms_per_step": float(np.median([ms for ms, _ in timer.steps])),
            "kv_rows_bytes": rows, "kv_handoff_bytes": st["kv_handoff_bytes"],
            "handoff_counted": {k: after[k] - before[k] for k in names},
            "handoff_ms_per_request": (hist1[1] - hist0[1]) / max(n, 1) * 1e3,
            "handoffs": n, "remote_prefills": st["remote_prefills"], "joins": st["joins"]}


def _disagg_rank(rank: int, world: int, tasks, out, notes=None) -> None:
    """A rank process of the disagg_engine phase (``_MpRanks`` target)."""
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1")
    while (task := tasks.get()) is not None:
        cfg, port = task
        os.environ["MASTER_PORT"] = str(port)
        try:
            out.put({"rank": rank, **_disagg_run(rank, world, cfg)})
        except BaseException as e:  # reported to the parent, which fails, then re-raised
            import traceback

            out.put({"rank": rank, "error": f"{e!r}\n{traceback.format_exc()}"})
            raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def phase_disagg_engine(seed: int, device="cuda", engine=None, lm_cfg=None, engine_cfg=None,
                        traffic=None, timeout: float = 600) -> dict:
    """The engine phase's LM and traffic (a) through a split engine: two
    rank processes, rank 0 prefills (the flash forward), rank 1 owns the
    engine and decodes.  Checks: the replies equal the one-process
    engine's (``engine``: the engine phase's result); flash_fwd launches
    are exactly L per prompt on the prefill rank and 0 on the decode rank;
    the K/V bytes that crossed equal each joined request's [L, 2, Lb, Hk,
    hd] rows, counted once by route.  Prints latency, tokens/s, decode ms a
    step and handoff ms a request beside the one-process engine's."""
    t0 = time.perf_counter()
    lm_cfg = dict(ENGINE_LM, **(lm_cfg or {}))
    ecfg = dict(ENGINE, **(engine_cfg or {}))
    tr = dict(ENGINE_TRAFFIC, **(traffic or {}))
    cuda = torch.device(device).type == "cuda"
    port = free_port()
    broker = start_broker(port)
    ranks = _MpRanks(world=2, target=_disagg_rank, name="disagg_engine")
    failed = True
    try:
        pre, own = ranks.run({"device": str(device), "seed": seed, "lm": lm_cfg, "engine": ecfg,
                              "traffic": tr, "prefill": 1, "broker": f"127.0.0.1:{port}"},
                             timeout)
        failed = False
    finally:
        ranks.close(failed)
        stop_process(broker)
    L, arm = lm_cfg["num_layers"], own["arm"]
    n = tr["requests"]
    if engine is not None and arm["replies"] != [r.tolist() for r in engine["a_replies"]]:
        diff = [i for i, (x, y) in enumerate(zip(arm["replies"], engine["a_replies"]))
                if x != y.tolist()]
        raise AssertionError(f"disagg_engine: requests {diff} differ from the one-process "
                             "engine's replies")
    want = L * n if cuda else 0
    if pre["prefills"] != n or pre["launches"]["flash_fwd"] != want or \
            any(own["launches"].values()) or pre["launches"]["flash_bwd_dq"] or \
            pre["launches"]["flash_bwd_dkv"]:
        raise AssertionError(f"disagg_engine: {pre['prefills']} prefills, launches {pre['launches']} "
                             f"(prefill rank) and {own['launches']} (decode rank); flash_fwd must "
                             f"be exactly {want} and 0")
    counted = sum(own["handoff_counted"].values())
    if not own["kv_rows_bytes"] == own["kv_handoff_bytes"] == counted:
        raise AssertionError(f"disagg_engine: K/V rows {own['kv_rows_bytes']} bytes, "
                             f"{own['kv_handoff_bytes']} crossed, {counted} counted")
    del arm["replies"]
    res = {"phase": "disagg_engine", "ranks": {"prefill": [0], "decode": [1]},
           "traffic_a": {"requests": n, "prompt": list(tr["prompt"]),
                         "budgets": list(tr["budgets"])},
           "replies_equal_one_process": engine is not None,
           "launches": {"prefill_rank": pre["launches"], "decode_rank": own["launches"]},
           "kv_bytes": own["kv_handoff_bytes"], "handoff_counted": own["handoff_counted"],
           "handoff_ms_per_request": own["handoff_ms_per_request"], "handoffs": own["handoffs"],
           "decode_ms_per_step": own["decode_ms_per_step"], "warmup_s": own["warmup_s"],
           "latency_ms_p50": arm["latency_ms_p50"], "latency_ms_p99": arm["latency_ms_p99"],
           "tokens_per_s": arm["tokens_per_s"], "arm": arm,
           "wall_s": time.perf_counter() - t0}
    if engine is not None:
        a = engine["arms"]["a_engine"]
        res["one_process"] = {k: a[k] for k in ("latency_ms_p50", "latency_ms_p99",
                                                "tokens_per_s", "decode_ms_per_step")}
    log(res)
    return res


# ------------------------------------------------------------- fleet soaks
# The port's soaks (moolib_tpu_torch.scripts) at the card's widths, called
# through their own main().  serve_soak: the engine phase's LM behind two
# replica processes; chaos_soak: LM peers narrower than the LM, since its
# step targets and 1 s checkpoint cadence would take minutes at d 1024,
# and its --steps cut from the smoke profile's 60 to 30 for the script's
# time (PERF.md section 4).
SERVE_SOAK_ARGS = ["--engine", "--vocab", "32768", "--d_model", "1024", "--layers", "12",
                   "--heads", "8", "--attention", "flash", "--dtype", "bfloat16",
                   "--batch_size", "8", "--seq_len", "512", "--max_new_tokens", "16",
                   "--window_s", "20", "--qps", "8", "--fit_qps"]
CHAOS_SOAK_ARGS = ["--smoke", "--steps", "30", "--vocab", "4096", "--d_model", "256",
                   "--layers", "2", "--heads", "2", "--seq_len", "256", "--batch_size", "2",
                   "--attention", "flash"]


def _free_memory(device) -> dict:
    """The card's free and total bytes (``torch.cuda.mem_get_info``)."""
    if torch.device(device).type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info()
    return {"free_bytes": free, "total_bytes": total}


def _soak_argv(module, args: list, seed: int, device) -> tuple:
    """A soak's argv with its seed, device, a fresh work directory and its
    verdict file there: ``(argv, workdir, verdict path)``."""
    import tempfile

    work = tempfile.mkdtemp(prefix=module.__name__.rsplit(".", 1)[1] + "_")
    out = os.path.join(work, "verdict.json")
    return ([*args, "--seed", str(seed), "--device", str(torch.device(device)),
             "--workdir", work, "--out", out], work, out)


def _soak_verdict(name: str, rc: int, work: str, out: str) -> dict:
    """The verdict a soak wrote; fails the phase on a non-zero exit."""
    verdict = None
    if os.path.exists(out):
        with open(out) as f:
            verdict = json.load(f)
    if rc != 0:
        raise AssertionError(f"{name}: exit code {rc} (logs under {work}), verdict {verdict}")
    return verdict


def start_chaos_soak(seed: int, device="cuda", args=None) -> dict:
    """Start the chaos soak's main() in a process of its own (``python -m``)
    that never touches CUDA, so the EnvPool of its first phase forks its
    workers there rather than from a forkserver."""
    from moolib_tpu_torch.scripts import _soak, chaos_soak

    args = list(CHAOS_SOAK_ARGS if args is None else args)
    argv, work, out = _soak_argv(chaos_soak, args, seed, device)
    before = _free_memory(device)
    proc = subprocess.Popen([sys.executable, "-m", chaos_soak.__name__, *argv],
                            env=_soak.child_env(), cwd=ROOT)
    return {"proc": proc, "args": args, "work": work, "out": out, "device": device,
            "memory_before": before, "t0": time.perf_counter()}


def _layers(args: list) -> int:
    return int(args[args.index("--layers") + 1])


def stop_soak(proc) -> None:
    """Stop a soak's process: SIGINT first, so its cleanup kills the peers it
    started in sessions of their own, then :func:`stop_process`."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
    stop_process(proc)


def phase_serve_soak(seed: int, device="cuda", args=None) -> dict:
    from moolib_tpu_torch.scripts import serve_soak

    args = list(SERVE_SOAK_ARGS if args is None else args)
    before = _free_memory(device)
    argv, work, out = _soak_argv(serve_soak, args, seed, device)
    v = _soak_verdict("serve_soak", serve_soak.main(argv), work, out)
    after = _free_memory(device)
    k = v["survivor_kernel_launches"]
    if k is None:
        raise AssertionError("serve_soak: the survivor printed no kernel_launches line")
    want = _layers(args) * k["prefills"] if torch.device(device).type == "cuda" else 0
    if k["flash_fwd"] != want or k["flash_bwd_dq"] or k["flash_bwd_dkv"] or not k["prefills"]:
        raise AssertionError(f"serve_soak: survivor launches {k}, flash_fwd must be exactly "
                             f"{want} ({_layers(args)} x its prefills) and no backward")
    launches = {n: k[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    res = {"phase": "serve_soak", "args": args, "replica_rate_rps": v.get("replica_rate_rps"),
           "qps": v["qps"], "window_s": v["window_s"], "requests": v["requests"],
           "ok": v["ok"], "lost_requests": v["lost_requests"], "rejects": v["rejects"],
           "p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"], "kill": v["kill"],
           "survivor": v["survivor"], "swap": v["swap"], "gates": v["gates"],
           "survivor_prefills": k["prefills"], "launches": launches,
           "memory_before": before, "memory_after": after}
    log(res)
    return res


def phase_chaos_soak(seed: int, device="cuda", args=None, running=None) -> dict:
    """The chaos soak's checks; ``running``: a soak :func:`start_chaos_soak`
    started earlier (it ran beside another phase), else one started here."""
    run = running or start_chaos_soak(seed, device, args)
    args, device, before = run["args"], run["device"], run["memory_before"]
    try:
        rc = run["proc"].wait()
    finally:
        stop_soak(run["proc"])
    wall_s = time.perf_counter() - run["t0"]
    s = _soak_verdict("chaos_soak", rc, run["work"], run["out"])
    after = _free_memory(device)
    cuda = torch.device(device).type == "cuda"
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    # Every learn is one forward and one backward through each block, and
    # the warm-up pass one more.
    for what, k in (("phase 4's resumed peer", s["ckpt_distributed"]["resumed_kernel_launches"]),
                    ("phase 2's peer A", s["cohort"]["kernel_launches"])):
        want = _layers(args) * (k["learns"] + 1) if cuda else 0
        if any(k[n] != want for n in kernels) or not k["learns"]:
            raise AssertionError(f"chaos_soak: {what} launched {k}, each kernel must be exactly "
                                 f"{want} ({_layers(args)} x ({k['learns']} learns + 1))")
    d = s["ckpt_distributed"]
    res = {"phase": "chaos_soak", "args": args, "envpool": s["envpool"],
           "recovery_s": s["cohort"]["recovery_s"],
           "recovery_bound_s": s["cohort"]["recovery_bound_s"],
           "recovered": s["cohort"]["recovered"], "frame_faults": s["cohort"]["frame_faults"],
           "kill_resume": s["kill_resume"], "committed": d["committed"], "torn": d["torn"],
           "ckpt_async": d["ckpt_async"], "stall_per_capture_s": d["stall_per_capture_s"],
           "step_s": d["step_s"], "resumed_from": d["resumed_from"],
           "peer_a_launches": s["cohort"]["kernel_launches"],
           "launches": {n: d["resumed_kernel_launches"][n] for n in kernels},
           "resumed_learns": d["resumed_kernel_launches"]["learns"], "wall_s": wall_s,
           "memory_before": before, "memory_after": after}
    log(res)
    return res


def make_pool() -> EnvPool:
    """The data path's EnvPool, forked before the first CUDA call."""
    return EnvPool(SyntheticAtariEnv, **POOL)

def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    pool = make_pool()
    try:
        (kern, sass, train, sl, en, rl, cl, acl, r2, fleet, anakin, sharded, mp_lm, tp_lm,
         sebulba, dis, soaks) = _phases(pool, args.seed)
    finally:
        pool.close()
    case = kern["train"]
    replaces = {"flash_fwd": "moolib_tpu/ops/flash_attention.py:54",
                "flash_bwd_dq": "moolib_tpu/ops/flash_attention.py:249",
                "flash_bwd_dkv": "moolib_tpu/ops/flash_attention.py:296"}
    times = {"flash_fwd": (case["ms"], case["plain_ms"], case["sdpa_ms"]),
             "flash_bwd_dq": (case["dq_ms"], case["plain_bwd_ms"], case["sdpa_bwd_ms"]),
             "flash_bwd_dkv": (case["dkv_ms"], case["plain_bwd_ms"], case["sdpa_bwd_ms"])}
    # The instantiation the training shape runs (bf16, D 128, causal).
    built = {"flash_fwd": "flash_fwd_wgmma_kernel", "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}
    instance = {name: f"{kernel}<bf16,128,causal>" for name, kernel in built.items()}
    log({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"moolib_tpu_torch/ops/csrc/{name[:9]}.cu",
        "replaces": replaces[name],
        "launches": train["launches"][name],
        "launches_by_path": {"train": train["launches"][name],
                             "serve": sl["flash_fwd_launches"] if name == "flash_fwd" else 0,
                             "engine": en["launches"][name],
                             "impala_learner": rl["flash_launches"][name],
                             "cohort_lm": cl["launches"][name],
                             "accumulator_lm": sum(acl["launches"][name].values()),
                             "r2d2": r2[name],
                             **{path: fleet[path]["launches"][name] for path in fleet},
                             "anakin": anakin[name],
                             "sharded_lm": sharded["launches"][name],
                             "sharded_lm_sp_overlap": sharded["sp_launches"][name],
                             **{path: mp_lm[path][name] for path in mp_lm},
                             **{path: tp_lm[path][name] for path in tp_lm},
                             "sebulba": sebulba[name],
                             "disagg_engine_prefill": dis["prefill_rank"][name],
                             "disagg_engine_decode": dis["decode_rank"][name],
                             **{path: soaks[path][name] for path in soaks}},
        "max_abs_err": kern["worst"][name],
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": case["bound_ms"][name],
        "bound_by": case["bound_by"][name],
        "library_ms": times[name][2],
        "shape": case["shape"],
        "kernel": instance[name],
        "tensor_core_instructions": sum(sass[instance[name]].values()),
        "tflops": case["tflops"][name],
        "share_of_bound": case["bound_ms"][name] / times[name][0],
        "tp_shapes": _shape_rows(kern, name, ("tp_serve", "tp_train") if name == "flash_fwd"
                                 else ("tp_train",)),
        "sp_shapes": _shape_rows(kern, name, ("sp_diagonal", "sp_past")),
        "soak_shapes": _shape_rows(kern, name, ("serve_soak", "chaos_soak") if name == "flash_fwd"
                                   else ("chaos_soak",)),
    } for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


def _shape_rows(kern: dict, name: str, arms: tuple) -> dict:
    """A kernel's times at the per-rank shapes of the kernels phase's cases
    ``arms`` (bf16): tp_lm's (causal; the forward at both, the backward
    passes at the training one), sharded_lm's sp_overlap ring chunks
    (the causal diagonal and the non-causal past chunk) and the soaks'
    (causal; serve_soak's prefill runs the forward only)."""
    rows = {}
    for arm in arms:
        c = kern[arm]
        ms = {"flash_fwd": c["ms"], "flash_bwd_dq": c["dq_ms"], "flash_bwd_dkv": c["dkv_ms"]}[name]
        rows[arm] = {"shape": c["shape"], "causal": c["causal"], "ms": ms,
                     "plain_ms": c["plain_ms"] if name == "flash_fwd" else c["plain_bwd_ms"],
                     "library_ms": c["sdpa_ms"] if name == "flash_fwd" else c["sdpa_bwd_ms"],
                     "bound_ms": c["bound_ms"][name], "bound_by": c["bound_by"][name],
                     "share_of_bound": c["bound_ms"][name] / ms}
    return rows


PHASE_SECONDS: dict = {}  # each phase's wall seconds, in order (printed before the summary)


def timed(name: str, fn, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)


def _cut(argv: list) -> list:
    """An LM argv with ``--layers`` cut to CUT_LAYERS."""
    i = argv.index("--layers")
    return [*argv[:i + 1], str(CUT_LAYERS), *argv[i + 2:]]


def _phases(pool: EnvPool, seed: int) -> tuple:
    timed("device", phase_device)
    sass = timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kern = timed("kernels", phase_kernels, gen)
    timed("model", phase_model, gen)
    train = timed("train", phase_train, seed)
    timed("lm_bench", phase_lm_bench, seed)
    sl = timed("slice", phase_slice, seed)
    torch.cuda.empty_cache()
    en = timed("engine", phase_engine, seed)
    torch.cuda.empty_cache()
    # The disagg_engine path: each rank process counts from 0 after the
    # engine's warm-up (_disagg_run).
    dis = timed("disagg_engine", phase_disagg_engine, seed, engine=en)["launches"]
    timed("impala_parity", phase_impala_parity, seed)
    rl = timed("impala_learner", phase_impala_learner, pool, seed)
    timed("cohort_impala", phase_cohort_impala, seed)
    torch.cuda.empty_cache()  # the learner processes share the card
    cl = timed("cohort_lm", phase_cohort_lm, seed, lm_cfg=dict(COHORT_LM, num_layers=CUT_LAYERS))
    torch.cuda.empty_cache()
    timed("accumulator_impala", phase_accumulator_impala, seed)
    torch.cuda.empty_cache()
    acl = timed("accumulator_lm", phase_accumulator_lm, seed, args=_cut(ACC_LM_ARGS))
    torch.cuda.empty_cache()
    # The r2d2 path: counts start at 0 here and are read right after.
    fa.reset_launches()
    timed("r2d2_parity", phase_r2d2_parity, seed)
    timed("r2d2_learner", phase_r2d2_learner, seed)
    torch.cuda.empty_cache()
    timed("r2d2_replay", phase_r2d2_replay, seed)
    r2 = _counts()
    torch.cuda.empty_cache()
    fleet = {"durable_lm": timed("durable_lm", phase_durable_lm, seed, widths=_cut(LM_WIDTHS))}
    torch.cuda.empty_cache()
    fleet["dckpt_lm"] = timed("dckpt_lm", phase_dckpt_lm, seed,
                              lm_cfg=dict(COHORT_LM, num_layers=CUT_LAYERS))
    torch.cuda.empty_cache()
    fleet["timeline_lm"] = timed("timeline_lm", phase_timeline_lm, seed)
    timed("compile_cache", phase_compile_cache)
    torch.cuda.empty_cache()
    # The anakin path: counts start at 0 here and are read right after.
    fa.reset_launches()
    ak = timed("anakin", phase_anakin, seed)
    anakin = _counts()
    torch.cuda.empty_cache()
    # The sebulba path: counts start at 0 here and are read right after (the
    # spawned ranks run the catch MLP, which reaches no kernel).
    fa.reset_launches()
    timed("sebulba", phase_sebulba, seed, anakin=ak)
    sebulba = _counts()
    torch.cuda.empty_cache()
    # The sharded_lm path: every rank process counts from 0 (each host's
    # rank 0 resets in _cohort_child, its other rank starts fresh).
    sharded = timed("sharded_lm", phase_sharded_lm, seed)
    torch.cuda.empty_cache()
    # The soaks' paths: every process they start counts from 0 (a replica
    # after its warm-up).  The chaos soak's peers are host-bound and spend
    # most of its time starting (~15-25 s a process on the card), so it runs
    # beside mp_lm, tp_lm and serve_soak: its phase seconds are what it took
    # beyond them, its log line its own wall seconds.
    chaos = start_chaos_soak(seed)
    try:
        # The mp_lm paths: every rank process counts from 0 before each arm
        # (_mp_rank).
        mp_lm = timed("mp_lm", phase_mp_lm, seed)["launches"]
        torch.cuda.empty_cache()
        # The tp_lm paths: every rank process counts from 0 before each arm
        # (_tp_serve_rank, _tp_train_rank).
        tp_lm = timed("tp_lm", phase_tp_lm, seed)["launches"]
        torch.cuda.empty_cache()
        soaks = {"serve_soak": timed("serve_soak", phase_serve_soak, seed)["launches"]}
    except BaseException:
        stop_soak(chaos["proc"])
        raise
    torch.cuda.empty_cache()
    soaks["chaos_soak"] = timed("chaos_soak", phase_chaos_soak, seed, running=chaos)["launches"]
    log({"phase_seconds": PHASE_SECONDS, "total_s": round(sum(PHASE_SECONDS.values()), 1)})
    return (kern, sass, train, sl, en, rl, cl, acl, r2, fleet, anakin, sharded, mp_lm, tp_lm,
            sebulba, dis, soaks)


if __name__ == "__main__":
    main()
