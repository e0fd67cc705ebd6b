#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root with one visible card:

    python3 chip_smoke.py

Phases, each printing one line:

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. build: compiles the CUDA kernels from ``gym_flock_tpu_torch/csrc``.
3. K1 (``block_sums``) against its plain PyTorch version on the card, for
   both channel sets at B=16/N=4096, B=4/N=4096, B=8192/N=100, a ragged
   B=3/N=1000, a cross-block case with overlapping global ids, a ragged
   cross-block case (37 rows against 260 columns), and the edge-case swarms
   of ``edge_swarms`` at comm radii 0.9 and 2.0.  Tolerances: the degree
   (channel 8) exactly, channel 9 (min r^2) within 1 ulp, every other sum
   channel max |k - p| / (1 + |p|) < 1e-4 (the 1/r^4 channels are large and
   the summation orders differ); unused channels exactly zero; the
   coincident pair's NaN sums in the same places.  Kernel and plain times
   (median of 7 CUDA-event timings after a warm-up) at the main path's
   shapes, each with its launch geometry and its bound.
4. main path, ``FlockingLarge-v0`` (N=4096): ``batch_expert_rollout`` with
   B=16 and 16 steps.  K1 must have launched exactly once per reset draw,
   once for the reset's observation, once for the rollout's first pass and
   once per step.  The first step's action ``u`` (atol 1e-4) and
   observation (the feature-sum measure above, degree exact) are checked
   against the plain functions on the same states.  Then two fused steps
   from ``init_state`` of ``wide[..., 1:]`` of a ``[B, N, 5]`` tensor (not
   contiguous, 4 bytes into its storage) run on K1 (3 launches) and equal
   those from a contiguous copy.
5. main path, ``FlockingRelative-v0`` (N=100): ``batch_expert_rollout`` with
   B=8192 and 8 steps; the reset's acceptance test must have run on K1, and
   every fused pass on K6 (9 launches), then 8 more steps timed alone (9
   more).
6. banks and K5 (``rowmin``) against its plain PyTorch version on the card:
   ``make("ExploreFullEnv-v0", device="cuda")`` on the real ARL facility map
   (T >= 4096 is asserted: no procedural fallback) and ``Coverage-v0``;
   then K5 on the real operand at B=512, R=100 (random ``blocked`` at
   density 0.5), on the Coverage-v0 bank at B=8192, R=6, G=8, and on a ragged
   B=3, R=33, T=300, G=2 case with one fully blocked env.  Equal bit for bit
   (``torch.equal``).  Kernel and plain times at the first two shapes.
7. main path, ``ExploreFullEnv-v0`` (R=100, real map): ``batch_rollout``
   with B=512, 8 steps and the greedy expert.  K5 and K7 (the conflict
   resolution, ``ops.conflicts``) must each have launched exactly once per
   step, with no host-read conflict round; the first step's actions must
   equal those of the plain argmin controller on the same state with the
   same random draws, and K7's result on that step the plain fixed
   point's; the rewards must be finite with a positive total.  K7 (10
   launches queued, over 10; one call alone as ``call_ms``) and the fixed
   point timed at the phase's shape (median of 7), with K7's byte bound
   (12 B R).
8. main path, ``Coverage-v0`` (R=6, G=8): the same with B=8192, 16 steps.
9. K3 (``sparse_sums``) against its plain PyTorch version on the card, in
   the "core", "expert" and "full" channel sets, on sorted operands at
   (a) N=65,536, B=1 and (b) N=16,384, B=16, both in bench metric 4's state
   (positions uniform over a square of side sqrt(N), velocities standard
   normal, drawn with numpy from a fixed seed) with the Verlet table the
   main path builds, and (c) a ragged table at N=1,024, B=3 (pad slots
   first and past n_b), and (d) the edge-case swarms at comm radii 0.9 and
   2.0.  K1's tolerances; channel 9 exactly 0 in
   "expert".  At (b) the degree through ``flocking_sums_sparse`` must equal
   dense K1's (exact pruning).  K1 "core" against its plain version at (a),
   the shape of the overflow branch of phase 10's workload.  Kernel and
   plain times at (a) and (b), and dense K1's time at (a), each with its
   launch geometry and its bound.
10. main path, ``FlockingSparse-v0`` at N=65,536, B=1:
   ``batch_expert_rollout(..., init_state=...)`` for 32 steps from bench
   metric 4's state, whose table must not overflow.  K3 must have launched
   once per fused pass (33) and K1 never (this holds for the fixed seed:
   other seeds overflow at a rebuild); the first step's action and
   observation are checked against the plain pipeline on the same states.
11. main path, ``FlockingSparse-v0`` at its default N=16,384 with B=4,
   ``batch_expert_rollout`` from ``reset_env``, 8 steps.  The reset's draws
   overflow the table, so every acceptance test and every pass launches
   exactly one kernel, K3 or K1, and the K1 launches must equal the passes
   that the port found overflowing.  On the reset's state, K1 in "core" and
   "full" is held against its plain version (and "full" timed with its
   bound: the acceptance test's overflow pass), and the first step's
   action and observation against the plain pipeline.
12. K2 (``adj_matmul``) against its plain version on the card: (a) the
   trainer's batch, B=16, N=4096, F=6 (FlockingLarge-v0 reset draws), raw
   and mean-pooled; (b) a cross-block tile, rows 0..999 against columns
   600..1299 (the ids overlap), F=16; (c) dH of both pool modes and of the
   block form's swapped-operand backward at B=4, N=4096, F=6, against
   ``torch.autograd`` of the plain version; (d) the edge-case swarms of
   ``edge_swarms`` and one with a NaN position, at comm radii 0.9 and 2.0;
   (e) a ragged block (rows 130..1036 against columns 0..999, so each
   row's own column lies in the second tile) at F in ``ADJ_WIDTHS``.
   Tolerances: the degree exactly; outputs and gradients max |k - p| /
   (1 + |p|) < 1e-6 (both sum in f64 and round once).  Kernel and plain
   times at (a), and the kernel's at (b)'s tile at F=16 and F=8 (the cost
   of a second chunk of features), each with its launch geometry and
   bound.
13. K4 (``sparse_adj``) against its plain version, same tolerances, on
   sorted operands of phase 9's states: (a) N=65,536, B=1 with the table
   the aggregation builds (at sqrt(comm_radius2), no skin) and with phase
   9's Verlet table; (b) N=16,384, B=16, where the degree through the
   table must equal dense K2's; (c) dH through ``adjacency_matmul_sparse``
   on 4 of (b)'s swarms, both pool modes; (d) phase 11's reset state
   (N=16,384, B=4), whose table overflows: the pass must run on dense K2;
   (e) the edge-case swarms and a NaN position at comm radii 0.9 and 2.0;
   (f) a ragged table at N=1,024, B=3 (pad slots first and past the
   listed blocks) at F in ``ADJ_WIDTHS``.  Kernel and plain times at (a)
   and (b), each with its launch geometry and bound.
14. main path, ``LargeFlockingImitationTrainer`` on ``FlockingLarge-v0``
   (N=4096): a batch of 4 envs x 4 steps, 5 updates.  K2 must launch
   exactly twice an update (k_hops - 1) and never for a backward pass
   (the aggregation acts on inputs before every weight); the first loss
   must equal that of the same batch and weights through the plain
   aggregation within 1e-5 relative; losses finite, parameters moved.
   Prints the step's split: collect and update times, K2's and one K1
   pass's times by CUDA events.
15. main path, ``LargeAggregationGNN`` with ``khop_aggregate_sparse`` on
   ``FlockingSparse-v0`` at N=65,536: a batch of 4 steps from bench
   metric 4's state (phase 10's seed), 3 updates.  Every aggregation pass
   must run on K4 or, where its table overflows, on dense K2 (counted);
   K4 must have launched; the loss must equal the plain aggregation's.
16. main path, ``FlockingImitationTrainer`` on ``FlockingRelative-v0``
   (N=100): 1024 envs x 8 steps, 5 updates.  K1 runs in the resets (one
   launch per draw); the aggregation is dense ``torch.matmul``.
17. main path, ``CoverageImitationTrainer`` on ``CoverageARL-v0`` on the
   real ARL facility map (8 sub-windows, R=4, T=996; ``real_map=True``),
   ``EdgeGraphNet(latent=64, rounds=6)``: batches of 8 envs x 16 steps,
   5 updates.  K5 must launch exactly once per collect step; the first
   collect step's labels must equal the plain argmin controller's on the
   same state with the same random draws; the first loss must equal that
   of the same batch and weights on a CPU copy of the model within 1e-5
   relative; losses finite, parameters moved.  Prints the collect and
   update ms (host clock around ``torch.cuda.synchronize()``) and K5's
   time at this shape (B=8, R=4, T=996, on the first collect's state,
   bitwise equal to plain).  Then ``evaluate`` on the held-out bank
   (``bank_seed=1234``) at 64 envs x 50 steps: finite values, expert
   reward above 0, K5 once per expert step (its collect and the expert's
   episode).
18. ``CoverageDaggerTrainer`` on the same world: capacity 1024, two
   iterations of 8 envs x 16 steps, 32 grad steps of batch 128.  K5 once
   a step; ``write_pos``/``filled`` 128/128 then 256/256; at beta=1 the
   stored labels are the actions taken (replaying them from the same
   reset reproduces every stored observation).
19. ``collect_vrp_labeled_batch`` on the same world, 4 envs x 8 steps,
   ``or_default``, two worker threads; the VRP solver is built with g++
   from ``gym_flock_tpu_torch/experts/vrp/vrp_solver.cc`` into ``build/``.
   K5 once a step; every label in [0, A); the labels equal
   ``vrp_label_states`` on one thread and on two on the same states.
   Prints the labelling seconds.
20. ``DaggerTrainer`` on ``FlockingRelative-v0`` (N=100) with
   ``AggregationGNN(k_hops=4, hidden=(128, 128))``: two iterations of 8
   envs x 16 steps, 4 grad steps.  K1 once per reset draw; iteration 0's
   labels equal ``turner_controller`` on the stored states; losses
   finite, parameters moved.
21. the five flocking variants at N=100: ``Flocking-v0`` with B=8192 and
   ``FlockingLeader-v0``, ``FlockingObstacle-v0``, ``FlockingStochastic-v0``
   and ``FlockingTwoFlocks-v0`` with B=1024, each ``reset_env`` and 8 steps
   of ``expert_rollout``.  K1 exactly once per reset draw (none for the
   deterministic Obstacle and TwoFlocks resets), K6 once a fused pass of
   the four dense-network variants (the obstacle mask a kernel argument),
   no other kernel; K1
   ("full") on each randomly drawn reset state against its plain version:
   the degree and min r^2 (channels 8 and 9, the acceptance test's)
   exactly, the sums as in phase 3.
22. ``Shepherding-v0`` (10 shepherds, 20 sheep), B=4096, 64 expert steps;
   no kernel on this path.
23. ``FormationFlying-v0`` B=8192 and ``LQR-v0`` B=4096, 64 steps each
   under random actions, then 64 steps of LQR's expert (whose cost must be
   below the random actions'); the LQR system built on the card is held to
   the host's build (each matrix within 1e-3 of its largest entry).
24. ``Mapping-v0`` (N=100, T=10,000; bench metric 8's size) B=128 with 32
   greedy expert steps, and ``MappingVel-v0``, ``MappingDisc-v0``,
   ``MappingLocal-v0`` B=1024 with 4 steps each; the expert must observe
   targets.
25. ``FlockingMulti-v0`` (N=80), B=4096, 16 consensus expert steps: K1
   exactly once per reset draw, K2 exactly twice per aggregation (one call
   over the 12 pooled features, one launch a chunk of 8; the reset's
   aggregation and one a step).  K1 on the reset's state against its plain
   version as in phase 21; K2 on the reset's buffer against its plain
   version: the degree exactly, raw and mean-pooled sums max |k - p| / (1 +
   |p|) < 1e-6.  K1 ("full", the acceptance test) and K2 (F=12) timed at
   this shape.
   Each of phases 21-25 repeats its first step on the host from the first
   envs of the card's state (64; 4 for Mapping-v0): the action and the new
   state from the same state, the observation at the card's new state (the
   1/r^4 features of close pairs amplify the integration's rounding).
   Indices, masks, adjacency supports and LoS branches (on states whose
   bearings lie 1e-4 rad or more from the 2- and 5-degree thresholds)
   exactly; actions and rewards atol 1e-4, states atol 1e-5, feature sums
   max |k - p| / (1 + |p|) < 1e-4, mean-pooled networks atol 1e-6, an LQR
   step max |k - p| / (1 + |p|) < 1e-5; stochastic steps with their dt
   replayed or their noise zeroed on both sides.

26-28. the coverage flag modes and the bank's disk cache, the gym facades
   and the AirSim bridges (their functions' docstrings say what each holds).
29. ``parallel.distributed.initialize`` on NCCL at world size 1 (a
   ``file://`` rendezvous in the run's temporary directory); a failure
   raises.  One all-reduce and one all-gather timed.
30. the agent shard's ring at P=4 on one card: K1's and K2's 16 (rank,
   source) tiles of FlockingLarge-v0's reset state (B=16, N=4096) with
   their global offsets, combined in ring order, held to the plain
   version's tiles combined alike (K1's tolerances; K2's degree exactly and
   1e-6, forward and the swapped-tile backward) and to one pass over the
   whole swarm (the degree and channel 9 alike, the sums to the f32
   rounding of their partials); the all-gather mode's tiles to unsharded K1.
31. ``agent_sharded_rollout`` B=16 N=4096 16 steps on a 1 x 1 mesh, ring
   and all-gather: K1 exactly once per reset draw, once for the first
   controller and once per step; the reset equal to
   ``LargeFlockingEnv.reset_env``'s, the first step to the env's
   controller, integrator and observation and to the plain pipeline on
   the host.
32. the sharded train steps at world size 1: the agent-sharded step on
   phase 14's batch (K2 twice an update, never backward, the first loss
   phase 14's within 1e-5), and 2 steps each of the data-parallel flocking
   step (phase 16's size), the sharded DAgger iteration (phase 20's) and
   the data-parallel coverage step (phase 17's): K1 once a reset draw, K5
   once a collect step.
33. ``parity_exact`` at float64: FlockingRelative-v0 50 expert steps on the
   card bitwise equal to the host's; Shepherding-v0's and Mapping-v0's
   largest ulp gap to the host, each step from the card's state.
34. the legacy facade's lookahead: phase 27's 1500-pair loop on
   FlockingRelative-v0, Coverage-v0 and CoverageARL-v0 (real map), once
   with the lookahead and once on a twin whose queue is flushed after every
   controller call (the eager path: each call computed as it comes): every
   observation, reward and done equal bit for bit, call for call, and the
   final generator states equal; K1 exactly once a reset draw, K5 exactly
   once a greedy controller evaluation.  Pairs/s of both, the depth
   reached, and the launches and synchronisations a pair of a traced
   window of the lookahead.  Then the 120-event randomized interleaving of
   ``tests/test_torch_legacy_lookahead.py`` against the twin on
   FlockingRelative-v0 and Coverage-v0, the facade queueing after every
   hit.
35. the example drivers on the card: ``examples/torch_run_flocking.py``
   (single stream and batched), ``torch_run_coverage.py`` (greedy, real
   map), ``torch_run_shepherding.py`` (single and batched) and
   ``torch_train_flocking_large.py``, each a subprocess of a few steps,
   all at once; each must exit with 0.
36. the pipelines of ``tools/train_quality_torch.py`` at full width with few
   iterations, through its functions: flocking BC (FlockingRelative-v0
   N=100, ``AggregationGNN(4, (128, 128))``, 16 iterations of 8 envs x 8
   steps on ``cosine_decay_schedule(1e-3, 16, alpha=0.03)``): every
   update's Adam ``lr`` equal to the schedule's, K1 exactly once a reset
   draw, the first loss a CPU copy's within 1e-5 relative; flocking DAgger,
   2 iterations; VRP-label BC on phase 17's banks and phase 19's solver,
   2 envs x 4 states labelled in both descent orders, two models from equal
   weights trained 2 epochs, K5 once a rollout step and once a collect and
   an expert step of each evaluation.  The flocking closed loop at 8 envs x
   20 steps in its three modes: equal reset states, finite rewards, the
   expert's cost below random's.  Then K1 "full" at B=8 and B=64, N=100
   (the closed loop's and a B=64 reset's states, against plain as phase
   21 holds it) and K5 at B=32, R=4, T=996 (bitwise), timed with bounds.
37. K6 (``dense_pass``) against its plain version at B=8192 and B=8, N=100
   (reset draws), centralized and not, without and with an obstacle mask
   (agents 0-3), writing into a trajectory's slots: the network bit for
   bit, each sum within ``DENSE_TOL`` of the plain version's relative to
   the summed magnitudes of its terms (``dense_pass_scales``), and the sums
   alone equal to the full pass's.  The kernel (full, and sums alone: 10
   launches queued back to back, over 10; one call alone as ``call_ms``),
   the plain version and its bound (median of 7).  These checks' and
   timings' launches are not counted in the kernel line's ``launches``,
   which sums phases 5 and 21.
38. K8 (``step_tail``) against its plain version at the three flocking
   cells' shapes (B=65,535 and B=8192 at N=100 on K6's sums, B=16 at
   N=4096 on K1's), each on every source of sums the shape allows (K6's
   interleaved sums, K1's channels 6/7 with the closed form's velocity
   sums, K1's decentralized 10/11/0/3), without and with an integration
   mask (agents 0-3 frozen, the masked envs' scale 1), writing into a
   trajectory's slots: x' and u bit for bit, the reward within
   ``STEP_TAIL_REWARD_TOL`` of 1 + the swarm's mean squared velocity, the
   slots around untouched.  Timed (10 launches queued, over 10; one call
   alone as ``call_ms``) beside the plain version and its byte bound, 56 B
   N + 4 B a swarm.  Phases 4, 5 and 21 check K8 once a step of each fused
   rollout (none in ``FlockingStochastic-v0``, whose step is its own); the
   kernel line's ``launches`` sums those.

Then one JSON line describing each kernel (its time, its plain version's,
and its bound: the larger of the operations it must do over the f32 peak
and the bytes it must move over the memory rate, counted from this run's
inputs), and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero before the last line; without a card it exits non-zero at once.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
SUM_TOL = 1e-4  # max |k - p| / (1 + |p|) on the summed channels
SPARSE_STEPS = 32  # bench metric 4's rollout length
# Phase 10's state.  The table's margin is thin: in 32-step rollouts from 48
# seeds of this state on an H100, 26 overflowed k_max=16 at the start or at
# a Verlet rebuild and then ran on dense K1 until the next rebuild.  This
# seed was chosen because it stays on K3 throughout (13 slots at most at the
# start, one rebuild); a change of summation order can move its rebuild
# over k_max, which is a property of the workload, not a fault.
SPARSE_SEED = 10
K5_CASES = ("ExploreFull B=512 R=100", "Coverage B=8192 R=6 G=8", "ragged B=3 R=33 T=300 G=2")
U_ATOL = 1e-4
STATE_ATOL = 1e-5  # a step's state against the host's
NETWORK_ATOL = 1e-6  # a mean-pooled network against the host's
REPS = 7
CR2 = 0.9 * 0.9  # the flocking envs' comm_radius2
# K2 and K4 against their plain versions: both sum in f64 and round to f32
# once, so they may differ by one f32 rounding, ~1.2e-7 |p|
ADJ_TOL = 1e-6
# a ring's f32 sum of partials against one whole-swarm pass, relative to
# 1 + the sum of the partials' magnitudes (K1 read 2.4e-7, K2 1.8e-7 on an H100)
RING_TOL = 1e-6
# NVIDIA H100 SXM data sheet, at the full 700 W: f32 outside the tensor
# cores, and HBM3
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# flops of K1's and K3's pair test (every pair) and of the body of a pair
# within reach (r2 < cr2 or r2 <= cr): the divide, the terms, the sums
PAIR_TEST_FLOPS = 5
PAIR_BODY_FLOPS = 30
EDGE_CASES = ("band", "all in reach", "none in reach", "coincident pair")
# K6's sums against the plain version's, relative to the summed magnitudes
# of their terms: the same f32 terms, summed in f32 by the plain version,
# in f32 chunks of at most 32 columns added in f64 by K6
DENSE_TOL = 1e-5
DENSE_QUEUED = 10  # K6 and K7 launches a queued timing queues back to back
# K8's reward against the plain version's, relative to 1 + the swarm's mean
# squared velocity (summed over both components), the benchmark's scale:
# torch.var sums the f32 velocities in f32 (Welford, PyTorch's order), K8
# their deviations from agent 0's in f64, so the two differ by the plain
# version's own rounding, a few f32 ulps of that scale
STEP_TAIL_REWARD_TOL = 1e-5


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn) -> float:
    """Median over REPS CUDA-event timings of ``fn()``, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def queued_ms(fn, reps=DENSE_QUEUED) -> float:
    """``time_ms`` of ``reps`` calls queued back to back, over ``reps``: the
    wrapper's host time (tens of microseconds) hides behind the card's work
    where that is longer."""
    return time_ms(lambda: [fn() for _ in range(reps)]) / reps


def sum_channels(channels: str):
    return list(range(8)) + ([10, 11] if channels != "core" else [])


def compare_sums(got, want, channels: str) -> dict:
    """Hold a K1 or K3 result against the plain one; raises on a breach and
    returns the measured errors."""
    import torch

    n_used = 9 if channels == "core" else 12
    if not (torch.isfinite(got[..., :9]).all() and torch.isfinite(want[..., :9]).all()):
        raise AssertionError("non-finite sums")
    if not torch.equal(got[..., 8], want[..., 8]):
        bad = int((got[..., 8] != want[..., 8]).sum())
        raise AssertionError(f"degree (channel 8) differs in {bad} rows")
    if not torch.equal(got[..., n_used:], torch.zeros_like(got[..., n_used:])):
        raise AssertionError("unused channels are not zero")
    if channels == "expert" and bool(got[..., 9].any()):
        raise AssertionError("channel 9 is not zero in the expert set")
    sums = sum_channels(channels)
    g, w = got[..., sums], want[..., sums]
    rel = float(((g - w).abs() / (1.0 + w.abs())).max())
    if not rel < SUM_TOL:
        raise AssertionError(f"sum channels: max |k-p|/(1+|p|) = {rel:.3e} >= {SUM_TOL}")
    ulp = 0
    if channels == "full":
        k9, p9 = got[..., 9], want[..., 9]
        if not (torch.isfinite(k9).all() and (k9 >= 0).all() and (p9 >= 0).all()):
            raise AssertionError("channel 9 not finite and non-negative")
        # non-negative floats order like their bit patterns
        ulp = int((k9.view(torch.int32) - p9.view(torch.int32)).abs().max())
        if ulp > 1:
            raise AssertionError(f"channel 9 (min r^2) differs by {ulp} ulp")
    abs_err = float((got[..., :n_used] - want[..., :n_used]).abs().max())
    return {"rel": rel, "ulp9": ulp, "abs": abs_err}


def compare_nan_sums(got, want) -> dict:
    """Hold a result with NaN sums (coincident agents) against the plain
    one: NaN in the same places, the degree exactly, the finite sums within
    SUM_TOL."""
    import torch

    if not bool(want.isnan().any()):
        raise AssertionError("the plain result has no NaN: the coincident pair was not in reach")
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError("NaN sums in other places than the plain version's")
    if not torch.equal(got[..., 8], want[..., 8]):
        raise AssertionError("degree (channel 8) differs")
    finite = ~want.isnan()
    g, w = got[finite], want[finite]
    rel = float(((g - w).abs() / (1.0 + w.abs())).max())
    if not rel < SUM_TOL:
        raise AssertionError(f"finite sums: max |k-p|/(1+|p|) = {rel:.3e} >= {SUM_TOL}")
    return {"rel": rel, "ulp9": 0, "abs": float((g - w).abs().max())}


def edge_swarms(name: str, cr: float, seed: int = SEED):
    """An edge case of K1's and K3's pair test at comm radius ``cr``:
    ``[2, N, 4]`` f32 numpy, N a multiple of 128, velocities standard
    normal.

    * "band": equilateral triangles 10 apart whose sides have r^2 strictly
      between cr and cr^2, so that every pair in reach has adj = 0 and
      gfac != 0 (cr < 1) or adj = 1 and gfac = 0 (cr > 1);
    * "all in reach": every agent within a disk of radius 0.1 (N=128);
    * "none in reach": a grid of spacing 3 jittered by up to 0.2 (r^2 > 6.7);
    * "coincident pair": "band" with agent 1 moved onto agent 0 (r^2 = 0,
      NaN sums in both swarms' rows 0-2).
    """
    import numpy as np

    rng = np.random.RandomState(seed)
    b, n = (2, 128) if name == "all in reach" else (2, 256)
    x = np.empty((b, n, 4), np.float32)
    x[..., 2:] = rng.standard_normal((b, n, 2))
    if name == "all in reach":
        r = 0.1 * np.sqrt(rng.uniform(0.0, 1.0, (b, n)))
        a = rng.uniform(0.0, 2 * np.pi, (b, n))
        x[..., 0], x[..., 1] = r * np.cos(a), r * np.sin(a)
        return x
    side = math.ceil(math.sqrt(n))
    grid = np.stack(np.divmod(np.arange(side * side), side), axis=-1)[:, ::-1].astype(np.float64)
    if name == "none in reach":
        x[..., :2] = 3.0 * grid[:n] + rng.uniform(-0.2, 0.2, (b, n, 2))
        return x
    lo, hi = sorted((cr, cr * cr))
    tri = n // 3
    s2 = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (b, tri))
    a = rng.uniform(0.0, 2 * np.pi, (b, tri))[..., None] + np.arange(3) * (2 * np.pi / 3)
    corner = np.sqrt(s2 / 3.0)[..., None, None] * np.stack((np.cos(a), np.sin(a)), axis=-1)
    x[:, :3 * tri, :2] = (10.0 * grid[:tri, None] + corner).reshape(b, 3 * tri, 2)
    x[:, 3 * tri:, :2] = 10.0 * grid[tri:tri + n - 3 * tri]  # single agents
    if name == "coincident pair":
        x[:, 1, :2] = x[:, 0, :2]
    return x


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    """Bytes of distinct tensors, each counted once."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def k1_pair_counts(xr, xc, ro: int, co: int, cr, cr2) -> tuple:
    """``(pairs, pairs within reach)`` of K1 on these operands: the pairs of
    distinct global ids, and those with r2 < cr2 or not r2 > cr."""
    import torch

    b, m, _ = xr.shape
    k = xc.shape[1]
    col_ids = co + torch.arange(k, device=xr.device)
    rows = max(1, (1 << 25) // max(1, b * k))
    pairs = hits = 0
    for r0 in range(0, m, rows):
        xs = xr[:, r0:r0 + rows]
        dx = xs[..., 0, None] - xc[:, None, :, 0]
        dy = xs[..., 1, None] - xc[:, None, :, 1]
        r2 = dx * dx + dy * dy
        other = (ro + r0 + torch.arange(xs.shape[1], device=xr.device))[:, None] != col_ids
        pairs += b * int(other.sum())
        hits += int((((r2 < cr2) | ~(r2 > cr)) & other).sum())
    return pairs, hits


def k3_pair_counts(xs, table, cr, cr2) -> tuple:
    """``(listed pairs, listed pairs within reach)`` of K3 on these sorted
    operands, the self pairs excluded."""
    import torch

    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    b, n, _ = xs.shape
    blk = sf.BLOCK
    pos = xs[..., :2].reshape(b, n // blk, blk, 2)
    bidx = torch.arange(b, device=xs.device)[:, None]
    rows = torch.arange(n // blk, device=xs.device)
    eye = torch.eye(blk, dtype=torch.bool, device=xs.device)
    pairs = hits = 0
    for s in range(table.shape[-1]):
        j = table[..., s].long()
        valid = (j >= 0)[..., None, None]
        pc = pos[bidx, j.clamp(min=0)]
        dx = pos[..., 0, None] - pc[..., None, :, 0]
        dy = pos[..., 1, None] - pc[..., None, :, 1]
        r2 = dx * dx + dy * dy
        keep = valid & ~((j == rows)[..., None, None] & eye)
        pairs += int(keep.sum())
        hits += int((((r2 < cr2) | ~(r2 > cr)) & keep).sum())
    return pairs, hits


def warps_per_sm(blocks: int, threads: int) -> float:
    """Warps a launch puts on each SM of the card, on average."""
    import torch

    return blocks * threads / 32 / torch.cuda.get_device_properties(0).multi_processor_count


def pair_bound(pairs: int, hits: int, nbytes_moved: int) -> dict:
    """K1's and K3's bound: the test on every pair, the body on those
    within reach."""
    return {"pairs": pairs, "pairs_in_reach": hits,
            **bound(PAIR_TEST_FLOPS * pairs + PAIR_BODY_FLOPS * hits, nbytes_moved)}


def draw_swarms(n_envs: int, n_agents: int, device: str, seed: int):
    """Swarms drawn as the reset draws them (positions over the disk of
    radius sqrt(sqrt(N)), velocities up to +-10)."""
    import torch

    from gym_flock_tpu_torch.envs.flocking import FlockingParams, FlockingRelativeEnv

    gen = torch.Generator(device=device).manual_seed(seed)
    return FlockingRelativeEnv()._draw(gen, FlockingParams(n_agents=n_agents), n_envs)


def phase_kernel_check(device: str, shapes, timed) -> dict:
    """Phase 3: K1 against the plain version for each case; returns the
    worst errors and the timings at the ``(B, N, channels)`` of ``timed``."""
    import torch

    from gym_flock_tpu_torch.ops import flocking_sums as k1

    cr = 0.9
    cr2 = cr * cr
    worst = {"rel": 0.0, "ulp9": 0, "abs": 0.0}
    cases = []
    for b, n in shapes:
        x = draw_swarms(b, n, device, SEED + n)
        cases.append((f"B={b},N={n}", x, x, 0, 0, cr))
    # cross block: rows are agents 0..699, columns 300..999 of the same swarm,
    # so ids 300..699 appear on both sides and their self pairs must drop
    x = draw_swarms(3, 1000, device, SEED + 1)
    cases.append(("cross B=3,rows 0-699,cols 300-999",
                  x[:, :700].contiguous(), x[:, 300:].contiguous(), 0, 300, cr))
    # ragged cross block: 37 rows against 260 columns, ids 5..36 on both sides
    cases.append(("cross B=3,rows 0-36,cols 5-264",
                  x[:, :37].contiguous(), x[:, 5:265].contiguous(), 0, 5, cr))
    for radius in (0.9, 2.0):
        for name in EDGE_CASES:
            xe = torch.from_numpy(edge_swarms(name, radius)).to(device)
            cases.append((f"{name} cr={radius}", xe, xe, 0, 0, radius))
    for name, xr, xc, ro, co, radius in cases:
        for channels in ("core", "full"):
            got = k1.flocking_sums_block(xr, xc, ro, co, radius, radius * radius,
                                         channels=channels)
            want = k1.flocking_sums_block_reference(xr, xc, ro, co, radius, radius * radius,
                                                    channels)
            _sync()
            if name.startswith("coincident"):
                err = compare_nan_sums(got, want)
            else:
                err = compare_sums(got, want, channels)
            worst = {k: max(worst[k], err[k]) for k in worst}
    timings = [k1_timing(draw_swarms(b, n, device, SEED + n), cr, cr2, channels, plain=True)
               for b, n, channels in timed]
    return {"worst": worst, "cases": len(cases) * 2, "timings": timings}


def k1_timing(x, cr, cr2, channels: str, plain: bool) -> dict:
    """K1's time over every pair of the swarms ``x`` (and its plain
    version's where ``plain``), its launch geometry and its bound."""
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    b, n, _ = x.shape
    res = {"B": b, "N": n, "channels": channels,
           "ms": time_ms(lambda: k1.flocking_sums_block(x, x, 0, 0, cr, cr2, channels=channels))}
    if plain:
        res["plain_ms"] = time_ms(
            lambda: k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr2, channels))
    blocks, threads, groups = k1.launch_grid(b, n, n)
    pairs, hits = k1_pair_counts(x, x, 0, 0, cr, cr2)
    res.update(gpairs_per_s=b * n * n / (res["ms"] * 1e6), blocks=blocks, threads=threads,
               groups=groups, warps_per_sm=warps_per_sm(blocks, threads),
               **pair_bound(pairs, hits, nbytes(x) + b * n * 16 * 4), library_ms=None)
    return res


def k1_reset_check(x, cr, cr2) -> dict:
    """K1's "full" channels on a reset's batch ``x`` against the plain
    version: the degree and min r^2 (channels 8 and 9, which the acceptance
    test reads) exactly, the sums as phase 3 holds them."""
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    got = k1.flocking_sums_block(x, x, 0, 0, cr, cr2, channels="full")
    want = k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr2, "full")
    err = compare_sums(got, want, "full")
    hold("min r^2 (channel 9)", got[..., 9], want[..., 9], 0, "exact")
    return err


def phase_large(device: str, n_envs: int, n_steps: int, **overrides) -> dict:
    """Phase 4: FlockingLarge-v0's expert rollout through K1."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.flocking import _integrate
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import step_tail as k8
    from gym_flock_tpu_torch.parallel.rollout import batch_expert_rollout

    env, params = gft.make("FlockingLarge-v0", **overrides)
    gen = torch.Generator(device=device).manual_seed(SEED)
    gen_state = gen.get_state()
    _sync()
    k1.launches = k8.launches = 0
    t0 = time.perf_counter()
    final, traj = batch_expert_rollout(env, params, gen, n_envs, n_steps)
    _sync()
    seconds = time.perf_counter() - t0
    launches = k1.launches
    tries = env.last_reset_tries
    expected = tries + 1 + 1 + n_steps
    if launches != expected:
        raise AssertionError(
            f"K1 launches {launches} != {tries} reset draws + 1 + 1 + {n_steps} steps")
    k8_launches = k8.launches
    if k8_launches != n_steps:
        raise AssertionError(f"K8 launches {k8_launches}, not one a step ({n_steps})")
    for key in ("u", "reward", "values", "network"):
        if not torch.isfinite(traj[key]).all():
            raise AssertionError(f"non-finite {key} in the FlockingLarge rollout")

    # the same start state again (same generator state: same draws), then
    # the first step on the plain functions
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    state0, _ = env.reset_env(replay, params, n_envs)
    x0 = state0.x
    s0 = k1.flocking_sums_block_reference(x0, x0, 0, 0, params.comm_radius,
                                          params.comm_radius2, "core")
    u_plain = env._expert_action(*k1.expert_channels(s0, x0, params.centralized), params)
    u_err = float((traj["u"][:, 0] - u_plain).abs().max())
    if not u_err <= U_ATOL:
        raise AssertionError(f"first-step u differs from plain by {u_err:.3e}")
    x1 = _integrate(x0, traj["u"][:, 0] * params.action_scalar, params.dt)
    s1 = k1.flocking_sums_block_reference(x1, x1, 0, 0, params.comm_radius,
                                          params.comm_radius2, "core")
    if not torch.equal(traj["network"][:, 0], s1[..., 8]):
        raise AssertionError("first-step degree differs from plain")
    v_rel = float(((traj["values"][:, 0] - s1[..., 0:6]).abs()
                   / (1.0 + s1[..., 0:6].abs())).max())
    if not v_rel < SUM_TOL:
        raise AssertionError(f"first-step values differ from plain: {v_rel:.3e}")

    # the rollout alone, without the reset's draws
    _sync()
    t1 = time.perf_counter()
    env.expert_rollout(final, params, n_steps)
    _sync()
    roll_s = time.perf_counter() - t1
    view = check_strided_state(env, params, final.x)
    n = params.n_agents
    return {
        "launches": launches, "k8_launches": k8_launches, "reset_tries": tries, "u_err": u_err,
        "values_rel": v_rel, "strided_state": view,
        "seconds": seconds, "rollout_seconds": roll_s,
        "env_steps_per_s": n_envs * n_steps / seconds,
        "agent_steps_per_s": n_envs * n_steps * n / seconds,
        "rollout_env_steps_per_s": n_envs * n_steps / roll_s,
        "rollout_agent_steps_per_s": n_envs * n_steps * n / roll_s,
        "mean_reward": float(traj["reward"].mean()),
    }


def check_strided_state(env, params, x) -> dict:
    """Two fused steps from ``init_state`` of ``wide[..., 1:]`` of a ``[B,
    N, 5]`` tensor (strided, and 4 bytes into its storage): K1 runs on a
    copy, and the rollout equals the one from a contiguous copy of ``x``."""
    import torch

    from gym_flock_tpu_torch.ops import flocking_sums as k1

    wide = torch.zeros(x.shape[:-1] + (5,), dtype=x.dtype, device=x.device)
    wide[..., 1:] = x
    view = wide[..., 1:]
    if view.is_contiguous() or view.data_ptr() % 16 == 0:
        raise AssertionError("the view is contiguous or 16-byte aligned")
    before = k1.launches
    got_final, got = env.expert_rollout(env.init_state(view, params), params, 2)
    _sync()
    launches = k1.launches - before
    if launches != 3:
        raise AssertionError(f"{launches} K1 launches for 2 fused steps from the view, want 3")
    want_final, want = env.expert_rollout(env.init_state(x.clone(), params), params, 2)
    _sync()
    if not (torch.equal(got_final.x, want_final.x)
            and all(torch.equal(got[k], want[k]) for k in want)):
        raise AssertionError("the rollout from the strided view differs from the copy's")
    return {"k1_launches": launches, "equal_to_copy": True}


def phase_relative(device: str, n_envs: int, n_steps: int, **overrides) -> dict:
    """Phase 5: FlockingRelative-v0's expert rollout (K1 in the reset, K6
    in every fused pass)."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.ops import dense_flocking as k6
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import step_tail as k8
    from gym_flock_tpu_torch.parallel.rollout import batch_expert_rollout

    env, params = gft.make("FlockingRelative-v0", **overrides)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    k1.launches = k6.launches = k8.launches = 0
    t0 = time.perf_counter()
    final, traj = batch_expert_rollout(env, params, gen, n_envs, n_steps)
    _sync()
    seconds = time.perf_counter() - t0
    launches = k1.launches
    tries = env.last_reset_tries
    if launches != tries or launches == 0:
        raise AssertionError(f"K1 launches {launches}, reset draws {tries}")
    if k6.launches != n_steps + 1:
        raise AssertionError(f"K6 launches {k6.launches}, not {n_steps + 1}")
    if k8.launches != n_steps:
        raise AssertionError(f"K8 launches {k8.launches}, not one a step ({n_steps})")
    n = params.n_agents
    shapes = {"u": (n_envs, n_steps, n, 2), "values": (n_envs, n_steps, n, 6),
              "network": (n_envs, n_steps, n, n), "reward": (n_envs, n_steps)}
    for key, shape in shapes.items():
        if tuple(traj[key].shape) != shape:
            raise AssertionError(f"{key} has shape {tuple(traj[key].shape)}, not {shape}")
        if not torch.isfinite(traj[key]).all():
            raise AssertionError(f"non-finite {key} in the FlockingRelative rollout")
    del traj
    _sync()
    t1 = time.perf_counter()
    env.expert_rollout(final, params, n_steps)
    _sync()
    roll_s = time.perf_counter() - t1
    if k6.launches != 2 * (n_steps + 1) or k8.launches != 2 * n_steps:
        raise AssertionError(f"K6 launches {k6.launches}, not {2 * (n_steps + 1)}; K8 "
                             f"{k8.launches}, not {2 * n_steps}")
    return {
        "launches": launches, "reset_tries": tries, "k6_launches": k6.launches,
        "k8_launches": k8.launches,
        "seconds": seconds, "rollout_seconds": roll_s,
        "env_steps_per_s": n_envs * n_steps / seconds,
        "rollout_env_steps_per_s": n_envs * n_steps / roll_s,
    }


def dense_pass_scales(x, cr, cr2, centralized: bool, obstacle_mask=None):
    """``[B, N, 10]``: for each of K6's six values and four expert sums, the
    summed magnitudes of its terms, from the plain version's f32 terms (the
    closed form's: N |v_i| + sum_j |v_j|; under an obstacle mask, the
    masked row sums')."""
    import torch

    from gym_flock_tpu_torch.ops import dense_flocking as k6

    dx, dy, dvx, dvy, r2 = k6.pairwise_channels(x, obstacle_mask)
    adj = (r2 < cr2).to(x.dtype)
    inv = 1.0 / r2
    inv2 = inv * inv
    terms = [dvx * adj, dx * inv2 * adj, dx * inv * adj, dvy * adj, dy * inv2 * adj,
             dy * inv * adj]
    grads = [k6.turner_potential_grad(d, r2, cr) for d in (dx, dy)]
    if not centralized:
        grads = [g * adj for g in grads]
    scales = [t.double().abs().sum(dim=-1) for t in terms + grads]
    if centralized and obstacle_mask is not None:
        scales += [dvx.double().abs().sum(dim=-1), dvy.double().abs().sum(dim=-1)]
    elif centralized:
        n = x.shape[1]
        for c in (2, 3):
            v = x[..., c].double().abs()
            scales.append(n * v + v.sum(dim=-1, keepdim=True))
    else:
        scales += [scales[0], scales[3]]
    return torch.stack(scales, dim=-1)


def hold_dense_pass(what: str, got, want, scales) -> float:
    """K6's ``(values, network, *sums)`` against the plain version's: the
    network bit for bit (where given), NaN in the same places, each sum
    within DENSE_TOL of its scale; returns the largest error over its
    scale.  ``scales`` lacks the six values' where ``want`` has none."""
    import torch

    if want[1] is not None and not torch.equal(got[1], want[1]):
        raise AssertionError(f"{what}: the network differs from the plain version's")
    g = torch.stack(got[2:], dim=-1)
    w = torch.stack(want[2:], dim=-1)
    if want[0] is not None:
        g, w = torch.cat((got[0], g), dim=-1), torch.cat((want[0], w), dim=-1)
    nan = torch.isnan(w)
    if not torch.equal(torch.isnan(g), nan):
        raise AssertionError(f"{what}: NaN sums in other places than the plain version's")
    err = (g.double() - w.double()).abs()[~nan]
    scale = scales[~nan]
    if not bool((err <= DENSE_TOL * scale).all()):
        raise AssertionError(f"{what}: a sum off by more than {DENSE_TOL} of its scale")
    return float((err / scale.clamp_min(1e-300)).max()) if err.numel() else 0.0


def phase_dense_pass(device: str, shapes) -> dict:
    """Phase 37: K6 against its plain version at each ``(B, N)`` of
    ``shapes`` (reset draws), centralized and not, without and with an
    obstacle mask, into a trajectory's slots and as sums alone; timed in
    the rollout's mode beside its bound and the plain version."""
    import torch

    from gym_flock_tpu_torch.ops import dense_flocking as k6

    cr, cr2 = 0.9, 0.9 * 0.9
    out = {"worst": 0.0, "timings": []}

    for b, n in shapes:
        x = draw_swarms(b, n, device, SEED + b)
        values = torch.empty(b, 2, n, 6, device=device)
        network = torch.empty(b, 2, n, n, device=device)
        slots = (values[:, 1], network[:, 1])
        obstacles = torch.arange(n, device=device) < 4
        for centralized, mask in itertools.product((True, False), (None, obstacles)):
            before = k6.launches
            got = k6.dense_pass(x, cr, cr2, centralized, True, mask, out=slots)
            sums = k6.dense_pass(x, cr, cr2, centralized, True, mask, out=(None, None))
            _sync()
            if k6.launches != before + 2 or got[0] is not slots[0] or got[1] is not slots[1]:
                raise AssertionError(f"K6 at B={b} N={n}: not two launches into the slots")
            want = k6.dense_pass_reference(x, cr, cr2, centralized, True, mask)
            scales = dense_pass_scales(x, cr, cr2, centralized, mask)
            what = f"K6 B={b} N={n} centralized={centralized} obstacles={mask is not None}"
            out["worst"] = max(out["worst"], hold_dense_pass(what, got, want, scales))
            for g, w in zip(sums[2:], got[2:]):
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: the sums alone differ from the full pass's")
            del want, scales
        pairs, hits = k1_pair_counts(x, x, 0, 0, cr, cr2)
        moved = b * n * (4 + 6 + n + 4) * 4  # x read; values, network, sums written
        timing = {"B": b, "N": n, "launch_blocks": b,
                  "ms": queued_ms(lambda: k6.dense_pass(x, cr, cr2, True, True, out=slots)),
                  "sums_only_ms": queued_ms(
                      lambda: k6.dense_pass(x, cr, cr2, True, True, out=(None, None))),
                  "call_ms": time_ms(lambda: k6.dense_pass(x, cr, cr2, True, True, out=slots)),
                  "plain_ms": time_ms(
                      lambda: k6.dense_pass_reference(x, cr, cr2, True, True, out=slots)),
                  **pair_bound(pairs, hits, moved)}
        timing["share"] = timing["bound_ms"] / timing["ms"]
        out["timings"].append(timing)
        del values, network, slots
    return out


STEP_TAIL_SOURCES = ("k6", "k1", "k1_decentralized")


def step_tail_sums(x, source: str, cr: float = 0.9):
    """The Turner expert's four sums at ``x`` as a main path hands them to
    K8: ``"k6"``, K6's ``[B,N,4]`` unbound (element stride 4); ``"k1"``,
    K1's channels 6/7 (stride 16) and the closed form's contiguous velocity
    sums; ``"k1_decentralized"``, K1's channels 10/11/0/3 (stride 16)."""
    from gym_flock_tpu_torch.ops import dense_flocking as k6
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    if source == "k6":
        return k6.dense_pass(x, cr, cr * cr, True, True, out=(None, None))[2:]
    central = source == "k1"
    s = k1.flocking_sums_block(x, x, 0, 0, cr, cr * cr, "core" if central else "full")
    return k1.expert_channels(s, x, central)


def hold_step_tail(what: str, got, want) -> float:
    """K8's ``(x_next, u, reward)`` against the plain version's: x_next and
    u bit for bit (NaN in the same places), the reward within
    STEP_TAIL_REWARD_TOL of 1 + the swarm's mean squared velocity; returns
    the reward's largest error over that scale."""
    import torch

    for name, g, w in zip(("x_next", "u"), got[:2], want[:2]):
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"{what}: NaN {name} in other places than the plain version's")
        if not torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)):
            raise AssertionError(f"{what}: {name} differs from the plain version's bits")
    v = want[0][..., 2:4].double()
    scale = 1.0 + (v * v).mean(dim=-2).sum(dim=-1)
    nan = torch.isnan(want[2])
    if not torch.equal(torch.isnan(got[2]), nan):
        raise AssertionError(f"{what}: NaN rewards in other places than the plain version's")
    err = ((got[2].double() - want[2].double()).abs() / scale)[~nan]
    if not bool((err <= STEP_TAIL_REWARD_TOL).all()):
        raise AssertionError(f"{what}: a reward off by {float(err.max()):.3e} of its scale")
    return float(err.max()) if err.numel() else 0.0


def run_step_tail(fn, x, sums, mask, action_scale: float, slots: int = 3, slot: int = 1):
    """``fn`` (``step_tail`` or its plain version) at ``x`` with the flocking
    envs' action scalar and dt, writing into step ``slot`` of fresh ``u``
    and ``reward`` trajectories filled with 7; returns ``(x_next, u, reward,
    u_traj, reward_traj)``."""
    import torch

    b, n, _ = x.shape
    u_traj = torch.full((b, slots, n, 2), 7.0, device=x.device)
    reward_traj = torch.full((b, slots), 7.0, device=x.device)
    x_next = fn(x, *sums, 10.0, action_scale, 0.01, mask, u_traj[:, slot],
                reward_traj[:, slot])
    return x_next, u_traj[:, slot], reward_traj[:, slot], u_traj, reward_traj


def phase_step_tail(device: str, cases) -> dict:
    """Phase 38: K8 against its plain version at each ``(B, N, source)`` of
    ``cases`` (reset draws; every source the shape allows, each without and
    with an integration mask and the masked envs' scale 1), into a
    trajectory's slots; timed at each case's own source without a mask
    beside its byte bound and the plain version."""
    import torch

    from gym_flock_tpu_torch.ops import dense_flocking as k6
    from gym_flock_tpu_torch.ops import step_tail as k8

    out = {"worst_reward": 0.0, "checks": 0, "timings": []}
    for b, n, timed_source in cases:
        x = draw_swarms(b, n, device, SEED + b + n)
        mask = (torch.arange(n, device=device) >= 4).to(x.dtype)
        for source in STEP_TAIL_SOURCES:
            if source == "k6" and n > k6.MAX_AGENTS:
                continue
            sums = step_tail_sums(x, source)
            for m, scale in ((None, 10.0), (mask, 1.0)):
                before = k8.launches
                got = run_step_tail(k8.step_tail, x, sums, m, scale)
                _sync()
                if k8.launches != before + 1:
                    raise AssertionError(f"K8 at B={b} N={n}: not one launch")
                want = run_step_tail(k8.step_tail_reference, x, sums, m, scale)
                what = f"K8 B={b} N={n} sums={source} mask={m is not None}"
                out["worst_reward"] = max(out["worst_reward"],
                                          hold_step_tail(what, got[:3], want[:3]))
                for t in (got[3][:, 0::2], got[4][:, 0::2]):
                    if not bool((t == 7.0).all()):
                        raise AssertionError(f"{what}: wrote outside its slot")
                out["checks"] += 1
                del got, want
            del sums
        sums = step_tail_sums(x, timed_source)
        u_traj = torch.empty(b, 2, n, 2, device=device)
        reward_traj = torch.empty(b, 2, device=device)

        def tail(fn):
            return fn(x, *sums, 10.0, 10.0, 0.01, None, u_traj[:, 1], reward_traj[:, 1])

        moved = 56 * b * n + 4 * b  # x, sums read; x', u, reward written
        timing = {"B": b, "N": n, "sums": timed_source,
                  "ms": queued_ms(lambda: tail(k8.step_tail)),
                  "call_ms": time_ms(lambda: tail(k8.step_tail)),
                  "plain_ms": time_ms(lambda: tail(k8.step_tail_reference)),
                  "bytes": moved, **bound(0, moved)}
        timing["share"] = timing["bound_ms"] / timing["ms"]
        out["timings"].append(timing)
        del x, sums, u_traj, reward_traj
    return out


def bench_state(n_envs: int, n_agents: int, seed: int, device: str):
    """Bench metric 4's state (``bench.py:bench_sparse_flocking``): positions
    uniform over a square of side sqrt(N), about 1 agent per unit^2, and
    standard normal velocities, drawn with numpy."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = np.empty((n_envs, n_agents, 4), np.float32)
    x[..., :2] = rng.uniform(0.0, math.sqrt(n_agents), (n_envs, n_agents, 2))
    x[..., 2:] = rng.standard_normal((n_envs, n_agents, 2))
    return torch.from_numpy(x).to(device)


def phase_sparse_kernel_check(device: str, shapes) -> dict:
    """Phase 9: K3 against its plain version at the two ``(B, N)`` of
    ``shapes`` and a ragged case; returns errors and timings."""
    import torch

    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    cr = 0.9
    cr2 = cr * cr
    cases, states = [], []
    for b, n in shapes:
        x = bench_state(b, n, SEED + b, device)
        vs = sf.verlet_build(x, cr, cr)
        if bool(vs.overflow.any()):
            raise AssertionError(f"the B={b}, N={n} table overflows k_max")
        cases.append((f"B={b},N={n}", sf.permute(x, vs.perm), vs.table, cr))
        states.append(x)
    x = bench_state(3, 1024, SEED + 3, device)
    xs = sf.permute(x, sf.hilbert_order(x, cr))
    table, _ = sf.block_pair_table(xs, cr, 16)
    ragged = torch.cat([table.flip(-1), torch.full_like(table[..., :3], -1)], dim=-1)
    cases.append(("ragged B=3,N=1024", xs, ragged.contiguous(), cr))
    for radius in (0.9, 2.0):
        for name in EDGE_CASES:
            x = torch.from_numpy(edge_swarms(name, radius)).to(device)
            xs = sf.permute(x, sf.hilbert_order(x, radius))
            cases.append((f"{name} cr={radius}", xs, sf.block_pair_table(xs, radius, 16)[0],
                          radius))
    worst = {"rel": 0.0, "ulp9": 0, "abs": 0.0}
    for name, xs, table, radius in cases:
        for channels in ("core", "expert", "full"):
            got = sf.sparse_sums_sorted(xs, table, radius, radius * radius, channels)
            want = sf.sparse_sums_sorted_reference(xs, table, radius, radius * radius, channels)
            _sync()
            if name.startswith("coincident"):
                err = compare_nan_sums(got, want)
            else:
                err = compare_sums(got, want, channels)
            worst = {k: max(worst[k], err[k]) for k in worst}

    # exact pruning: the degree through the whole pipeline equals dense K1's
    x_b = states[1]
    overflows = sf.overflow_passes
    deg_sparse = sf.flocking_sums_sparse(x_b, cr, cr2)[..., 8]
    deg_dense = k1.flocking_sums(x_b, cr, cr2)[..., 8]
    _sync()
    if sf.overflow_passes != overflows:
        raise AssertionError("the pruning check took the dense branch")
    if not torch.equal(deg_sparse, deg_dense):
        bad = int((deg_sparse != deg_dense).sum())
        raise AssertionError(f"sparse degree differs from dense K1's in {bad} agents")

    # K1 at (a)'s shape: the overflow branch of phase 10's workload
    x_a = states[0]
    k1_a = compare_sums(k1.flocking_sums(x_a, cr, cr2),
                        k1.flocking_sums_block_reference(x_a, x_a, 0, 0, cr, cr2, "core"),
                        "core")
    _sync()

    timings = []
    for (name, xs, table, _), x in zip(cases[:2], states):
        b, n, _ = xs.shape
        pairs = int((table >= 0).sum()) * sf.BLOCK * sf.BLOCK
        res = {"case": name, "B": b, "N": n, "channels": "core",
               "listed_slots_per_row_block": float((table >= 0).sum(-1).float().mean()),
               "max_slots": int((table >= 0).sum(-1).max()), "listed_pairs": pairs}
        res["ms"] = time_ms(lambda: sf.sparse_sums_sorted(xs, table, cr, cr2, "core"))
        res["plain_ms"] = time_ms(
            lambda: sf.sparse_sums_sorted_reference(xs, table, cr, cr2, "core"))
        res["gpairs_per_s"] = pairs / (res["ms"] * 1e6)
        blocks, threads, groups = sf.launch_grid(b, n, table.shape[-1])
        res.update(blocks=blocks, threads=threads, groups=groups,
                   warps_per_sm=warps_per_sm(blocks, threads))
        res.update(pair_bound(*k3_pair_counts(xs, table, cr, cr2),
                              nbytes(xs, table) + b * n * 16 * 4))
        res["library_ms"] = None
        if b == 1:  # the overflow branch's pass at this shape
            res["dense_k1"] = k1_timing(x, cr, cr2, "core", plain=False)
        timings.append(res)
    return {"worst": worst, "cases": len(cases) * 3, "k1_dense_a": k1_a, "timings": timings}


def plain_pass_sums(x, cr, cr2, skin):
    """The "core" pass at ``x`` on the plain versions, as the sparse pipeline
    decides it: the Verlet table at ``x``, then K3's plain version, or K1's
    over every pair where the table overflows.  Returns ``(sums, dense)``."""
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    vs = sf.verlet_build(x, cr, skin)
    if bool(vs.overflow.any()):
        return k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr2, "core"), True
    xs = sf.permute(x, vs.perm)
    return sf.unsort(sf.sparse_sums_sorted_reference(xs, vs.table, cr, cr2, "core"),
                     vs.perm), False


def check_sparse_first_step(env, params, x0, traj) -> dict:
    """The first step's action and observation of a sparse rollout from
    ``x0`` against the plain pipeline on the same states."""
    import torch

    from gym_flock_tpu_torch.envs.flocking import _integrate
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    cr, cr2, skin = params.comm_radius, params.comm_radius2, env._verlet_skin(params)
    s0, dense0 = plain_pass_sums(x0, cr, cr2, skin)
    u_plain = env._expert_action(*k1.expert_channels(s0, x0, params.centralized), params)
    u_err = float((traj["u"][:, 0] - u_plain).abs().max())
    if not u_err <= U_ATOL:
        raise AssertionError(f"first-step u differs from plain by {u_err:.3e}")
    x1 = _integrate(x0, traj["u"][:, 0] * params.action_scalar, params.dt)
    s1, dense1 = plain_pass_sums(x1, cr, cr2, skin)
    if not torch.equal(traj["network"][:, 0], s1[..., 8]):
        raise AssertionError("first-step degree differs from plain")
    v_rel = float(((traj["values"][:, 0] - s1[..., 0:6]).abs()
                   / (1.0 + s1[..., 0:6].abs())).max())
    if not v_rel < SUM_TOL:
        raise AssertionError(f"first-step values differ from plain: {v_rel:.3e}")
    return {"u_err": u_err, "values_rel": v_rel, "plain_dense_passes": int(dense0) + int(dense1)}


def phase_sparse_main(device: str, n_agents: int, n_steps: int) -> dict:
    """Phase 10: FlockingSparse-v0's expert rollout from bench metric 4's
    state, every pass on K3."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf
    from gym_flock_tpu_torch.parallel.rollout import batch_expert_rollout

    env, params = gft.make("FlockingSparse-v0", n_agents=n_agents)
    cr = params.comm_radius
    x0 = bench_state(1, n_agents, SPARSE_SEED, device)
    skin = env._verlet_skin(params)
    if bool(sf.verlet_build(x0, cr, skin).overflow.any()):
        raise AssertionError(f"the start state's Verlet table overflows k_max (numpy seed "
                             f"{SPARSE_SEED}: a property of the seed, see SPARSE_SEED)")
    state = env.init_state(x0, params)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    k1.launches = sf.launches = sf.verlet_rebuilds = sf.overflow_passes = 0
    t0 = time.perf_counter()
    final, traj = batch_expert_rollout(env, params, gen, 1, n_steps, init_state=state)
    _sync()
    seconds = time.perf_counter() - t0
    k3_launches, k1_launches, rebuilds = sf.launches, k1.launches, sf.verlet_rebuilds
    overflowed = sf.overflow_passes
    if k3_launches != n_steps + 1 or k1_launches != 0:
        raise AssertionError(
            f"K3 launches {k3_launches} (want {n_steps + 1}), K1 launches {k1_launches} "
            f"(want 0), {overflowed} overflowing passes, {rebuilds} rebuilds: with numpy "
            f"seed {SPARSE_SEED} the tables stay within k_max; overflowing passes mean a "
            f"rebuild of this seed's workload crossed it (see SPARSE_SEED)")
    shapes = {"u": (1, n_steps, n_agents, 2), "values": (1, n_steps, n_agents, 6),
              "network": (1, n_steps, n_agents), "reward": (1, n_steps)}
    for key, shape in shapes.items():
        if tuple(traj[key].shape) != shape or not torch.isfinite(traj[key]).all():
            raise AssertionError(f"{key}: shape {tuple(traj[key].shape)} or not finite")
    first = check_sparse_first_step(env, params, x0, traj)

    # the same rollout again, warm (the first call pays one-time CUDA set-up),
    # and the time of one table build, to state the rate without the builds
    _sync()
    t1 = time.perf_counter()
    env.expert_rollout(state, params, n_steps)
    _sync()
    warm_s = time.perf_counter() - t1
    build_ms = time_ms(lambda: sf.verlet_build(x0, cr, skin))
    build_s = (1 + rebuilds) * build_ms / 1e3
    return {
        "k3_launches": k3_launches, "k1_launches": k1_launches, "overflowing_passes": overflowed,
        "verlet_rebuilds": rebuilds, **first, "seconds": seconds, "warm_seconds": warm_s,
        "table_build_ms": build_ms,
        "agent_steps_per_s": n_agents * n_steps / seconds,
        "warm_agent_steps_per_s": n_agents * n_steps / warm_s,
        "warm_agent_steps_per_s_without_table_builds": n_agents * n_steps / (warm_s - build_s),
        "mean_reward": float(traj["reward"].mean()),
    }


def phase_sparse_reset(device: str, n_envs: int, n_steps: int, **overrides) -> dict:
    """Phase 11: FlockingSparse-v0 from its registered reset; each pass
    runs on K3 or, where the table overflows, on K1."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf
    from gym_flock_tpu_torch.parallel.rollout import batch_expert_rollout

    env, params = gft.make("FlockingSparse-v0", **overrides)
    cr, cr2 = params.comm_radius, params.comm_radius2
    gen = torch.Generator(device=device).manual_seed(SEED)
    gen_state = gen.get_state()
    _sync()
    k1.launches = sf.launches = sf.verlet_rebuilds = sf.overflow_passes = 0
    t0 = time.perf_counter()
    final, traj = batch_expert_rollout(env, params, gen, n_envs, n_steps)
    _sync()
    seconds = time.perf_counter() - t0
    tries = env.last_reset_tries
    k3_launches, k1_launches = sf.launches, k1.launches
    overflowed, rebuilds = sf.overflow_passes, sf.verlet_rebuilds
    # the reset's acceptance tests, its observation, the first pass, the steps
    passes = tries + 1 + 1 + n_steps
    if k3_launches + k1_launches != passes or k1_launches != overflowed:
        raise AssertionError(
            f"K3 {k3_launches} + K1 {k1_launches} launches for {passes} passes, "
            f"{overflowed} of them overflowing")
    for key in ("u", "reward", "values", "network"):
        if not torch.isfinite(traj[key]).all():
            raise AssertionError(f"non-finite {key} in the FlockingSparse reset rollout")

    # the same start state again (same draws), then K1 in both channel sets
    # against its plain version on it, and the first step against the plain
    # pipeline
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    x0 = env.reset_env(replay, params, n_envs)[0].x
    k1_core = compare_sums(k1.flocking_sums(x0, cr, cr2),
                           k1.flocking_sums_block_reference(x0, x0, 0, 0, cr, cr2, "core"),
                           "core")
    k1_full = compare_sums(k1.flocking_sums_block(x0, x0, 0, 0, cr, cr2, channels="full"),
                           k1.flocking_sums_block_reference(x0, x0, 0, 0, cr, cr2, "full"),
                           "full")
    first = check_sparse_first_step(env, params, x0, traj)
    _sync()
    t1 = time.perf_counter()
    env.expert_rollout(final, params, n_steps)
    _sync()
    roll_s = time.perf_counter() - t1
    n = params.n_agents
    return {
        "k3_launches": k3_launches, "k1_launches": k1_launches, "overflowing_passes": overflowed,
        "passes": passes, "reset_tries": tries, "verlet_rebuilds": rebuilds,
        "k1_core_vs_plain": k1_core, "k1_full_vs_plain": k1_full, **first,
        # the acceptance test's overflow pass at this shape
        "k1_full_timing": k1_timing(x0, cr, cr2, "full", plain=False),
        "seconds": seconds, "rollout_seconds": roll_s,
        "agent_steps_per_s": n_envs * n_steps * n / seconds,
        "rollout_agent_steps_per_s": n_envs * n_steps * n / roll_s,
    }


def _k5_inputs(bank, n_envs: int, n_robots: int, gen):
    """Random rows of a bank's K5 operand (robots on real nodes of random
    graphs) and random ``blocked`` at density 0.5."""
    import torch

    dev = gen.device
    g_count, t = bank["target_mask"].shape
    g = torch.randint(0, g_count, (n_envs, 1), generator=gen, device=dev)
    n_t = bank["n_targets"].long()[g]
    cur = (torch.rand(n_envs, n_robots, generator=gen, device=dev) * n_t).long()
    rowidx = (g * t + cur).to(torch.int32)
    blocked = torch.rand(n_envs, t, generator=gen, device=dev) < 0.5
    return rowidx, blocked, bank["cost_rows_pad"]


def phase_rowmin_check(device: str, banks) -> dict:
    """Phase 6: K5 against its plain version; returns errors and timings."""
    import torch

    from gym_flock_tpu_torch.ops import rowmin as k5

    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = [_k5_inputs(banks[0], 512, 100, gen), _k5_inputs(banks[1], 8192, 6, gen)]
    # ragged: costs 0..19 with 10% unreachable, env 0 fully blocked
    mm = torch.randint(0, 20, (2, 300, 300), generator=gen, device=device).float()
    mm[torch.rand(2, 300, 300, generator=gen, device=device) < 0.1] = 1024.0
    rowidx = torch.randint(0, 600, (3, 33), generator=gen, device=device, dtype=torch.int32)
    blocked = torch.rand(3, 300, generator=gen, device=device) < 0.6
    blocked[0] = True
    cases.append((rowidx, blocked, k5.pad_cost_rows(mm)))
    results = []
    for name, args in zip(K5_CASES, cases):
        got = k5.packed_greedy_min(*args)
        want = k5.packed_greedy_min_reference(*args)
        _sync()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K5 differs from plain in {bad} entries ({name})")
        results.append({"case": name, "B": args[0].shape[0], "R": args[0].shape[1],
                        "T": args[1].shape[1], "Tp": args[2].shape[1],
                        "max_abs_err": float((got - want).abs().max())})
    # got is the ragged case's: its env 0 packs 1024 at index 0 everywhere
    if not bool((got[0] == 1024 * 8192).all()):
        raise AssertionError("the fully blocked env does not decode as unreachable")
    for res, args in zip(results[:2], cases[:2]):
        res["ms"] = time_ms(lambda: k5.packed_greedy_min(*args))
        res["plain_ms"] = time_ms(lambda: k5.packed_greedy_min_reference(*args))
        # bytes the kernel must read: the gathered cost rows and the mask
        b, r = args[0].shape
        rows = b * r * args[2].shape[1]
        res["GB_per_s"] = (rows * 2 + args[1].numel()) / (res["ms"] * 1e6)
        # its bound: those bytes, the row indices and the packed result; two
        # operations (compare, select) an element
        res.update(bound(2 * rows, rows * 2 + nbytes(args[0], args[1]) + b * r * 4))
        res["library_ms"] = None
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results)}


def phase_coverage(device: str, env, params, n_envs: int, n_steps: int) -> dict:
    """Phases 7-8: a coverage env's greedy-expert rollout through K5 and K7;
    then K7 against the plain fixed point on the first step, and both
    timed."""
    import dataclasses

    import torch

    from gym_flock_tpu_torch.ops import conflicts as k7
    from gym_flock_tpu_torch.ops import rowmin as k5
    from gym_flock_tpu_torch.parallel.rollout import batch_rollout, rollout

    gen = torch.Generator(device=device).manual_seed(SEED)
    gen_state = gen.get_state()
    _sync()
    k5.launches = k7.launches = 0
    env.conflict_rounds = 0
    t0 = time.perf_counter()
    final, traj = batch_rollout(env, params, gen, n_envs, n_steps, policy="expert",
                                keep_obs=False)
    _sync()
    seconds = time.perf_counter() - t0
    launches, k7_launches, rounds = k5.launches, k7.launches, env.conflict_rounds
    if launches != n_steps:
        raise AssertionError(f"K5 launches {launches} != {n_steps} steps")
    if k7_launches != (n_steps if params.collision_checks else 0) or rounds != 0:
        raise AssertionError(f"K7 launches {k7_launches} and {rounds} host-read conflict "
                             f"rounds in {n_steps} steps")
    reward = traj["reward"]
    if tuple(reward.shape) != (n_envs, n_steps) or not torch.isfinite(reward).all():
        raise AssertionError(f"rewards of shape {tuple(reward.shape)} or not finite")
    total = float(reward.sum())
    if not total > 0:
        raise AssertionError(f"total reward {total} is not positive")

    # the same start state and first draws again, then the first action on
    # the plain argmin controller (the bank without K5's operand)
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    state0, _ = env.reset_env(replay, params, n_envs)
    rand_u = torch.randint(0, params.n_actions, (n_envs, params.n_robots), generator=replay,
                           device=device, dtype=torch.int32)
    plain = dataclasses.replace(
        params, bank={k: v for k, v in params.bank.items() if k != "cost_rows_pad"})
    u_plain = env.controller(state0, plain, rand_u=rand_u)
    if not torch.equal(traj["action"][:, 0], u_plain):
        bad = int((traj["action"][:, 0] != u_plain).sum())
        raise AssertionError(f"first-step actions differ from the plain controller in {bad}")

    # the first step's conflicts: K7 against the plain fixed point
    cur = state0.robot_loc
    nbr = params.bank["neighbor_table"][state0.graph.long()[:, None], cur.long()]
    a_sel = u_plain.long().reshape(cur.shape).clamp(0, params.n_actions - 1)
    chosen = nbr.gather(2, a_sel[..., None]).squeeze(2).contiguous()
    got = k7.resolve_conflicts(cur, chosen)
    want, plain_rounds = k7.resolve_conflicts_reference(cur, chosen)
    _sync()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"K7 differs from the plain fixed point in {bad} robots")
    k7_timing = {"B": n_envs, "R": params.n_robots, "plain_rounds": plain_rounds,
                 "moved": int((got != cur).sum()),
                 "ms": queued_ms(lambda: k7.resolve_conflicts(cur, chosen)),
                 "call_ms": time_ms(lambda: k7.resolve_conflicts(cur, chosen)),
                 "plain_ms": time_ms(lambda: k7.resolve_conflicts_reference(cur, chosen)),
                 # cur and chosen read, the result written; no arithmetic counted
                 **bound(0, 12 * n_envs * params.n_robots), "library_ms": None}

    # the rollout alone, without the reset
    _sync()
    t1 = time.perf_counter()
    rollout(env, params, gen, n_steps, policy="expert", init_state=final, init_obs=None,
            keep_obs=False)
    _sync()
    roll_s = time.perf_counter() - t1
    return {
        "launches": launches, "k7_launches": k7_launches,
        "conflict_rounds_per_step": rounds / n_steps, "k7_timing": k7_timing,
        "total_reward": total, "seconds": seconds, "rollout_seconds": roll_s,
        "env_steps_per_s": n_envs * n_steps / seconds,
        "rollout_env_steps_per_s": n_envs * n_steps / roll_s,
    }


def reset_counts() -> None:
    """Every kernel's launch counter, and the sparse pipeline's branch
    counters, to 0."""
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import conflicts as k7
    from gym_flock_tpu_torch.ops import dense_flocking as k6
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5
    from gym_flock_tpu_torch.ops import sparse_flocking as sf
    from gym_flock_tpu_torch.ops import step_tail as k8

    k1.launches = k2.launches = k2.backward_launches = k5.launches = k6.launches = 0
    k7.launches = k8.launches = 0
    sf.launches = sf.adj_launches = sf.adj_backward_launches = 0
    sf.overflow_passes = sf.adj_overflow_passes = sf.verlet_rebuilds = 0


class AdjErrors:
    """The worst errors of aggregations (K2, K4, or gradients through them)
    held against their plain versions."""

    def __init__(self):
        self.rel = 0.0
        self.abs = 0.0

    def check(self, got, want) -> float:
        """Raises unless max |k - p| / (1 + |p|) < ADJ_TOL; returns it."""
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{tuple(got.shape)} {got.dtype} against plain "
                                 f"{tuple(want.shape)} {want.dtype}")
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError("non-finite aggregation")
        diff = (got - want).abs()
        rel = float((diff / (1.0 + want.abs())).max())
        if not rel < ADJ_TOL:
            raise AssertionError(f"aggregation: max |k-p|/(1+|p|) = {rel:.3e} >= {ADJ_TOL}")
        self.rel = max(self.rel, rel)
        self.abs = max(self.abs, float(diff.max()))
        return rel


def hold(what: str, got, want, tol: float, measure: str = "rel") -> float:
    """Raise unless ``got`` (from the card) is within ``tol`` of ``want`` (a
    host copy or a plain version): ``"rel"`` max |k-p|/(1+|p|), ``"abs"``
    max |k-p|, ``"exact"`` equal (``tol`` unused).  Returns the measured
    error."""
    import torch

    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    if measure == "exact":
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs in {int((got != want).sum())} entries")
        return 0.0
    got, want = got.double(), want.double()
    if not (got.isfinite().all() and want.isfinite().all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    err = float((diff if measure == "abs" else diff / (1.0 + want.abs())).max())
    if not err <= tol:
        raise AssertionError(f"{what}: {measure} error {err:.3e} > {tol}")
    return err


def compare_deg(got, want) -> None:
    hold("degree", got, want, 0, "exact")


def _pool(out, deg, mean_pool: bool):
    import torch

    if not mean_pool:
        return out
    return out / torch.where(deg == 0, 1.0, deg)[..., None].to(out.dtype)


def plain_adjacency_matmul(x, h, cr2, mean_pool: bool):
    """``ops.adjacency_matmul.adjacency_matmul`` composed of K2's plain
    version, differentiable by autograd."""
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2

    return _pool(*k2.adjacency_matmul_block_reference(x, x, h, 0, 0, cr2), mean_pool)


def plain_adjacency_matmul_sparse(x, h, cr2, mean_pool: bool, k_max: int = 16):
    """``ops.sparse_flocking.adjacency_matmul_sparse`` composed of K4's
    plain version (K2's where the table overflows), differentiable by
    autograd: the same sort and table, then the plain pass."""
    import torch

    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    cr = torch.sqrt(torch.tensor(cr2, dtype=torch.float32, device=x.device))
    perm = sf.hilbert_order(x, cr)
    xs = sf.permute(x, perm)
    table, overflow = sf.block_pair_table(xs, cr, k_max)
    if bool(overflow.any()):
        return _pool(*k2.adjacency_matmul_block_reference(x, x, h, 0, 0, cr2), mean_pool)
    out, deg = sf.sparse_adj_sorted_reference(xs, sf.permute(h, perm), table, cr2)
    return _pool(sf.unsort(out, perm), sf.unsort(deg[..., None], perm)[..., 0], mean_pool)


def plain_khop(x, features, cr2, k_hops: int, sparse: bool):
    """``[X, AX, A^2 X, ...]`` on the plain passes: the aggregation of the
    large GNN without K2 or K4."""
    import torch

    step = plain_adjacency_matmul_sparse if sparse else plain_adjacency_matmul
    zs = [features]
    for _ in range(k_hops - 1):
        zs.append(step(x, zs[-1], cr2, True))
    return torch.cat(zs, dim=-1)


def grad_pair(fn, plain_fn, h, cotangent):
    """``d sum(fn(h) * cotangent) / dh`` through the kernel's autograd.Function
    and through autograd of its plain version."""
    grads = []
    for f in (fn, plain_fn):
        hg = h.detach().clone().requires_grad_()
        (f(hg) * cotangent).sum().backward()
        grads.append(hg.grad)
    return grads


def adj_edge_swarms(name: str, cr: float, device: str):
    """``edge_swarms`` for K2 and K4, and ``"nan position"``: "band" with
    agent 5's position NaN, a neighbour of nobody."""
    import torch

    x = edge_swarms("band" if name == "nan position" else name, cr)
    if name == "nan position":
        x[:, 5, :2] = float("nan")
    return torch.from_numpy(x).to(device)


ADJ_EDGE_CASES = EDGE_CASES + ("nan position",)
ADJ_WIDTHS = (1, 6, 8, 9, 16)  # feature widths held against the plain versions


def k2_timing(name: str, xr, xc, h, ro: int, co: int, plain: bool) -> dict:
    """K2's time on these operands (and its plain version's where
    ``plain``), its launch geometry and its bound: the test on every pair,
    2F+1 flops a neighbour pair; the operands read once, the sums and the
    degree written once."""
    import torch

    from gym_flock_tpu_torch.ops import adjacency_matmul as k2

    b, m, _ = xr.shape
    k, f = xc.shape[1], h.shape[-1]
    res = {"case": name, "B": b, "m": m, "k": k, "F": f,
           "ms": time_ms(lambda: k2.adjacency_matmul_block(xr, xc, h, ro, co, CR2))}
    if plain:
        res["plain_ms"] = time_ms(
            lambda: k2.adjacency_matmul_block_reference(xr, xc, h, ro, co, CR2))
    neighbours = int(k2.adjacency_matmul_block(xr, xc, h, ro, co, CR2)[1].sum())
    ids = torch.arange(m, device=xr.device)[:, None] + ro
    pairs = b * int((ids != torch.arange(k, device=xr.device) + co).sum())
    blocks, threads, groups = k2.launch_grid(b, m, k)
    res.update(gpairs_per_s=b * m * k / (res["ms"] * 1e6), blocks=blocks, threads=threads,
               groups=groups, warps_per_sm=warps_per_sm(blocks, threads),
               launches_a_call=-(-f // 8), pairs=pairs, pairs_in_reach=neighbours,
               **bound(PAIR_TEST_FLOPS * pairs + (2 * f + 1) * neighbours,
                       nbytes(xr, xc, h) + b * m * (f + 1) * 4),
               library_ms=None)
    return res


def phase_adj_check(device: str, b: int, n: int, f: int) -> dict:
    """Phase 12: K2 against its plain version, forward and backward, at
    ``(b, n, f)``, a cross-block tile, the gradients, the edge-case swarms
    and a ragged block at each of ``ADJ_WIDTHS``."""
    import torch

    from gym_flock_tpu_torch.ops import adjacency_matmul as k2

    gen = torch.Generator(device=device).manual_seed(SEED)
    err = AdjErrors()

    def check_block(xr, xc, hc, ro, co, cr2):
        out, deg = k2.adjacency_matmul_block(xr, xc, hc, ro, co, cr2)
        want, want_deg = k2.adjacency_matmul_block_reference(xr, xc, hc, ro, co, cr2)
        _sync()
        compare_deg(deg, want_deg)
        err.check(out, want)

    # (a) the trainer's batch: FlockingLarge-v0 reset draws
    x = draw_swarms(b, n, device, SEED + n)
    h = torch.randn(b, n, f, generator=gen, device=device)
    out, deg = k2.adjacency_matmul_block(x, x, h, 0, 0, CR2)
    want, want_deg = k2.adjacency_matmul_block_reference(x, x, h, 0, 0, CR2)
    _sync()
    compare_deg(deg, want_deg)
    err.check(out, want)
    for mean_pool in (False, True):
        got = k2.adjacency_matmul(x, h, CR2, mean_pool=mean_pool)
        err.check(got, plain_adjacency_matmul(x, h, CR2, mean_pool))
    mean_deg = float(want_deg.mean())

    # (b) a cross-block tile: rows are agents 0..999, columns 600..1299 of
    # the same swarms, so ids 600..999 meet themselves; F=16 (two chunks)
    xb = draw_swarms(3, 1300, device, SEED + 1300)
    hb = torch.randn(3, 1300, 16, generator=gen, device=device)
    xr, xc, hc = xb[:, :1000].contiguous(), xb[:, 600:].contiguous(), hb[:, 600:].contiguous()
    out_b, deg_b = k2.adjacency_matmul_block(xr, xc, hc, 0, 600, CR2)
    want_b, want_deg_b = k2.adjacency_matmul_block_reference(xr, xc, hc, 0, 600, CR2)
    _sync()
    compare_deg(deg_b, want_deg_b)
    err.check(out_b, want_b)

    # (c) dH of 4 swarms: both pool modes, and the block form's
    # swapped-operand backward (rows 0..5n/8, columns 3n/8..n: the ids
    # overlap)
    xg, hg = x[:4].contiguous(), h[:4].contiguous()
    co = torch.randn(hg.shape, generator=gen, device=device)
    backward = k2.backward_launches
    for mean_pool in (False, True):
        err.check(*grad_pair(lambda v: k2.adjacency_matmul(xg, v, CR2, mean_pool),
                             lambda v: plain_adjacency_matmul(xg, v, CR2, mean_pool), hg, co))
    m, c0 = 5 * n // 8, 3 * n // 8
    xr, xc = xg[:, :m].contiguous(), xg[:, c0:].contiguous()
    hc = hg[:, c0:].contiguous()
    co_b = co[:, :m].contiguous()
    err.check(*grad_pair(
        lambda v: k2.adjacency_matmul_block(xr, xc, v, 0, c0, CR2)[0],
        lambda v: k2.adjacency_matmul_block_reference(xr, xc, v, 0, c0, CR2)[0], hc, co_b))
    _sync()
    backward = k2.backward_launches - backward
    if backward != 3:
        raise AssertionError(f"{backward} K2 backward launches for 3 gradients")

    # (d) the edge-case swarms (and a NaN position) at two radii: degrees
    # exact, sums as the plain version's
    cases = 0
    for radius in (0.9, 2.0):
        for name in ADJ_EDGE_CASES:
            xe = adj_edge_swarms(name, radius, device)
            he = torch.randn(xe.shape[:2] + (6,), generator=gen, device=device)
            check_block(xe, xe, he, 0, 0, radius * radius)
            cases += 1
    # (e) a ragged block at each width: rows 130..1036 against columns
    # 0..999, so each row's own column lies in the second tile
    for width in ADJ_WIDTHS:
        hw = torch.randn(3, 1000, width, generator=gen, device=device)
        check_block(xb[:, 130:1037].contiguous(), xb[:, :1000].contiguous(), hw, 130, 0, CR2)
        cases += 1

    timings = [k2_timing(f"B={b},N={n},F={f}", x, x, h, 0, 0, plain=True)]
    # the cost of F > 8 (one launch a chunk of 8 features, each repeating
    # the test): (b)'s tile at F=16 and at F=8
    xr, xc = xb[:, :1000].contiguous(), xb[:, 600:].contiguous()
    for width in (16, 8):
        timings.append(k2_timing(f"(b) B=3,1000x700,F={width}", xr, xc,
                                 hb[:, 600:, :width].contiguous(), 0, 600, plain=False))
    return {"max_rel": err.rel, "max_abs_err": err.abs, "edge_and_width_cases": cases,
            "backward_launches": backward, "mean_degree": mean_deg, "timings": timings}


def phase_sparse_adj_check(device: str, shapes, **reset_overrides) -> dict:
    """Phase 13: K4 against its plain version, forward and backward, at the
    two ``(B, N)`` of ``shapes`` (B=1 first), and the overflow branch on
    dense K2 at FlockingSparse-v0's reset."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cr = torch.sqrt(torch.tensor(CR2, dtype=torch.float32, device=device))
    err = AdjErrors()
    timings = []

    def check_sorted(name, xs, hs, table, time_it, cr2=CR2):
        out, deg = sf.sparse_adj_sorted(xs, hs, table, cr2)
        want, want_deg = sf.sparse_adj_sorted_reference(xs, hs, table, cr2)
        _sync()
        compare_deg(deg, want_deg)
        err.check(out, want)
        if time_it:
            b, n, _ = xs.shape
            pairs = int((table >= 0).sum()) * sf.BLOCK * sf.BLOCK
            res = {"case": name, "B": b, "N": n, "F": hs.shape[-1],
                   "listed_slots_per_row_block": float((table >= 0).sum(-1).float().mean()),
                   "max_slots": int((table >= 0).sum(-1).max()), "listed_pairs": pairs}
            res["ms"] = time_ms(lambda: sf.sparse_adj_sorted(xs, hs, table, CR2))
            res["plain_ms"] = time_ms(lambda: sf.sparse_adj_sorted_reference(xs, hs, table,
                                                                             CR2))
            res["gpairs_per_s"] = pairs / (res["ms"] * 1e6)
            blocks, threads, groups = sf.adj_launch_grid(b, n, table.shape[-1])
            res.update(blocks=blocks, threads=threads, groups=groups,
                       warps_per_sm=warps_per_sm(blocks, threads))
            # the test on every listed pair (the self pairs excluded), 2F+1
            # flops a neighbour pair
            listed, _ = k3_pair_counts(xs, table, 0.0, 0.0)
            neighbours = int(want_deg.sum())
            res["pairs_in_reach"] = neighbours
            res.update(bound(PAIR_TEST_FLOPS * listed + (2 * hs.shape[-1] + 1) * neighbours,
                             nbytes(xs, hs, table) + b * n * (hs.shape[-1] + 1) * 4))
            res["library_ms"] = None
            timings.append(res)

    # (a) and (b) on phase 9's states (bench metric 4's), F=6: the table the
    # aggregation builds (at sqrt(cr2), no skin) and, at (a), phase 9's
    # Verlet table (skin = the radius), a superset
    for b, n in shapes:
        x = bench_state(b, n, SEED + b, device)
        h = torch.randn(b, n, 6, generator=gen, device=device)
        perm = sf.hilbert_order(x, cr)
        xs, hs = sf.permute(x, perm), sf.permute(h, perm)
        table, overflow = sf.block_pair_table(xs, cr, 16)
        if bool(overflow.any()):
            raise AssertionError(f"the B={b}, N={n} aggregation table overflows k_max")
        check_sorted(f"B={b},N={n}", xs, hs, table, time_it=True)
        if b == 1:
            vs = sf.verlet_build(x, 0.9, 0.9)
            check_sorted(f"B=1,N={n},Verlet table", sf.permute(x, vs.perm),
                         sf.permute(h, vs.perm), vs.table, time_it=True)

    # exact pruning at (b): the degree through the table equals dense K2's
    _, deg_s = sf.sparse_adj_sorted(xs, hs, table, CR2)
    _, deg_d = k2.adjacency_matmul_block(x, x, h, 0, 0, CR2)
    compare_deg(sf.unsort(deg_s[..., None], perm)[..., 0], deg_d)

    # (e) the edge-case swarms (and a NaN position) at two radii, sorted and
    # tabled at the radius; (f) a ragged table at N=1,024, B=3 (pad slots
    # first and past the listed blocks) at each of ADJ_WIDTHS
    cases = 0
    for radius in (0.9, 2.0):
        for name in ADJ_EDGE_CASES:
            xe = adj_edge_swarms(name, radius, device)
            pe = sf.hilbert_order(xe, radius)
            xes = sf.permute(xe, pe)
            he = torch.randn(xe.shape[:2] + (6,), generator=gen, device=device)
            check_sorted(f"{name} cr={radius}", xes, he,
                         sf.block_pair_table(xes, radius, 16)[0], False, cr2=radius * radius)
            cases += 1
    xq = bench_state(3, 1024, SEED + 3, device)
    xrs = sf.permute(xq, sf.hilbert_order(xq, cr))
    table_r, _ = sf.block_pair_table(xrs, cr, 16)
    ragged = torch.cat([table_r.flip(-1), torch.full_like(table_r[..., :3], -1)], dim=-1)
    for width in ADJ_WIDTHS:
        hw = torch.randn(3, 1024, width, generator=gen, device=device)
        check_sorted(f"ragged B=3,N=1024,F={width}", xrs, hw, ragged.contiguous(), False)
        cases += 1

    # (c) dH through the pipeline on 4 of (b)'s swarms, both pool modes
    xg, hg = x[:4].contiguous(), h[:4].contiguous()
    co = torch.randn(hg.shape, generator=gen, device=device)
    backward, overflowed = sf.adj_backward_launches, sf.adj_overflow_passes
    for mean_pool in (False, True):
        err.check(*grad_pair(
            lambda v: sf.adjacency_matmul_sparse(xg, v, CR2, mean_pool=mean_pool),
            lambda v: plain_adjacency_matmul_sparse(xg, v, CR2, mean_pool), hg, co))
    _sync()
    backward = sf.adj_backward_launches - backward
    if backward != 2 or sf.adj_overflow_passes != overflowed:
        raise AssertionError(f"{backward} K4 backward launches for 2 gradients, "
                             f"{sf.adj_overflow_passes - overflowed} overflowing passes")

    # (d) phase 11's reset state (N=16,384, B=4): the table overflows, so the
    # pass runs on dense K2
    env, params = gft.make("FlockingSparse-v0", **reset_overrides)
    x0 = env.reset_env(torch.Generator(device=device).manual_seed(SEED), params, 4)[0].x
    h0 = torch.randn(4, params.n_agents, 6, generator=gen, device=device)
    before = (sf.adj_launches, sf.adj_overflow_passes, k2.launches)
    got = sf.adjacency_matmul_sparse(x0, h0, CR2)
    _sync()
    took = (sf.adj_launches - before[0], sf.adj_overflow_passes - before[1],
            k2.launches - before[2])
    if took != (0, 1, 1):
        raise AssertionError(f"the reset state's pass took (K4, overflowing, K2) = {took}, "
                             f"want (0, 1, 1)")
    dense_rel = err.check(got, plain_adjacency_matmul_sparse(x0, h0, CR2, True))
    return {"max_rel": err.rel, "max_abs_err": err.abs, "backward_launches": backward,
            "edge_and_width_cases": cases, "reset_state_on_k2": {"max_rel": dense_rel},
            "timings": timings}


def phase_large_train(device: str, n_envs: int, n_steps: int, n_updates: int,
                      **overrides) -> dict:
    """Phase 14: ``LargeFlockingImitationTrainer`` on FlockingLarge-v0, its
    aggregation on K2."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.models import LargeAggregationGNN
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.parallel import LargeFlockingImitationTrainer

    env, params = gft.make("FlockingLarge-v0", **overrides)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer = LargeFlockingImitationTrainer(env, params, device=device)
    trainer.init(gen)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    batch = trainer.collect(gen, n_envs, n_steps)
    _sync()
    collect_s = time.perf_counter() - t0
    k1_collect = k1.launches
    # the reset's draws and its observation, then one fused pass a step
    if k1_collect != env.last_reset_tries + 1 + n_steps or k2.launches != 0:
        raise AssertionError(f"collect: K1 {k1_collect} launches for {env.last_reset_tries} "
                             f"reset draws + 1 + {n_steps} passes, K2 {k2.launches}")

    # the first batch's loss through the plain aggregation, same weights
    plain = LargeAggregationGNN(
        comm_radius2=params.comm_radius2, device=device,
        aggregate_fn=lambda x, f: plain_khop(x, f, params.comm_radius2, 3, sparse=False))
    plain.load_state_dict(trainer.model.state_dict())
    with torch.no_grad():
        plain_loss = float(trainer_loss(plain, batch))
    k2.launches = 0

    t0 = time.perf_counter()
    losses = [float(trainer.update(batch))]
    _sync()
    first_update_s = time.perf_counter() - t0
    # the other steps as ``train_step`` takes them, collect and update timed
    # apart (the first call of each pays one-time set-up)
    collects, updates = [], []
    for _ in range(n_updates - 1):
        t0 = time.perf_counter()
        step_batch = trainer.collect(gen, n_envs, n_steps)
        _sync()
        t1 = time.perf_counter()
        losses.append(float(trainer.update(step_batch)))
        _sync()
        collects.append(t1 - t0)
        updates.append(time.perf_counter() - t1)
    k2_launches, k2_backward = k2.launches, k2.backward_launches
    if k2_launches != 2 * n_updates or k2_backward != 0:
        raise AssertionError(f"K2 {k2_launches} launches ({k2_backward} backward) for "
                             f"{n_updates} updates: want 2 forward each (k_hops - 1)")
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    if not loss_rel < 1e-5:
        raise AssertionError(f"first loss {losses[0]} against {plain_loss} through the plain "
                             f"aggregation: relative {loss_rel:.3e}")
    check_training(losses, before, trainer.model)

    # one train step's split: the K2 aggregation and one K1 pass by CUDA
    # events, on this batch's shape
    xs, feats, _ = batch
    squashed = torch.asinh(feats)
    k2_ms = time_ms(lambda: k2.khop_aggregate(xs, squashed, params.comm_radius2, 3))
    x_pass = xs[:n_envs].contiguous()
    k1_pass_ms = time_ms(lambda: env._fused_pass(x_pass, params, True))
    return {"losses": losses, "plain_first_loss": plain_loss, "first_loss_rel": loss_rel,
            "k2_launches": k2_launches, "k2_backward_launches": k2_backward,
            "k1_collect_launches": k1_collect, "reset_tries": env.last_reset_tries,
            "first_collect_seconds": collect_s, "first_update_seconds": first_update_s,
            "collect_seconds": statistics.median(collects),
            "update_seconds": statistics.median(updates),
            "k2_aggregation_ms": k2_ms, "k1_pass_ms": k1_pass_ms,
            "batch": list(xs.shape)}


def trainer_loss(model, batch):
    import torch

    *inputs, actions = batch
    return torch.mean((model(*inputs) - actions) ** 2)


def check_training(losses, before, model) -> None:
    import math

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    moved = max(float((p.detach() - b).abs().max()) for p, b in zip(model.parameters(), before))
    if not moved > 0.0:
        raise AssertionError("the parameters did not move")


def phase_sparse_train(device: str, n_agents: int, n_steps: int, n_updates: int) -> dict:
    """Phase 15: ``LargeAggregationGNN`` with ``khop_aggregate_sparse`` on
    FlockingSparse-v0 from bench metric 4's state, its aggregation on K4."""
    import functools

    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.models import LargeAggregationGNN
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import sparse_flocking as sf
    from gym_flock_tpu_torch.parallel import (LargeFlockingImitationTrainer,
                                              collect_large_flocking_batch)

    env, params = gft.make("FlockingSparse-v0", n_agents=n_agents)
    cr2 = params.comm_radius2
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = LargeAggregationGNN(
        comm_radius2=cr2, generator=gen, device=device,
        aggregate_fn=functools.partial(sf.khop_aggregate_sparse, comm_radius2=cr2, k_hops=3))
    trainer = LargeFlockingImitationTrainer(env, params, model=model, device=device)
    before = [p.detach().clone() for p in model.parameters()]
    state = env.init_state(bench_state(1, n_agents, SPARSE_SEED, device), params)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    batch = collect_large_flocking_batch(env, params, gen, 1, n_steps, init_state=state)
    _sync()
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = [float(trainer.update(batch)) for _ in range(n_updates)]
    _sync()
    update_s = time.perf_counter() - t0
    counts = {"k3_launches": sf.launches, "k1_launches": k1.launches,
              "k4_launches": sf.adj_launches, "k4_backward_launches": sf.adj_backward_launches,
              "k2_fallbacks": sf.adj_overflow_passes, "k2_launches": k2.launches}
    passes = 2 * n_updates
    if (counts["k4_launches"] == 0 or counts["k4_backward_launches"] != 0
            or counts["k4_launches"] + counts["k2_fallbacks"] != passes
            or counts["k2_launches"] != counts["k2_fallbacks"]):
        raise AssertionError(
            f"{counts} for {passes} aggregation passes: from numpy seed {SPARSE_SEED}'s "
            f"trajectory the tables stay within k_max; K2 fallbacks mean a state of this "
            f"seed's workload crossed it (see SPARSE_SEED)")
    check_training(losses, before, model)

    # the trained model's loss on the batch against the plain sparse
    # aggregation's with the same weights
    plain = LargeAggregationGNN(comm_radius2=cr2, device=device,
                                aggregate_fn=lambda x, f: plain_khop(x, f, cr2, 3, sparse=True))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        plain_loss = float(trainer_loss(plain, batch))
        got = float(trainer_loss(model, batch))
    loss_rel = abs(got - plain_loss) / abs(plain_loss)
    if not loss_rel < 1e-5:
        raise AssertionError(f"loss {got} against {plain_loss} through the plain "
                             f"aggregation: relative {loss_rel:.3e}")
    return {**counts, "losses": losses, "loss_vs_plain_rel": loss_rel,
            "collect_seconds": collect_s, "update_seconds_each": update_s / n_updates,
            "batch": list(batch[0].shape)}


def phase_relative_train(device: str, n_envs: int, n_steps: int, n_updates: int,
                         **overrides) -> dict:
    """Phase 16: ``FlockingImitationTrainer`` on FlockingRelative-v0; K1 in
    the resets, the aggregation dense ``torch.matmul``."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.parallel import FlockingImitationTrainer

    env, params = gft.make("FlockingRelative-v0", **overrides)
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer = FlockingImitationTrainer(env, params, device=device)
    trainer.init(gen)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    _sync()
    reset_counts()
    tries, losses = 0, []
    collect_s = update_s = 0.0
    for _ in range(n_updates):
        t0 = time.perf_counter()
        batch = trainer.collect(gen, n_envs, n_steps)
        _sync()
        t1 = time.perf_counter()
        losses.append(float(trainer.update(batch)))
        _sync()
        collect_s += t1 - t0
        update_s += time.perf_counter() - t1
        tries += env.last_reset_tries
    if k1.launches != tries or k2.launches != 0:
        raise AssertionError(f"K1 {k1.launches} launches for {tries} reset draws, "
                             f"K2 {k2.launches}")
    check_training(losses, before, trainer.model)
    return {"losses": losses, "k1_launches": k1.launches, "reset_tries": tries,
            "collect_seconds_each": collect_s / n_updates,
            "update_seconds_each": update_s / n_updates,
            "batch": list(batch[0].shape)}


def arl_world(device: str, bank_seed: int):
    """``CoverageARL-v0`` on the real ARL facility map (``real_map=True``
    raises where ``find_reference_map`` finds none): 8 sub-windows, R=4,
    T=996, with K5's operand."""
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.maps import find_reference_map

    if find_reference_map(10) is None:
        raise AssertionError("find_reference_map found no ARL map: not the real world")
    env, params = gft.make("CoverageARL-v0", n_graphs=8, bank_seed=bank_seed, device=device,
                           real_map=True)
    if (params.n_robots, params.max_targets) != (4, 996) or "cost_rows_pad" not in params.bank:
        raise AssertionError(f"CoverageARL-v0: R={params.n_robots} T={params.max_targets}, "
                             f"K5 operand {'cost_rows_pad' in params.bank}")
    return env, params


def check_k5_count(what: str, steps: int) -> int:
    from gym_flock_tpu_torch.ops import rowmin as k5

    if k5.launches != steps:
        raise AssertionError(f"{what}: K5 launched {k5.launches} times for {steps} expert steps")
    return k5.launches


def replay_coverage_collect(env, params, gen_state, batch, n_envs: int, n_steps: int) -> None:
    """Reset from ``gen_state`` as the collect did, then step with the
    stored labels: every stored observation must be the one they lead to,
    i.e. the labels are the actions taken."""
    import torch

    gen = torch.Generator(device=params.device)
    gen.set_state(gen_state)
    state, obs = env.reset_env(gen, params, n_envs)
    view = {k: v.reshape((n_envs, n_steps) + v.shape[1:]) for k, v in batch.items()}
    for t in range(n_steps):
        for k in ("nodes", "edges", "senders", "receivers"):
            if not torch.equal(obs[k], view[k][:, t]):
                raise AssertionError(f"step {t}: stored {k} is not where the labels lead")
        state, obs, _, _, _ = env.step_env(None, state, view["label"][:, t], params)


def k5_state_case(params, state) -> dict:
    """K5 on the greedy expert's operands at a CoverageARL-v0 state: bitwise
    equal to plain, its time, the plain version's and its bound."""
    import torch

    from gym_flock_tpu_torch.ops import rowmin as k5

    n_envs, t = state.graph.shape[0], params.max_targets
    rowidx = (state.graph[:, None] * t + state.robot_loc).to(torch.int32).contiguous()
    blocked = ((state.visited >= 1.0) | ~params.bank["target_mask"][state.graph.long()])
    k5_args = (rowidx, blocked.contiguous(), params.bank["cost_rows_pad"])
    case = f"CoverageARL B={n_envs} R={params.n_robots} T={t}"
    if not torch.equal(k5.packed_greedy_min(*k5_args), k5.packed_greedy_min_reference(*k5_args)):
        raise AssertionError(f"K5 differs from plain at {case}")
    rows = n_envs * params.n_robots * k5_args[2].shape[1]
    return {"case": case, "B": n_envs, "R": params.n_robots, "T": t,
            "Tp": k5_args[2].shape[1],
            "ms": time_ms(lambda: k5.packed_greedy_min(*k5_args)),
            "plain_ms": time_ms(lambda: k5.packed_greedy_min_reference(*k5_args)),
            "library_ms": None,
            **bound(2 * rows, rows * 2 + nbytes(rowidx, k5_args[1]) + rowidx.numel() * 4)}


def phase_coverage_train(device: str, world, eval_params, n_envs: int, n_steps: int,
                         n_updates: int, eval_envs: int, eval_steps: int) -> dict:
    """Phase 17: ``CoverageImitationTrainer`` with ``EdgeGraphNet(64, 6)`` on
    the real CoverageARL-v0 world, K5 once a collect step; then
    ``evaluate`` on the held-out bank."""
    import dataclasses

    import torch

    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageImitationTrainer

    env, params = world
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = EdgeGraphNet(latent=64, rounds=6, generator=gen, device=device)
    trainer = CoverageImitationTrainer(env, params, model=model, device=device)
    trainer.init(gen)
    before = [p.detach().clone() for p in model.parameters()]

    # the first train step, collect and update apart; the first collect
    # step's labels against the plain argmin controller on the same state
    # and draws; the first loss against a CPU copy of the model
    gen_state = gen.get_state()
    _sync()
    reset_counts()
    batch = trainer.collect(gen, n_envs, n_steps)
    _sync()
    check_k5_count("the first collect", n_steps)
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    state0, _ = env.reset_env(replay, params, n_envs)
    rand_u = torch.randint(0, params.n_actions, (n_envs, params.n_robots), generator=replay,
                           device=device, dtype=torch.int32)
    plain = dataclasses.replace(
        params, bank={k: v for k, v in params.bank.items() if k != "cost_rows_pad"})
    u_plain = env.controller(state0, plain, rand_u=rand_u)[..., 0]
    first = batch["label"].reshape(n_envs, n_steps, -1)[:, 0]
    if not torch.equal(first, u_plain):
        raise AssertionError(f"first collect step's labels differ from the plain controller "
                             f"in {int((first != u_plain).sum())}")
    cpu = CoverageImitationTrainer(env, params, model=EdgeGraphNet(64, 6), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu_loss = float(cpu.loss_fn({k: v.cpu() for k, v in batch.items()}))
    losses = [float(trainer.update(batch))]
    loss_rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    if not loss_rel < 1e-5:
        raise AssertionError(f"first loss {losses[0]} against {cpu_loss} on the CPU copy: "
                             f"relative {loss_rel:.3e}")

    # K5 at this slice's shape, on the first collect's state
    k5_timing = k5_state_case(params, state0)

    # the other steps as train_step takes them, collect and update timed
    # apart (the first call of each paid one-time set-up)
    reset_counts()
    collect_s = update_s = 0.0
    for _ in range(n_updates - 1):
        t0 = time.perf_counter()
        batch = trainer.collect(gen, n_envs, n_steps)
        _sync()
        t1 = time.perf_counter()
        losses.append(float(trainer.update(batch)))
        _sync()
        collect_s += t1 - t0
        update_s += time.perf_counter() - t1
    launches = n_steps + check_k5_count("the train steps", (n_updates - 1) * n_steps)
    check_training(losses, before, model)

    # the held-out bank: accuracy, policy and expert episode reward
    reset_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate(torch.Generator(device=device).manual_seed(99), eval_params,
                          n_envs=eval_envs, n_steps=eval_steps)
    _sync()
    eval_s = time.perf_counter() - t0
    eval_launches = check_k5_count("evaluate (its collect and the expert's episode)",
                                   2 * eval_steps)
    if not all(math.isfinite(v) for v in ev.values()) or not ev["expert_reward"] > 0:
        raise AssertionError(f"held-out evaluation {ev}")
    return {"losses": losses, "loss_vs_cpu_rel": loss_rel, "k5_launches": launches,
            "collect_ms": 1e3 * collect_s / (n_updates - 1),
            "update_ms": 1e3 * update_s / (n_updates - 1),
            "heldout": ev, "eval_seconds": eval_s, "eval_k5_launches": eval_launches,
            "k5_timing": k5_timing, "batch": list(batch["nodes"].shape)}


def phase_coverage_dagger(device: str, world, capacity: int, n_envs: int, n_steps: int,
                          n_grad_steps: int, batch_size: int) -> dict:
    """Phase 18: ``CoverageDaggerTrainer`` on phase 17's world, two
    iterations."""
    import torch

    from gym_flock_tpu_torch.models import EdgeGraphNet
    from gym_flock_tpu_torch.parallel import CoverageDaggerTrainer

    env, params = world
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    trainer = CoverageDaggerTrainer(
        env, params, model=EdgeGraphNet(64, 6, generator=gen, device=device),
        capacity=capacity, device=device)
    trainer.init(gen)
    losses, seconds, launches = [], [], 0
    for k in range(2):
        gen_state = gen.get_state()
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        losses.append(float(trainer.iteration(gen, trainer.beta_decay ** k, n_envs, n_steps,
                                              n_grad_steps, batch_size)))
        seconds.append(time.perf_counter() - t0)
        launches += check_k5_count(f"DAGGER iteration {k}", n_steps)
        n_new = n_envs * n_steps * (k + 1)
        if (trainer.write_pos, trainer.filled) != (n_new % capacity, min(n_new, capacity)):
            raise AssertionError(f"iteration {k}: write_pos {trainer.write_pos}, "
                                 f"filled {trainer.filled}")
        if k == 0:  # beta = 1: the labels are the actions taken
            first = {key: v[:n_envs * n_steps] for key, v in trainer.buffer.items()}
            replay_coverage_collect(env, params, gen_state, first, n_envs, n_steps)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return {"losses": losses, "iteration_seconds": seconds, "k5_launches": launches,
            "write_pos": trainer.write_pos, "filled": trainer.filled}


def phase_vrp_labels(device: str, world, n_envs: int, n_steps: int) -> dict:
    """Phase 19: ``collect_vrp_labeled_batch`` on phase 17's world, the VRP
    solver built with g++ from the port's copy."""
    import numpy as np
    import torch

    from gym_flock_tpu_torch.experts import vrp
    from gym_flock_tpu_torch.parallel import collect_vrp_labeled_batch, vrp_label_states
    from gym_flock_tpu_torch.parallel.train_coverage import STATE_KEYS, greedy_rollout

    env, params = world
    t0 = time.perf_counter()
    # a one-node problem: builds the library
    if vrp.solve_vrp_raw([[0.0, 0.0], [0.0, 0.0]], [0.0, 0.0], [1], 1.0) != [[1]]:
        raise AssertionError("the VRP solver's one-node route")
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    gen_state = gen.get_state()
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    batch = collect_vrp_labeled_batch(env, params, gen, n_envs, n_steps, mode="or_default",
                                      workers=2)
    _sync()
    collect_s = time.perf_counter() - t0
    launches = check_k5_count("the VRP behaviour rollout", n_steps)
    labels = batch["label"]
    if labels.shape != (n_envs * n_steps, params.n_robots) or not bool(
            ((labels >= 0) & (labels < params.n_actions)).all()):
        raise AssertionError(f"labels {tuple(labels.shape)} out of [0, {params.n_actions})")
    # the same states again (same draws), labelled on one thread, then two
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    states = {k: v for k, v in greedy_rollout(env, params, replay, n_envs, n_steps,
                                              keep_state=True).items() if k in STATE_KEYS}
    t0 = time.perf_counter()
    one = vrp_label_states(params, states, workers=1)
    label1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = vrp_label_states(params, states, workers=2)
    label2_s = time.perf_counter() - t0
    if not (np.array_equal(labels.cpu().numpy(), one) and np.array_equal(one, two)):
        raise AssertionError("VRP labels differ between the batch, one worker and two")
    return {"k5_launches": launches, "collect_seconds": collect_s, "build_seconds": build_s,
            "label_seconds_workers1": label1_s, "label_seconds_workers2": label2_s,
            "states": n_envs * n_steps}


def phase_flocking_dagger(device: str, n_envs: int, n_steps: int, n_grad_steps: int) -> dict:
    """Phase 20: ``DaggerTrainer`` on FlockingRelative-v0 (N=100) with
    ``AggregationGNN(k_hops=4, hidden=(128, 128))``; K1 once a reset draw."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.flocking import turner_controller
    from gym_flock_tpu_torch.models import AggregationGNN
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.parallel import DaggerTrainer

    env, params = gft.make("FlockingRelative-v0")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = AggregationGNN(k_hops=4, hidden=(128, 128), generator=gen, device=device)
    trainer = DaggerTrainer(env, params, model=model, capacity=8192, device=device)
    trainer.init(gen)
    before = [p.detach().clone() for p in model.parameters()]
    losses, seconds, launches, tries = [], [], 0, 0
    for k in range(2):
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        losses.append(float(trainer.iteration(gen, trainer.beta_decay ** k, n_envs, n_steps,
                                              n_grad_steps)))
        seconds.append(time.perf_counter() - t0)
        if k1.launches != env.last_reset_tries:
            raise AssertionError(f"iteration {k}: K1 {k1.launches} launches for "
                                 f"{env.last_reset_tries} reset draws")
        launches += k1.launches
        tries += env.last_reset_tries
        if k == 0:
            n_new = n_envs * n_steps
            s = trainer.state
            if not torch.equal(s.buffer_label[:n_new], turner_controller(s.buffer_x[:n_new],
                                                                         params)):
                raise AssertionError("iteration 0's labels are not the Turner controller's")
    check_training(losses, before, model)
    return {"losses": losses, "iteration_seconds": seconds, "k1_launches": launches,
            "reset_tries": tries, "filled": trainer.state.filled}


# --------------------------------------------------------------------------
# Phases 21-25: the flocking variants, shepherding, formation, LQR, mapping
# and delayed-aggregation flocking
# --------------------------------------------------------------------------

CPU_ENVS = 64  # envs of a batch whose first step is repeated on the host
FLOCKING_VARIANTS = (("Flocking-v0", 8192), ("FlockingLeader-v0", 1024),
                     ("FlockingObstacle-v0", 1024), ("FlockingStochastic-v0", 1024),
                     ("FlockingTwoFlocks-v0", 1024))
MAPPING_OTHERS = ("MappingVel-v0", "MappingDisc-v0", "MappingLocal-v0")
LQR_SYSTEM_TOL = 1e-3  # the card's LQR system against the host's build (of max |host|)
LQR_STEP_TOL = 1e-5  # max |k - p| / (1 + |p|) of an LQR step or expert action


def host_head(obj, k: int | None = CPU_ENVS):
    """The first ``k`` envs (all where ``k`` is None) of a tensor, or of a
    tuple, dict or dataclass of them, nested, on the host."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return (obj if k is None else obj[:k]).cpu()
    if isinstance(obj, tuple):
        return tuple(host_head(o, k) for o in obj)
    if isinstance(obj, dict):
        return {key: host_head(v, k) for key, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: host_head(getattr(obj, f.name), k)
                                           for f in dataclasses.fields(obj)})
    return obj


def check_all_finite(what: str, *tensors) -> None:
    for t in tensors:
        if t.is_floating_point() and not bool(t.isfinite().all()):
            raise AssertionError(f"non-finite values in {what}")


def launch_total() -> int:
    """Launches of every kernel since the last ``reset_counts``."""
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5
    from gym_flock_tpu_torch.ops import sparse_flocking as sf

    return k1.launches + k2.launches + k5.launches + sf.launches + sf.adj_launches


def flocking_first_step_on_host(env, params, state0, traj, gen_state, device: str) -> dict:
    """The first fused step of ``expert_rollout`` from the first envs of
    ``state0``, repeated on the host and held to the card's ``traj`` at step
    0: the action from the same state; the integration (the stochastic
    variant's dt replayed from ``gen_state``) against the card's own first
    step, replayed; the observation, network and reward at the card's new
    state, as the 1/r^4 features of close pairs amplify the integration's
    rounding."""
    import torch

    from gym_flock_tpu_torch.envs.flocking import (
        FlockingAbsoluteEnv, FlockingStochasticEnv, _instant_cost)

    x0 = host_head(state0.x)
    k = x0.shape[0]
    centralized = params.centralized
    _, _, *sums = env._fused_pass(x0, params, centralized)
    u = env._expert_action(*sums, params)
    replay = torch.Generator(device=device)
    replay.set_state(gen_state)
    if isinstance(env, FlockingStochasticEnv):
        dt = env._draw_dt(replay, params, state0.x)[:k].cpu()
        x1 = env._integrate_scaled(x0, u, dt, params)
        replay.set_state(gen_state)
    else:
        x1 = env._rollout_integrate(x0, u, params, None)
    card_x1 = host_head(env.expert_rollout(state0, params, 1, generator=replay)[0].x)
    values, network = env._fused_pass(card_x1, params, centralized)[:2]
    absolute = isinstance(env, FlockingAbsoluteEnv)
    return {
        "u_err": hold("first action", traj["u"][:k, 0], u, U_ATOL, "abs"),
        "x_err": hold("first state", card_x1, x1, STATE_ATOL, "abs"),
        "values_err": hold("first observation", traj["values"][:k, 0], values,
                           STATE_ATOL if absolute else SUM_TOL, "abs" if absolute else "rel"),
        "network_err": hold("first network", traj["network"][:k, 0], network, NETWORK_ATOL,
                            "abs"),
        "reward_err": hold("first reward", traj["reward"][:k, 0], _instant_cost(card_x1),
                           U_ATOL, "abs"),
    }


def phase_flocking_variants(device: str, variants, n_steps: int) -> dict:
    """Phase 21: each flocking variant's reset and fused expert rollout; K1
    once a reset draw (none for the deterministic resets), and held to its
    plain version on the reset's state."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.flocking import FlockingRelativeEnv
    from gym_flock_tpu_torch.ops import dense_flocking as k6
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    from gym_flock_tpu_torch.ops import step_tail as k8

    out = {"k1_launches": 0, "k6_launches": 0, "k8_launches": 0,
           "k1_vs_plain": {"rel": 0.0, "ulp9": 0, "abs": 0.0}}
    for env_id, n_envs in variants:
        env, params = gft.make(env_id)
        gen = torch.Generator(device=device).manual_seed(SEED)
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        state0, obs0 = env.reset_env(gen, params, n_envs)
        _sync()
        reset_s = time.perf_counter() - t0
        gen_state = gen.get_state()
        t1 = time.perf_counter()
        final, traj = env.expert_rollout(state0, params, n_steps, generator=gen)
        _sync()
        roll_s = time.perf_counter() - t1
        launches, tries = k1.launches, env.last_reset_tries
        if launches != tries or launch_total() != launches:
            raise AssertionError(f"{env_id}: K1 {launches} launches ({launch_total()} in all) "
                                 f"for {tries} reset draws")
        # the dense-network variants' pass is K6, once a pass
        dense = type(env)._fused_pass is FlockingRelativeEnv._fused_pass
        k6_launches = k6.launches
        if k6_launches != (n_steps + 1 if dense else 0):
            raise AssertionError(f"{env_id}: K6 {k6_launches} launches in {n_steps} steps")
        out["k6_launches"] += k6_launches
        # the step tail is K8 once a step, but where a variant has its own
        fused_tail = type(env)._rollout_tail is FlockingRelativeEnv._rollout_tail
        k8_launches = k8.launches
        if k8_launches != (n_steps if fused_tail else 0):
            raise AssertionError(f"{env_id}: K8 {k8_launches} launches in {n_steps} steps")
        out["k8_launches"] += k8_launches
        check_all_finite(env_id, final.x, *obs0, *traj.values())
        first = flocking_first_step_on_host(env, params, state0, traj, gen_state, device)
        if launches:
            err = k1_reset_check(state0.x, params.comm_radius, params.comm_radius2)
            out["k1_vs_plain"] = {k: max(v, err[k]) for k, v in out["k1_vs_plain"].items()}
        out["k1_launches"] += launches
        out[env_id] = {"B": n_envs, "N": params.n_agents, "k1_launches": launches,
                       "k6_launches": k6_launches, "k8_launches": k8_launches,
                       "reset_tries": tries, "reset_ms": reset_s * 1e3,
                       "ms_a_step": roll_s * 1e3 / n_steps,
                       "env_steps_per_s": n_envs * n_steps / roll_s,
                       "mean_reward": float(traj["reward"].mean()), "first_step": first}
        del state0, obs0, final, traj
    if out["k1_launches"] == 0:
        raise AssertionError("no flocking variant's reset ran on K1")
    return out


def bearings_clear(x, n_shepherds: int, margin: float = 1e-4):
    """``[B]`` bool: no shepherd's bearing difference to a sheep, a shepherd or
    the goal lies within ``margin`` rad of 2 or 5 degrees, where an ulp of
    ``atan2`` could flip a line-of-sight branch."""
    import torch

    x = x.double()
    sx = x[:, :n_shepherds]
    targets = torch.cat((x[..., :2], torch.zeros_like(x[:, :1, :2])), dim=1)
    d = targets[:, None, :, :] - sx[:, :, None, :2]
    ang = torch.atan2(d[..., 1], d[..., 0]) - sx[..., 2, None]
    ang = torch.atan2(torch.sin(ang), torch.cos(ang)).abs()
    near = torch.stack([(ang - math.radians(t)).abs().amin(dim=(1, 2)) for t in (2.0, 5.0)])
    return (near > margin).all(dim=0)


def phase_shepherding(device: str, n_envs: int, n_steps: int) -> dict:
    """Phase 22: Shepherding-v0's reset and expert steps (no kernel on this
    path); the first step's LoS branches, action and step held to the host."""
    import torch

    import gym_flock_tpu_torch as gft

    env, params = gft.make("Shepherding-v0")
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    state0, _ = env.reset_env(gen, params, n_envs)
    _sync()
    reset_s = time.perf_counter() - t0
    state, rewards = state0, []
    t1 = time.perf_counter()
    for t in range(n_steps):
        u = env.controller(state, params)
        state, obs, r, _, _ = env.step_env(gen, state, u, params)
        if t == 0:
            u0, first = u, (state, obs, r)
        rewards.append(r)
    _sync()
    steps_s = time.perf_counter() - t1
    if launch_total() != 0:
        raise AssertionError(f"{launch_total()} kernel launches on a path that runs none")
    rewards = torch.stack(rewards, dim=1)
    check_all_finite("Shepherding-v0", state.x, rewards, *obs)

    s0 = host_head(state0)
    clear = bearings_clear(s0.x, params.n_shepherds)
    if int(clear.sum()) < s0.x.shape[0] // 2:
        raise AssertionError(f"only {int(clear.sum())} reset states clear of the LoS thresholds")
    card_branches = host_head(env.los_branches(state0, params))
    hold("LoS branches", card_branches[clear], env.los_branches(s0, params)[clear], 0, "exact")
    u_host = env.controller(s0, params)
    st, *_ = env.step_env(None, s0, host_head(u0), params)
    # the observation and reward at the card's new state
    c1, (c_values, c_adj), c_r = host_head(first)
    values, adj = env._obs(c1, params)
    r = env._instant_cost(c1.x, params)
    hold("adjacency support", c_adj > 0, adj > 0, 0, "exact")
    return {
        "B": n_envs, "reset_ms": reset_s * 1e3, "ms_a_step": steps_s * 1e3 / n_steps,
        "env_steps_per_s": n_envs * n_steps / steps_s, "kernel_launches": 0,
        "reset_branch_counts": torch.bincount(card_branches.flatten(), minlength=4).tolist(),
        "envs_clear_of_thresholds": int(clear.sum()),
        "first_step": {
            "u_err": hold("expert action", host_head(u0)[clear], u_host[clear], U_ATOL, "abs"),
            "x_err": hold("state", c1.x, st.x, STATE_ATOL, "abs"),
            "values_err": hold("observed values", c_values, values, STATE_ATOL, "abs"),
            "adjacency_rel": hold("1/r adjacency", c_adj, adj, SUM_TOL),
            "reward_err": hold("reward", c_r, r, U_ATOL, "abs"),
        },
        "mean_reward_last_step": float(rewards[:, -1].mean()),
    }


def phase_formation_lqr(device: str, n_formation: int, n_lqr: int, n_steps: int) -> dict:
    """Phase 23: FormationFlying-v0 and LQR-v0 under random actions, then
    LQR's expert (no kernel on these paths); the first steps held to the
    host, the card's LQR system to the host's build."""
    import dataclasses

    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.lqr import build_lqr_system

    out = {}
    # --- FormationFlying-v0, random actions
    env, params = gft.make("FormationFlying-v0")
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    state0, _ = env.reset_env(gen, params, n_formation)
    state = state0
    for t in range(n_steps):
        a = env.action_space(params).sample(gen, (n_formation,))
        state, obs, r, _, _ = env.step_env(gen, state, a, params)
        if t == 0:
            a0, first = a, (state.x, r)
    _sync()
    form_s = time.perf_counter() - t0
    check_all_finite("FormationFlying-v0", state.x, r)
    s0 = host_head(state0)
    st, _, r_host, _, _ = env.step_env(None, s0, host_head(a0), params)
    out["FormationFlying-v0"] = {
        "B": n_formation, "ms_a_step": form_s * 1e3 / n_steps,
        "env_steps_per_s": n_formation * n_steps / form_s,
        "first_step": {
            "x_err": hold("formation state", host_head(first[0]), st.x, STATE_ATOL, "abs"),
            "reward_err": hold("formation reward", host_head(first[1]), r_host, U_ATOL, "abs"),
            "connectivity": hold("connectivity", host_head(env.connectivity(state0, params)),
                                 env.connectivity(s0, params), 0, "exact"),
        }}

    # --- LQR-v0: the system built on the card, random actions, the expert
    _sync()
    t0 = time.perf_counter()
    env, params = gft.make("LQR-v0", device=device)
    _sync()
    build_s = time.perf_counter() - t0
    host_sys = build_lqr_system(params, 0, "cpu")
    system_err = {}
    for name in ("a_net", "a_sys", "b_sys", "q_sys", "k_gain"):
        card, host = getattr(params.system, name).cpu().double(), getattr(host_sys, name).double()
        system_err[name] = float((card - host).abs().max() / host.abs().max())
        if not system_err[name] <= LQR_SYSTEM_TOL:
            raise AssertionError(f"LQR {name} built on the card differs from the host's by "
                                 f"{system_err[name]:.3e} of its largest entry")
    quiet = dataclasses.replace(params, system=dataclasses.replace(
        params.system, std_dev=torch.zeros_like(params.system.std_dev)))
    quiet_host = host_head(quiet, None)
    gen = torch.Generator(device=device).manual_seed(SEED)
    res = {"B": n_lqr, "system_build_s": build_s, "system_rel_err": system_err}
    for policy in ("random", "expert"):
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        state0, _ = env.reset_env(gen, params, n_lqr)
        state, rewards = state0, []
        for t in range(n_steps):
            if policy == "random":
                a = env.action_space(params).sample(gen, (n_lqr,))
            else:
                a = env.controller(state, params)
            if t == 0:
                a0 = a
            state, obs, r, _, _ = env.step_env(gen, state, a, params)
            rewards.append(r)
        _sync()
        seconds = time.perf_counter() - t0
        if launch_total() != 0:
            raise AssertionError(f"{launch_total()} kernel launches on a path that runs none")
        check_all_finite(f"LQR-v0 {policy}", state.x, *rewards)
        # the first step without its noise, on the card and on the host
        card = env.step_env(gen, state0, a0, quiet)
        host = env.step_env(torch.Generator(), host_head(state0), host_head(a0), quiet_host)
        first = {"x_rel": hold(f"LQR {policy} state", host_head(card[0].x), host[0].x,
                               LQR_STEP_TOL),
                 "reward_rel": hold(f"LQR {policy} reward", host_head(card[2]), host[2],
                                    SUM_TOL)}
        if policy == "expert":
            first["u_rel"] = hold("LQR expert", host_head(a0),
                                  env.controller(host_head(state0), quiet_host), LQR_STEP_TOL)
        res[policy] = {"ms_a_step": seconds * 1e3 / n_steps,
                       "env_steps_per_s": n_lqr * n_steps / seconds,
                       "mean_reward": float(torch.stack(rewards).mean()), "first_step": first}
    if not res["expert"]["mean_reward"] > res["random"]["mean_reward"]:
        raise AssertionError("the LQR expert's cost is not below random actions'")
    out["LQR-v0"] = res
    return out


def mapping_first_step_on_host(env, params, state0, u0, first, k: int) -> dict:
    """The selection pass at the first envs of ``state0``, and at the card's
    state after the first step, on the host, held to the card: indices,
    masks and credit exactly; the step's state and reward from the host's
    own step within the CPU tests' tolerances."""
    from gym_flock_tpu_torch.envs.mapping import _mapping_helpers

    host_params = host_head(params, None)
    s0 = host_head(state0, k)
    card = _mapping_helpers(state0.x[:k], state0.unobserved[:k], params)
    host = _mapping_helpers(s0.x, s0.unobserved, host_params)
    for i, what in enumerate(("values", "network", "target table", "newly", "credit")):
        hold(f"mapping {what} at the reset state", card[i], host[i], 0, "exact")
    st, _, r, done, _ = env.step_env(None, s0, host_head(u0, k), host_params)
    c_state, (c_values, c_network), c_r, c_done = host_head(first, k)
    values, network, obs_target, newly, _ = _mapping_helpers(c_state.x, s0.unobserved,
                                                             host_params)
    hold("mapping observation after a step", c_values, values, 0, "exact")
    hold("mapping network after a step", c_network, network, 0, "exact")
    hold("mapping target table after a step", c_state.last_obs_target, obs_target, 0, "exact")
    hold("mapping unobserved after a step", c_state.unobserved, s0.unobserved & ~newly, 0,
         "exact")
    hold("mapping done", c_done, done, 0, "exact")
    return {
        "x_err": hold("mapping state", c_state.x, st.x, STATE_ATOL, "abs"),
        "reward_err": hold("mapping reward", c_r, r, U_ATOL, "abs"),
    }


def drive_mapping(device: str, env_id: str, n_envs: int, n_steps: int, host_envs: int) -> dict:
    """One mapping id: reset, ``n_steps`` greedy expert steps (the random
    index for MappingDisc-v0's zeros expert is its nearest target)."""
    import torch

    import gym_flock_tpu_torch as gft

    env, params = gft.make(env_id, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    state0, _ = env.reset_env(gen, params, n_envs)
    _sync()
    reset_s = time.perf_counter() - t0
    state, observed = state0, 0
    t1 = time.perf_counter()
    for t in range(n_steps):
        u = env.controller(state, params)
        before = state.unobserved
        state, obs, r, done, _ = env.step_env(gen, state, u, params)
        if t == 0:
            u0, first = u, (state, obs, r, done)
        observed += int((before & ~state.unobserved).sum())
    _sync()
    steps_s = time.perf_counter() - t1
    if launch_total() != 0:
        raise AssertionError(f"{launch_total()} kernel launches on a path that runs none")
    check_all_finite(env_id, state.x, state.last_obs_target, r, *obs)
    return {"B": n_envs, "N": params.n_agents, "T": params.n_targets,
            "reset_ms": reset_s * 1e3, "ms_a_step": steps_s * 1e3 / n_steps,
            "env_steps_per_s": n_envs * n_steps / steps_s, "targets_observed": observed,
            "first_step": mapping_first_step_on_host(env, params, state0, u0, first,
                                                     host_envs)}


def phase_mapping(device: str, n_envs: int, n_steps: int, n_others: int,
                  other_steps: int) -> dict:
    """Phase 24: Mapping-v0 with the greedy expert at bench metric 8's size,
    and the other three mapping ids a few steps each (no kernel on these
    paths)."""
    out = {"Mapping-v0": drive_mapping(device, "Mapping-v0", n_envs, n_steps, host_envs=4)}
    if out["Mapping-v0"]["targets_observed"] == 0:
        raise AssertionError("the greedy expert observed no target")
    for env_id in MAPPING_OTHERS:
        out[env_id] = drive_mapping(device, env_id, n_others, other_steps, host_envs=CPU_ENVS)
    return out


def phase_flocking_multi(device: str, n_envs: int, n_steps: int) -> dict:
    """Phase 25: FlockingMulti-v0's reset (K1 once a draw) and consensus
    expert steps (K2 once a chunk of 8 pooled features of each aggregation:
    the reset's and one a step); K1 and K2 on the reset's state held to
    their plain versions; the first step, without its noise, held to the
    host; K1 and K2 timed at this shape."""
    import dataclasses

    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.flocking_multi import _aggregate
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    env, params = gft.make("FlockingMulti-v0")
    pooled = params.nx * (params.filter_len - 1)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    state0, _ = env.reset_env(gen, params, n_envs)
    _sync()
    reset_s = time.perf_counter() - t0
    state, rewards = state0, []
    t1 = time.perf_counter()
    for t in range(n_steps):
        u = env.controller(state, params)
        state, obs, r, _, _ = env.step_env(gen, state, u, params)
        if t == 0:
            u0 = u
        rewards.append(r)
    _sync()
    steps_s = time.perf_counter() - t1
    k1_launches, k2_launches, tries = k1.launches, k2.launches, env.last_reset_tries
    if k1_launches != tries or k2_launches != k2.launches_for(pooled) * (n_steps + 1):
        raise AssertionError(f"K1 {k1_launches} launches for {tries} reset draws, K2 "
                             f"{k2_launches} for {n_steps + 1} aggregations of {pooled} "
                             f"features")
    if launch_total() != k1_launches + k2_launches:
        raise AssertionError("launches of another kernel on FlockingMulti's path")
    check_all_finite("FlockingMulti-v0", state.x, state.x_agg, obs, *rewards)

    # K1 on the reset's state, and K2 on the reset's buffer as the next
    # aggregation reads it, against their plain versions: the degrees
    # exactly, K2's sums and pooled features within ADJ_TOL
    x0 = state0.x
    k1_err = k1_reset_check(x0, params.comm_radius, params.comm_radius2)
    err = AdjErrors()
    h = state0.x_agg[..., :pooled].contiguous()
    out, deg = k2.adjacency_matmul_block(x0, x0, h, 0, 0, params.comm_radius2)
    p_out, p_deg = k2.adjacency_matmul_block_reference(x0, x0, h, 0, 0, params.comm_radius2)
    compare_deg(deg, p_deg)
    err.check(out, p_out)
    err.check(k2.adjacency_matmul(x0, h, params.comm_radius2),
              plain_adjacency_matmul(x0, h, params.comm_radius2, True))

    # the first step without its noise, on the card and on the host
    quiet = dataclasses.replace(params, std_dev=0.0)
    card = env.step_env(gen, state0, u0, quiet)
    host = env.step_env(torch.Generator(), host_head(state0), host_head(u0), quiet)
    c1 = host_head(card[0])
    s0 = host_head(state0)
    first = {
        "u_err": hold("consensus action", host_head(u0), env.controller(s0, params), U_ATOL,
                      "abs"),
        "x_err": hold("state", c1.x, host[0].x, STATE_ATOL, "abs"),
        # the host's aggregation at the card's new positions
        "x_agg_rel": hold("aggregation buffer", c1.x_agg,
                          _aggregate(c1.x, s0.x_agg, s0.init_vel, params), ADJ_TOL),
        "reward_err": hold("reward", host_head(card[2]), host[2], U_ATOL, "abs"),
    }
    return {
        "B": n_envs, "N": params.n_agents, "k1_launches": k1_launches,
        "k2_launches": k2_launches, "reset_tries": tries, "reset_ms": reset_s * 1e3,
        "ms_a_step": steps_s * 1e3 / n_steps, "env_steps_per_s": n_envs * n_steps / steps_s,
        "mean_degree": float(p_deg.mean()),
        "aggregation_vs_plain": {"rel": err.rel, "abs": err.abs}, "k1_vs_plain": k1_err,
        "first_step": first, "mean_reward": float(torch.stack(rewards).mean()),
        "k2_timing": k2_timing(f"FlockingMulti B={n_envs} N={params.n_agents} F={pooled}",
                               x0, x0, h, 0, 0, plain=True),
        "k1_timing": k1_timing(x0, params.comm_radius, params.comm_radius2, "full", plain=True),
    }


# --------------------------------------------------------------------------
# Phases 26-28: the coverage flag modes and the bank's disk format, the gym
# facades, the AirSim bridges
# --------------------------------------------------------------------------

FLAG_STEPS = 16
FLAG_ENVS = 1024
FEAT_ATOL = 1e-6  # an edge feature of the card's first step against the host's
ALL_FLAGS = dict(comm_edges=True, pos_delta=True, last_edge_feature=True, revisit_nodes=True)
LEGACY_STEPS = 1500  # controller()/step() pairs of bench metrics 9-11's loop
# the reference's single-stream CPU rates that bench.py:37-42 quotes (BASELINE.md)
LEGACY_BASELINES = {"FlockingRelative-v0": 835.0, "Coverage-v0": 2381.0,
                    "CoverageARL-v0": 176.0}
LEGACY_IDS = (("FlockingRelative-v0", {}), ("Coverage-v0", {}),
              ("CoverageARL-v0", {"real_map": True}))
BRIDGE_STEPS = 20
BRIDGE_U_ATOL = 1e-5  # the card's Turner action against the host's


def coverage_obs_on_host(what: str, got: dict, want: dict) -> float:
    """The card's coverage observation against the host's: indices, nodes
    and the step exactly, edge features within FEAT_ATOL; returns the
    largest edge error."""
    for k in ("senders", "receivers", "nodes", "step"):
        hold(f"{what} {k}", got[k], want[k], 0, "exact")
    return hold(f"{what} edges", got["edges"], want["edges"], FEAT_ATOL, "abs")


def drive_flag_env(device: str, env_id: str, flags: dict, n_envs: int, n_steps: int) -> dict:
    """One flag-mode env: reset and ``n_steps`` greedy expert steps on the
    card (K5 exactly once a step), the first step repeated on the host with
    the plain K5 from the same state, the same random actions and (under
    ``revisit_nodes``) the card's flip draw replayed, not drawn; every
    step's revisit flips replayed and held to the state's changes."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs import coverage as cov

    t0 = time.perf_counter()
    env, params = gft.make(env_id, device=device, real_map=True, **flags)
    _sync()
    make_s = time.perf_counter() - t0
    b, r, t = n_envs, params.n_robots, params.max_targets
    gen = torch.Generator(device=device).manual_seed(SEED)
    state0, _ = env.reset_env(gen, params, b)
    _sync()
    reset_counts()
    state = state0
    g_ctrl, g_step, visited_before, visited_after, locs, us = [], [], [], [], [], []
    obs1 = None
    t1 = time.perf_counter()
    for _ in range(n_steps):
        g_ctrl.append(gen.get_state())
        u = env.controller(state, params, gen)
        g_step.append(gen.get_state())
        visited_before.append(state.visited)
        state, obs, reward, done, _ = env.step_env(gen, state, u, params)
        visited_after.append(state.visited)
        locs.append(state.robot_loc)
        us.append(u)
        if obs1 is None:
            obs1 = obs
    _sync()
    steps_s = time.perf_counter() - t1
    launches = check_k5_count(f"{env_id} flag modes", n_steps)
    if launch_total() != launches:
        raise AssertionError(f"{env_id}: another kernel launched ({launch_total()} in all)")
    check_all_finite(env_id, *obs1.values(), state.visited, state.episode_reward)
    e = params.max_edges
    if tuple(obs1["edges"].shape) != (b, e, params.n_edge_feat):
        raise AssertionError(f"{env_id}: edges of shape {tuple(obs1['edges'].shape)}")

    # the first step on the host, first CPU_ENVS envs: the plain K5 (CPU
    # tensors), the card's random draws replayed
    k = CPU_ENVS
    hp = host_head(params, None)
    h0 = host_head(state0, k)
    replay = torch.Generator(device=device)
    replay.set_state(g_ctrl[0])
    rand_u = torch.randint(0, params.n_actions, (b, r), generator=replay, device=device,
                           dtype=torch.int32)
    u_host = env.controller(h0, hp, rand_u=rand_u[:k].cpu())
    hold(f"{env_id} first actions", us[0][:k], u_host, 0, "exact")
    flip = None
    if params.revisit_nodes:
        replay.set_state(g_step[0])
        flip = cov.revisit_flips(replay, b, t)[:k].cpu()
    h1, obs_h, reward_h, _, _ = env.step_env(None, h0, u_host, hp, flip=flip)
    edge_err = coverage_obs_on_host(f"{env_id} first step", host_head(obs1, k), obs_h)
    hold(f"{env_id} first visited", visited_after[0][:k], h1.visited, 0, "exact")

    out = {"B": b, "R": r, "T": t, "E": e, "n_edge_feat": params.n_edge_feat,
           "flags": sorted(f for f, on in flags.items() if on), "k5_launches": launches,
           "make_seconds": make_s, "ms_a_step": steps_s * 1e3 / n_steps,
           "env_steps_per_s": b * n_steps / steps_s, "first_step_edge_err": edge_err,
           "mean_reward": float(state.episode_reward.mean()) / n_steps}
    if params.comm_edges:
        s, rc = obs1["senders"], obs1["receivers"]
        comm = ((s >= 0) & (s < r) & (rc >= 0) & (rc < r)).sum(1)
        out["comm_edges_a_step"] = [int(comm.min()), int(comm.max())]
    if params.revisit_nodes:
        mask = params.bank["target_mask"][state0.graph.long()]
        n_flips = n_reverted = 0
        for step in range(n_steps):
            replay.set_state(g_step[step])
            flip = cov.revisit_flips(replay, b, t)
            want = torch.where(flip & mask, 0.0, visited_before[step]).scatter(
                1, locs[step].long(), 1.0)
            hold(f"revisit step {step}", visited_after[step], want, 0, "exact")
            reverted = (visited_before[step] == 1) & (visited_after[step] == 0)
            if bool((reverted & ~(flip & mask)).any()):
                raise AssertionError(f"step {step}: a target reverted off mask & flip")
            n_flips += int(flip.sum())
            n_reverted += int(reverted.sum())
        n = b * t * n_steps
        p = cov.REVISIT_P
        sigma = math.sqrt(n * p * (1 - p))
        if not abs(n_flips - n * p) < 5 * sigma:
            raise AssertionError(f"{n_flips} flips in {n} draws: rate {n_flips / n} not "
                                 f"{p} within 5 sigma")
        out.update(flip_draws=n, flips=n_flips, flip_rate=n_flips / n,
                   flip_sigmas=(n_flips - n * p) / sigma, reverted=n_reverted)
    return out


def make_building(device: str, env_id: str, **kwargs):
    """``make(env_id)`` when its bank is not cached: ``(env, params, build
    seconds, seconds of the bank's write to the disk cache)``, the build's
    time being the ``make``'s without the write."""
    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.coverage import last_bank_timing

    t0 = time.perf_counter()
    env, params = gft.make(env_id, device=device, **kwargs)
    _sync()
    make_s = time.perf_counter() - t0
    if last_bank_timing.get("source") != "build":
        raise AssertionError(f"{env_id}'s bank was not built: {last_bank_timing}")
    write_s = last_bank_timing["write_seconds"]
    return env, params, make_s - write_s, write_s


def phase_flag_modes(device: str, x_bank, x_build_s: float, x_write_s: float) -> dict:
    """Phase 26: CoverageARL-v0 with all four flags and ExploreEnv-v0
    (hide_nodes) with comm_edges, pos_delta and last_edge_feature on the
    real map; then phase 6's ExploreFull bank saved to a temporary
    directory and loaded back onto the card (held equal key by key), and
    the disk cache's read of the same bank timed against its build."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs import coverage as cov
    from gym_flock_tpu_torch.envs import coverage_graph as cg

    out = {
        "CoverageARL-v0": drive_flag_env(device, "CoverageARL-v0", ALL_FLAGS, FLAG_ENVS,
                                         FLAG_STEPS),
        "ExploreEnv-v0": drive_flag_env(
            device, "ExploreEnv-v0", dict(comm_edges=True, pos_delta=True,
                                          last_edge_feature=True), FLAG_ENVS, FLAG_STEPS),
    }
    out["k5_launches"] = sum(v["k5_launches"] for v in out.values())
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "explore_full.npz")
        t0 = time.perf_counter()
        cg.save_graph_bank(path, x_bank)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = cg.load_graph_bank(path, device=device)
        _sync()
        load_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
    if set(loaded) != set(x_bank):
        raise AssertionError(f"loaded keys {sorted(set(loaded) ^ set(x_bank))} differ")
    for key, v in x_bank.items():
        if loaded[key].dtype != v.dtype or not torch.equal(loaded[key], v):
            raise AssertionError(f"loaded bank differs at {key}")
    # the disk cache, as a second process finds it: the memo emptied
    cov._bank_cache.clear()
    t0 = time.perf_counter()
    _, again = gft.make("ExploreFullEnv-v0", device=device, real_map=True)
    _sync()
    cache_s = time.perf_counter() - t0
    for key, v in x_bank.items():
        if not torch.equal(again.bank[key], v):
            raise AssertionError(f"the disk cache's bank differs at {key}")
    out["explore_full_bank"] = {
        "keys": len(x_bank), "build_seconds": x_build_s,
        "cache_write_seconds": x_write_s, "save_seconds": save_s,
        "load_seconds": load_s, "file_MB": size / 1e6,
        "make_from_disk_cache_seconds": cache_s, "cache_dir": str(cov.bank_cache_dir())}
    return out


def first_step_equal(what: str, facade_step, env, params, state, gen, action, batched: bool):
    """``facade_step(action)``, its observation held to ``step_env`` run on
    the card from the same state and generator state (exactly: the same
    operations on the same inputs); returns the facade's result."""
    import torch

    from gym_flock_tpu_torch.compat.gym_api import fetch

    g0 = gen.get_state()
    result = facade_step(action)
    replay = torch.Generator(device=gen.device)
    replay.set_state(g0)
    a = torch.as_tensor(np.asarray(action)).to(device=gen.device,
                                               dtype=env.action_space(params).dtype)
    _, want, _, _, _ = env.step_env(replay, state, a if batched else a[None], params)
    want, got = fetch(want), result[0]
    keys = list(want) if isinstance(want, dict) else range(len(want))
    for k in keys:
        if not np.array_equal(np.asarray(got[k]).reshape(want[k].shape), want[k]):
            raise AssertionError(f"{what}: the first step's obs[{k!r}] differs from step_env's")
    return result


def legacy_loop(device: str, env_id: str, n_steps: int, flush: bool = False,
                record: list | None = None, **kwargs) -> dict:
    """Bench metrics 9-11's loop: ``u = env.controller(); env.step(u)``
    ``n_steps`` times on a ``make_legacy`` env (coverage ids greedy and
    wrapped in ``FlattenDictWrapper``, as reference test.py:33), resetting
    where an episode ends.  With ``flush`` the facade's lookahead queue is
    flushed after every controller call (the eager path: each controller
    call computed alone, each step as it comes); ``record`` collects every
    step's and reset's result.  K1 must launch once per reset draw and K5
    once per evaluation of the greedy controller, queued or alone."""
    from gym_flock_tpu_torch.compat import FlattenDictWrapper, make_legacy
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5

    legacy = make_legacy(env_id, device=device, **kwargs)
    coverage = env_id.startswith("Coverage")
    env = FlattenDictWrapper(legacy) if coverage else legacy
    record = [] if record is None else record
    legacy.seed(SEED)
    _sync()
    reset_counts()
    tries = resets = depth = 0
    reset_xs = []

    def reset():
        nonlocal tries, resets
        obs = env.reset()
        resets += 1
        tries += getattr(legacy.env, "last_reset_tries", 0)
        if not coverage:
            reset_xs.append(legacy.state.x)
        record.append(obs)

    def controller():
        nonlocal depth
        u = legacy.controller(greedy=True) if coverage else legacy.controller()
        depth = max(depth, len(legacy._queue))
        if flush:
            legacy._flush_queue()
        return u

    t0 = time.perf_counter()
    reset()
    reset_s = time.perf_counter() - t0
    # the first pair, held to the env's functions from the same state
    state, gen = legacy.state, legacy._gen
    u = controller()
    record.append(first_step_equal(env_id, legacy.step, legacy.env, legacy.params, state,
                                   gen, u, batched=False)[:3])
    steps, rewards = 1, 0.0
    t1 = time.perf_counter()
    while steps < n_steps:
        u = controller()
        obs, r, done, _ = env.step(u)
        record.append((obs, r, done))
        rewards += r
        steps += 1
        if done:
            reset()
    _sync()
    loop_s = time.perf_counter() - t1
    k1_launches, k5_launches = k1.launches, k5.launches
    evals = legacy.controller_evals if coverage else 0
    if k1_launches != tries or k5_launches != evals:
        raise AssertionError(f"{env_id} legacy: K1 {k1_launches} for {tries} reset draws, "
                             f"K5 {k5_launches} for {evals} greedy controller evaluations")
    if not math.isfinite(rewards):
        raise AssertionError(f"{env_id} legacy: non-finite rewards")
    rate = (n_steps - 1) / loop_s
    out = {"legacy": legacy}
    if not coverage:
        # K1 at this loop's own shape (B=1, N=100) on every accepted reset
        # draw, after the counts were read
        p = legacy.params
        err = {"rel": 0.0, "ulp9": 0, "abs": 0.0}
        for x in reset_xs:
            e = k1_reset_check(x, p.comm_radius, p.comm_radius2)
            err = {k: max(v, e[k]) for k, v in err.items()}
        out |= {"k1_grid_b1": k1.launch_grid(1, p.n_agents, p.n_agents),
                "k1_checked_resets": len(reset_xs), "k1_vs_plain": err}
    return out | {"pairs": n_steps, "resets": resets, "reset_draws": tries,
                  "k1_launches": k1_launches, "k5_launches": k5_launches,
                  "computed_pairs": legacy.computed_pairs,
                  "controller_evals": legacy.controller_evals, "depth": depth,
                  "first_reset_ms": reset_s * 1e3, "ms_a_pair": loop_s * 1e3 / (n_steps - 1),
                  "steps_per_s": rate, "reference_cpu_steps_per_s": LEGACY_BASELINES[env_id],
                  "vs_reference": rate / LEGACY_BASELINES[env_id], "reward_sum": rewards}


def gymnasium_single(device: str) -> dict:
    """``make_gymnasium("FlockingRelative-v0")``: the time-driven family's
    done is truncation at the env's own limit and at the registration's,
    never terminal, as ``_done_semantics`` says."""
    from gym_flock_tpu_torch.compat import make_gymnasium
    from gym_flock_tpu_torch.compat.gymnasium_api import _done_semantics

    if _done_semantics("FlockingRelative-v0") != "time":
        raise AssertionError("FlockingRelative-v0 is not time-driven")
    out = {}
    for name, kw, limit in (("env_limit", dict(max_steps=5, max_episode_steps=1000), 5),
                            ("registration_limit", dict(max_episode_steps=7), 7)):
        env = make_gymnasium("FlockingRelative-v0", device=device, **kw)
        obs, _ = env.reset(seed=SEED)
        legacy = env.unwrapped
        flags = []
        first = True
        t0 = time.perf_counter()
        for _ in range(limit):
            u = env.controller()
            if first:
                step = first_step_equal("gymnasium", env.step, legacy.env, legacy.params,
                                        legacy.state, legacy._gen, u, batched=False)
                flags.append(step[2:4])
                first = False
            else:
                flags.append(env.step(u)[2:4])
        _sync()
        seconds = time.perf_counter() - t0
        want = [(False, False)] * (limit - 1) + [(False, True)]
        if flags != want:
            raise AssertionError(f"gymnasium {name}: (terminated, truncated) {flags}")
        out[name] = {"steps": limit, "ms_a_pair": seconds * 1e3 / limit}
    return out


def vector_flocking(device: str, n_envs: int, n_steps: int, limit: int) -> dict:
    """``make_gymnasium_vector("FlockingRelative-v0")`` with a time limit:
    every env truncates at once, so the batch is reset whole (K1 once a
    draw of each reset) and every row carries its final observation."""
    from gym_flock_tpu_torch.compat import make_gymnasium_vector
    from gym_flock_tpu_torch.ops import flocking_sums as k1

    venv = make_gymnasium_vector("FlockingRelative-v0", num_envs=n_envs, device=device,
                                 max_episode_steps=limit)
    env = venv._env
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    venv.reset(seed=SEED)
    tries, resets, autoresets = env.last_reset_tries, 1, 0
    reset_ms = (time.perf_counter() - t0) * 1e3
    step_ms, autoreset_ms = [], []
    for t in range(n_steps):
        u = venv.controller()
        t1 = time.perf_counter()
        if t == 0:
            obs, rew, term, trunc, infos = first_step_equal(
                "vector flocking", venv.step, env, venv.params, venv.state, venv._gen, u,
                batched=True)
        else:
            obs, rew, term, trunc, infos = venv.step(u)
        ms = (time.perf_counter() - t1) * 1e3
        if (term | trunc).any():
            autoresets += 1
            resets += 1
            tries += env.last_reset_tries
            autoreset_ms.append(ms)
            if term.any() or not trunc.all() or not infos["_final_observation"].all():
                raise AssertionError(f"step {t}: the time limit is truncation of every env")
            if infos["final_observation"][0][0].shape != (100, 6):
                raise AssertionError("final observation of the wrong shape")
        else:
            step_ms.append(ms)
        if not np.isfinite(rew).all() or obs[0].shape != (n_envs, 100, 6):
            raise AssertionError(f"step {t}: rewards or observation wrong")
    if autoresets != n_steps // limit or k1.launches != tries:
        raise AssertionError(f"{autoresets} autoresets, K1 {k1.launches} for {tries} draws")
    return {"B": n_envs, "steps": n_steps, "limit": limit, "resets": resets,
            "reset_draws": tries, "k1_launches": k1.launches, "reset_ms": reset_ms,
            "ms_a_step": statistics.median(step_ms),
            "ms_an_autoreset_step": autoreset_ms}


def vector_coverage(device: str, n_envs: int, n_steps: int) -> dict:
    """``make_gymnasium_vector("Coverage-v0")`` across the 75-step episode
    end, ``controller()`` on K5 once a call: terminated where the env is
    done (all at step 74, from the reset's counter of 1), truncated never
    (the registration's limit is 75 elapsed steps)."""
    from gym_flock_tpu_torch.compat import make_gymnasium_vector
    from gym_flock_tpu_torch.ops import rowmin as k5

    venv = make_gymnasium_vector("Coverage-v0", num_envs=n_envs, device=device)
    env = venv._env
    venv.reset(seed=SEED)
    _sync()
    reset_counts()
    step_ms, finished_at = [], []
    t0 = time.perf_counter()
    for t in range(n_steps):
        u = venv.controller()
        t1 = time.perf_counter()
        if t == 0:
            obs, rew, term, trunc, infos = first_step_equal(
                "vector coverage", venv.step, env, venv.params, venv.state, venv._gen, u,
                batched=True)
        else:
            obs, rew, term, trunc, infos = venv.step(u)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        mask = term | trunc
        if mask.any():
            finished_at.append((t, int(term.sum()), int(trunc.sum())))
            if not np.array_equal(infos["_final_observation"], mask):
                raise AssertionError(f"step {t}: final-observation mask is not term | trunc")
            i = int(np.nonzero(mask)[0][0])
            if float(obs["step"][i, 0, 0]) != 0.0:
                raise AssertionError(f"step {t}: a finished row is not a fresh episode")
        if not np.isfinite(rew).all():
            raise AssertionError(f"step {t}: non-finite rewards")
    _sync()
    seconds = time.perf_counter() - t0
    if k5.launches != n_steps:
        raise AssertionError(f"vector coverage: K5 {k5.launches} launches for {n_steps} calls")
    if not finished_at or any(tr for _, _, tr in finished_at):
        raise AssertionError(f"vector coverage: episode ends {finished_at}")
    return {"B": n_envs, "steps": n_steps, "k5_launches": k5.launches,
            "episode_ends": finished_at, "ms_a_step": statistics.median(step_ms),
            "max_step_ms": max(step_ms),
            "env_steps_per_s": n_envs * n_steps / seconds}


def phase_facades(device: str) -> dict:
    """Phase 27: the gym facades on the card."""
    out = {"legacy": {env_id: without_facade(legacy_loop(device, env_id, LEGACY_STEPS, **kw))
                      for env_id, kw in LEGACY_IDS}}
    out["gymnasium"] = gymnasium_single(device)
    out["vector_flocking"] = vector_flocking(device, n_envs=8192, n_steps=16, limit=8)
    out["vector_coverage"] = vector_coverage(device, n_envs=8192, n_steps=80)
    legacy = out["legacy"].values()
    out["k1_launches"] = (sum(v["k1_launches"] for v in legacy)
                          + out["vector_flocking"]["k1_launches"])
    out["k5_launches"] = (sum(v["k5_launches"] for v in legacy)
                          + out["vector_coverage"]["k5_launches"])
    return out


class _Future:
    def join(self):
        pass


class _Vec:
    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x_val, self.y_val, self.z_val = x, y, z


class FakeAirsimClient:
    """An AirSim MultirotorClient stand-in that records every command:
    velocity commands integrate, position commands teleport, tilt commands
    become an acceleration; each drone holds its own yaw."""

    def __init__(self, names):
        self.pos = {n: np.zeros(2) for n in names}
        self.vel = {n: np.zeros(2) for n in names}
        self.yaw = {n: 0.3 * i for i, n in enumerate(names)}
        self.calls = []

    def reset(self):
        self.calls.append(("reset",))

    def enableApiControl(self, flag, name):
        self.calls.append(("api", name))

    def armDisarm(self, flag, name):
        self.calls.append(("arm", name))

    def takeoffAsync(self, vehicle_name):
        self.calls.append(("takeoff", vehicle_name))
        return _Future()

    def moveToPositionAsync(self, x, y, z, speed, vehicle_name):
        self.calls.append(("position", vehicle_name, x, y, z, speed))
        self.pos[vehicle_name] = np.array([x, y])
        return _Future()

    def moveByVelocityZAsync(self, vx, vy, z, duration, vehicle_name):
        self.calls.append(("velocity", vehicle_name, vx, vy, z, duration))
        self.vel[vehicle_name] = np.array([vx, vy])
        self.pos[vehicle_name] = self.pos[vehicle_name] + duration * self.vel[vehicle_name]
        return _Future()

    def moveByAngleZAsync(self, pitch, roll, z, yaw, duration, vehicle_name):
        self.calls.append(("angle", vehicle_name, pitch, roll, z, yaw, duration))
        accel = 9.8 * np.array([-pitch, roll])
        self.vel[vehicle_name] = self.vel[vehicle_name] + accel * duration * 10
        self.pos[vehicle_name] = self.pos[vehicle_name] + self.vel[vehicle_name] * duration * 10
        return _Future()

    def getMultirotorState(self, vehicle_name):
        class S:
            pass

        s = S()
        s.kinematics_estimated = S()
        s.kinematics_estimated.position = _Vec(*self.pos[vehicle_name], 0.0)
        s.kinematics_estimated.linear_velocity = _Vec(*self.vel[vehicle_name], 0.0)
        yaw = self.yaw[vehicle_name]
        q = S()
        q.w_val, q.x_val, q.y_val, q.z_val = math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)
        s.kinematics_estimated.orientation = q
        return s


def same_calls(what: str, got, want) -> int:
    """The card bridge's client calls against the host bridge's, exactly."""
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got + [None], want + [None])) if g != w)
        raise AssertionError(f"{what}: call {bad} differs: {got[bad:bad + 1]} against "
                             f"{want[bad:bad + 1]}")
    return len(got)


def phase_bridges(device: str, n_steps: int) -> dict:
    """Phase 28: each AirSim bridge on the card and on the host, each with
    its own fake client, ``n_steps`` expert steps.  Both are stepped with
    the card's action, so the clients see the same physics: the commands
    must be equal call for call, and the host's expert within
    BRIDGE_U_ATOL (flocking) or exactly (coverage) of the card's."""
    import torch

    from gym_flock_tpu_torch.bridges import AirsimCoverageBridge, AirsimFlockingBridge
    from gym_flock_tpu_torch.compat import make_legacy

    names = [f"Drone{i}" for i in range(10)]
    home = np.stack([np.arange(10) * 2.0, np.zeros(10), np.zeros(10)], axis=1)
    clients = {d: FakeAirsimClient(names) for d in (device, "cpu")}
    bridges = {d: AirsimFlockingBridge(clients[d], names=names, home=home, device=d)
               for d in (device, "cpu")}
    for d, bridge in bridges.items():
        bridge.reset(np.random.RandomState(SEED))
    u_err = net_err = 0.0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        u = bridges[device].controller()
        u_err = max(u_err, hold("bridge Turner action", torch.from_numpy(u),
                                torch.from_numpy(bridges["cpu"].controller()),
                                BRIDGE_U_ATOL, "abs"))
        (_, net), r, _, _ = bridges[device].step(u)
        (_, net_h), r_h, _, _ = bridges["cpu"].step(u)
        net_err = max(net_err, hold("bridge network", torch.from_numpy(net),
                                    torch.from_numpy(net_h), NETWORK_ATOL, "abs"))
        if r != r_h:
            raise AssertionError("bridge rewards differ")
    flock_s = time.perf_counter() - t0
    flock_calls = same_calls("flocking bridge", clients[device].calls, clients["cpu"].calls)

    names6 = names[:6]
    home6 = home[:6]
    legacies = {d: make_legacy("Coverage-v0", device=d) for d in (device, "cpu")}
    clients = {d: FakeAirsimClient(names6) for d in (device, "cpu")}
    cov = {d: AirsimCoverageBridge(clients[d], legacies[d], names=names6, home=home6)
           for d in (device, "cpu")}
    legacies[device].seed(SEED)
    cov[device].reset()
    # the host bridge takes the card's reset state (the two generators'
    # streams differ) and flies to its start nodes as reset() does, so the
    # two clients see the same calls
    host = legacies["cpu"]
    host.reset()
    host._state = host_head(legacies[device].state, None)
    hb = cov["cpu"]
    hb.ops.client.reset()
    hb.ops.setup_drones()
    pos, _, cur = hb._graph()
    hb.ops.send_locations(pos[cur], hb.z)
    hb._sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        a = legacies[device].controller(greedy=True)
        if not np.array_equal(a, host.controller(greedy=True)):
            raise AssertionError("coverage bridge: the host's greedy action differs")
        obs, r, d, _ = cov[device].step(a)
        obs_h, r_h, d_h, _ = cov["cpu"].step(a)
        if (r, d) != (r_h, d_h) or any(not np.array_equal(obs[k], obs_h[k]) for k in obs):
            raise AssertionError("coverage bridge: the card's step differs from the host's")
    cov_s = time.perf_counter() - t0
    cov_calls = same_calls("coverage bridge", clients[device].calls, clients["cpu"].calls)
    return {"flocking": {"steps": n_steps, "client_calls": flock_calls,
                         "turner_err": u_err, "network_err": net_err,
                         "ms_a_step": flock_s * 1e3 / n_steps},
            "coverage": {"steps": n_steps, "client_calls": cov_calls,
                         "ms_a_step": cov_s * 1e3 / n_steps}}


# --------------------------------------------------------------------------
# Phases 29-33: scale-out over torch.distributed, and the parity mode
# --------------------------------------------------------------------------

RING_P = 4  # ranks whose ring of tiles phase 30 runs on one card
PARITY_STEPS = 50


def phase_process_group(device: str, store_dir: str) -> dict:
    """Phase 29: ``parallel.distributed.initialize`` on NCCL at world size 1
    (a ``file://`` rendezvous under ``store_dir``); a failure raises.  Times
    one all-reduce of the rollout's reward moments ([16, 4] f32) and one
    all-gather of FlockingLarge-v0's state ([16, 4096, 4] f32), whose
    backward must return the cotangent."""
    import torch
    import torch.distributed as dist

    from gym_flock_tpu_torch.parallel import distributed as tdist
    from gym_flock_tpu_torch.parallel.agent_shard import all_gather_agents

    # one process on one card: its loopback is the only rendezvous it needs
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    tdist.initialize("nccl", f"file://{store_dir}/nccl_store", world_size=1, rank=0,
                     timeout_s=300)
    moments = torch.ones(16, 4, device=device)
    dist.all_reduce(moments)
    _sync()
    init_s = time.perf_counter() - t0
    if (dist.get_backend(), dist.get_world_size(), dist.get_rank()) != ("nccl", 1, 0):
        raise AssertionError(f"process group {dist.get_backend()} "
                             f"{dist.get_world_size()} {dist.get_rank()}")
    if not torch.equal(moments, torch.ones_like(moments)):
        raise AssertionError("an all-reduce at world size 1 changed its tensor")
    state = torch.randn(16, 4096, 4, device=device, requires_grad=True)
    gathered = all_gather_agents(state)
    if not torch.equal(gathered, state):
        raise AssertionError("an all-gather at world size 1 is not its input")
    cotangent = torch.randn_like(state)
    gathered.backward(cotangent)  # a reduce-scatter of the cotangent
    if not torch.equal(state.grad, cotangent):
        raise AssertionError("an all-gather's backward at world size 1 is not its cotangent")
    state = state.detach()
    return {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "init_and_first_collective_s": init_s,
            "all_reduce_16x4_ms": time_ms(lambda: dist.all_reduce(moments)),
            "all_gather_16x4096x4_ms": time_ms(lambda: all_gather_agents(state))}


def large_reset_state(device: str, seed: int, n_envs: int = 16):
    """FlockingLarge-v0's registered params and a reset of ``n_envs`` swarms
    (the K1 launches of its draws are not the main path's)."""
    import torch

    import gym_flock_tpu_torch as gft

    env, params = gft.make("FlockingLarge-v0")
    state, _ = env.reset_env(torch.Generator(device=device).manual_seed(seed), params, n_envs)
    return env, params, state


def ring_order(p: int, rank: int):
    """The column blocks in the order rank ``rank``'s ring visits them."""
    return [(rank + s) % p for s in range(p)]


def hold_to_partials(what: str, got, want, parts, tol: float) -> dict:
    """Hold a sum of partial sums ``parts`` (summed in f32, as a ring combines
    them) to ``want`` (one pass over the whole swarm): |k - p| within ``tol``
    of 1 + the sum of the partials' magnitudes, the f32 rounding their
    combination can reach where they cancel.  Returns that measure and the
    usual max |k - p| / (1 + |p|)."""
    magnitude = sum(q.abs() for q in parts)
    diff = (got - want).abs()
    err = float((diff / (1.0 + magnitude)).max())
    if not err < tol:
        raise AssertionError(f"{what}: max |k-p|/(1+sum|parts|) = {err:.3e} >= {tol}")
    return {"rel_to_partials": err, "rel": float((diff / (1.0 + want.abs())).max())}


def phase_ring_tiles(device: str, p: int) -> dict:
    """Phase 30: the ring's tiles at P=``p`` on one card, on FlockingLarge-v0's
    reset state (B=16, N=4096, m=N/p).  K1 over the p x p (rank, source)
    pairs with their global offsets, each rank's parts combined by
    ``agent_shard.combine_ring_parts``: held to the plain version's tiles
    combined alike ("core" and "full": the degree exactly, channel 9 within
    1 ulp, the sums max |k-p|/(1+|p|) < 1e-4), and to one pass over the
    whole swarm (the degree and channel 9 alike, the sums within
    RING_TOL of 1 + their partials' magnitudes, ``hold_to_partials``); the
    all-gather mode's [m, N] tiles (whole rows) to unsharded K1 and its plain version
    as phase 3 holds them.  Then K2's p x p tiles at F=6 summed in ring
    order, raw and mean-pooled, and their backward (the swapped tiles), to
    the plain version's tiles composed alike (the degree exactly, 1e-6) and
    the sums to the whole swarm's as above."""
    import torch

    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.parallel.agent_shard import combine_ring_parts

    _, params, state = large_reset_state(device, SEED + 30)
    x = state.x
    b, n, _ = x.shape
    m = n // p
    cr, cr2 = params.comm_radius, params.comm_radius2
    blocks = [x[:, r * m:(r + 1) * m].contiguous() for r in range(p)]
    worst = {"rel": 0.0, "ulp9": 0, "abs": 0.0}
    to_whole = {"rel_to_partials": 0.0, "rel": 0.0}

    def note(err):
        for k in worst:
            worst[k] = max(worst[k], err[k])

    def ring_parts(fn, channels):
        return [[fn(blocks[r], blocks[s], r * m, s * m, cr, cr2, channels)
                 for s in ring_order(p, r)] for r in range(p)]

    def ring_sums(parts):
        return torch.cat([combine_ring_parts(list(q)) for q in parts], dim=1)

    def gather_sums(channels):
        return torch.cat([k1.flocking_sums_block(blocks[r], x, r * m, 0, cr, cr2, channels)
                          for r in range(p)], dim=1)

    sums = sum_channels("full")
    for channels in ("core", "full"):
        parts = ring_parts(k1.flocking_sums_block, channels)
        ring = ring_sums(parts)
        note(compare_sums(ring, ring_sums(ring_parts(k1.flocking_sums_block_reference,
                                                     channels)), channels))
        plain = k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr2, channels)
        for want in (k1.flocking_sums_block(x, x, 0, 0, cr, cr2, channels), plain):
            note(compare_sums(gather_sums(channels), want, channels))
        hold("ring's degree against the whole swarm's", ring[..., 8], plain[..., 8], 0, "exact")
        if channels == "full":
            ulp = int((ring[..., 9].view(torch.int32) - plain[..., 9].view(torch.int32))
                      .abs().max())
            if ulp > 1:
                raise AssertionError(f"ring's channel 9 {ulp} ulp from the whole swarm's")
        used = sums if channels == "full" else sum_channels("core")
        err = hold_to_partials(f"ring's {channels} sums against the whole swarm's",
                               ring[..., used], plain[..., used],
                               [torch.cat([q[s][..., used] for q in parts], dim=1)
                                for s in range(p)], RING_TOL)
        to_whole = {k: max(to_whole[k], err[k]) for k in to_whole}

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    h = torch.randn(b, n, 6, generator=gen, device=device)
    co = torch.randn(b, n, 6, generator=gen, device=device)
    hb = [h[:, r * m:(r + 1) * m].contiguous() for r in range(p)]
    adj = AdjErrors()

    def ring_adj(fn, hs):
        """``(out, deg, [each source's tiles])`` of the ring over ``fn``."""
        outs, degs, parts = [], [], [[] for _ in range(p)]
        for r in range(p):
            tiles = [fn(blocks[r], blocks[s], hs[s], r * m, s * m, CR2)
                     for s in ring_order(p, r)]
            out, deg = tiles[0]
            for o, d in tiles[1:]:
                out, deg = out + o, deg + d
            outs.append(out)
            degs.append(deg)
            for s, (o, _) in enumerate(tiles):
                parts[s].append(o)
        return (torch.cat(outs, dim=1), torch.cat(degs, dim=1),
                [torch.cat(q, dim=1) for q in parts])

    out, deg, parts = ring_adj(k2.adjacency_matmul_block, hb)
    want, want_deg, _ = ring_adj(k2.adjacency_matmul_block_reference, hb)
    compare_deg(deg, want_deg)
    adj.check(out, want)
    adj.check(_pool(out, deg, True), _pool(want, want_deg, True))
    plain, plain_deg = k2.adjacency_matmul_block_reference(x, x, h, 0, 0, CR2)
    compare_deg(deg, plain_deg)
    k2_to_whole = hold_to_partials("K2 ring against the whole swarm", out, plain, parts,
                                   RING_TOL)
    backward = k2.backward_launches
    grads = []
    for fn in (k2.adjacency_matmul_block, k2.adjacency_matmul_block_reference):
        leaves = [t.detach().clone().requires_grad_() for t in hb]
        (ring_adj(fn, leaves)[0] * co).sum().backward()
        grads.append(torch.cat([t.grad for t in leaves], dim=1))
        if fn is k2.adjacency_matmul_block:
            backward = k2.backward_launches - backward
    if backward != p * p * k2.launches_for(6):
        raise AssertionError(f"{backward} K2 backward launches for {p * p} tiles")
    adj.check(*grads)

    # the tiles' cost beside one launch over the whole swarm
    core_parts = lambda: ring_sums(ring_parts(k1.flocking_sums_block, "core"))  # noqa: E731
    return {"P": p, "B": b, "N": n, "m": m, "k1_worst": worst, "k1_ring_to_whole": to_whole,
            "k2_max_rel": adj.rel, "k2_max_abs_err": adj.abs,
            "k2_ring_to_whole": k2_to_whole, "k2_backward_launches": backward,
            "k1_ring_tiles_ms": time_ms(core_parts),
            "k1_gather_tiles_ms": time_ms(lambda: gather_sums("core")),
            "k1_whole_ms": time_ms(lambda: k1.flocking_sums_block(x, x, 0, 0, cr, cr2, "core")),
            "k2_ring_tiles_ms": time_ms(lambda: ring_adj(k2.adjacency_matmul_block, hb)),
            "k2_whole_ms": time_ms(lambda: k2.adjacency_matmul_block(x, x, h, 0, 0, CR2))}


def phase_sharded_rollout(device: str, n_envs: int, n_steps: int) -> dict:
    """Phase 31: ``agent_sharded_rollout`` at FlockingLarge-v0's registered
    size on a 1 x 1 mesh, in both modes.  K1 launches: the reset's draws,
    one pass for the first controller, one a step.  The reset equals
    ``LargeFlockingEnv.reset_env`` from the same generator; the first step
    (``flocking_step_sharded``) equals the env's controller and integrator
    (the sharded step integrates the controller's output as it is, as the
    JAX package's does) and the env's observation, and the plain pipeline
    on the host (first 2 envs)."""
    import dataclasses

    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.envs.flocking import _instant_cost, _integrate
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.parallel import agent_shard as ash

    env, params = gft.make("FlockingLarge-v0")
    mesh = ash.make_flock_mesh(1, 1)
    ap = mesh.get_group("ap")
    res = {"N": params.n_agents, "B": n_envs, "steps": n_steps}
    finals = {}
    for mode in ("ring", "allgather"):
        gen = torch.Generator(device=device).manual_seed(SEED + 31)
        gen_state = gen.get_state()
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        xf, mean_r = ash.agent_sharded_rollout(params, gen, n_envs, n_steps, mesh, mode)
        _sync()
        seconds = time.perf_counter() - t0
        launches, tries = k1.launches, ash.last_reset_tries
        if launches != tries + 1 + n_steps or launch_total() != launches:
            raise AssertionError(f"{mode}: K1 {launches} launches ({launch_total()} in all) "
                                 f"for {tries} reset draws + 1 + {n_steps} steps")
        check_all_finite(f"sharded rollout ({mode})", xf, mean_r)
        finals[mode] = xf

        replay = torch.Generator(device=device)
        replay.set_state(gen_state)
        x0 = ash.flocking_reset_sharded(replay, params, n_envs, ap, mode)
        replay.set_state(gen_state)
        state0, _ = env.reset_env(replay, params, n_envs)
        hold("sharded reset", x0, state0.x, 0, "exact")
        x1, values, reward = ash.flocking_step_sharded(x0, params, ap, mode)
        x1_env = _integrate(state0.x, env.controller(state0, params), params.dt)
        # the observations at the sharded step's state (1/r^4 terms of close
        # pairs amplify the integration's rounding)
        values_env, deg_env = env._obs(dataclasses.replace(state0, x=x1), params)
        head = host_head(x0, 2)
        u_host = k1.turner_controller_large(head, params.comm_radius, params.comm_radius2,
                                            params.action_scalar)
        s_host = k1.flocking_sums_block_reference(host_head(x1, 2), host_head(x1, 2), 0, 0,
                                                  params.comm_radius, params.comm_radius2,
                                                  "core")
        res[mode] = {
            "k1_launches": launches, "reset_tries": tries, "seconds": seconds,
            "agent_steps_per_s": n_envs * n_steps * params.n_agents / seconds,
            "mean_reward": float(mean_r),
            "first_step": {
                "x_vs_env": hold("first step's state", x1, x1_env, STATE_ATOL, "abs"),
                "values_vs_env": hold("first step's values", values, values_env, SUM_TOL),
                "reward_vs_env": hold("first step's reward", reward, _instant_cost(x1),
                                      U_ATOL, "abs"),
                "x_vs_host": hold("first step's state on the host", host_head(x1, 2),
                                  _integrate(head, u_host, params.dt), STATE_ATOL, "abs"),
                "values_vs_host": hold("first step's values on the host",
                                       host_head(values, 2), s_host[..., 0:6], SUM_TOL),
            },
        }
        compare_deg(ash.flocking_features_sharded(x1, params.comm_radius, params.comm_radius2,
                                                  ap, mode)[1], deg_env)
    res["ring_vs_allgather_rel"] = hold("ring against all-gather", finals["ring"],
                                        finals["allgather"], SUM_TOL)
    res["k1_launches"] = res["ring"]["k1_launches"] + res["allgather"]["k1_launches"]
    return res


def phase_sharded_training(device: str, first_loss14: float, world) -> dict:
    """Phase 32: the sharded train steps at world size 1.  (a)
    ``make_agent_sharded_train_step`` on phase 14's first batch (same seed:
    4 envs x 4 steps), 5 updates: K2 exactly 2 launches an update and none
    for a backward (the features are inputs); the first loss equals phase
    14's within 1e-5.  (b) the data-parallel flocking step at phase 16's
    size, (c) the sharded DAGGER iteration at phase 20's, (d) the
    data-parallel coverage step at phase 17's, 2 steps each: K1 once a reset
    draw, K5 once a collect step, the weights moved, the losses finite."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.models import AggregationGNN, EdgeGraphNet
    from gym_flock_tpu_torch.ops import adjacency_matmul as k2
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5
    from gym_flock_tpu_torch.parallel import (CoverageImitationTrainer, DaggerTrainer,
                                              FlockingImitationTrainer,
                                              LargeFlockingImitationTrainer)
    from gym_flock_tpu_torch.parallel.dagger import make_sharded_iteration
    from gym_flock_tpu_torch.parallel.train_coverage import make_sharded_train_step

    res = {}
    env, params = gft.make("FlockingLarge-v0")
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer = LargeFlockingImitationTrainer(env, params, device=device)
    trainer.init(gen)
    batch = trainer.collect(gen, 4, 4)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    step = trainer.make_agent_sharded_train_step()
    _sync()
    reset_counts()
    t0 = time.perf_counter()
    losses = [float(step(batch)) for _ in range(5)]
    _sync()
    update_s = (time.perf_counter() - t0) / 5
    if k2.launches != 2 * 5 or k2.backward_launches != 0 or launch_total() != k2.launches:
        raise AssertionError(f"K2 {k2.launches} launches ({k2.backward_launches} backward, "
                             f"{launch_total()} in all) for 5 agent-sharded updates")
    loss_rel = abs(losses[0] - first_loss14) / abs(first_loss14)
    if not loss_rel < 1e-5:
        raise AssertionError(f"agent-sharded first loss {losses[0]} against phase 14's "
                             f"{first_loss14}: relative {loss_rel:.3e}")
    check_training(losses, before, trainer.model)
    res["agent_sharded"] = {"losses": losses, "first_loss_vs_phase14_rel": loss_rel,
                            "k2_launches": k2.launches, "k2_backward_launches": 0,
                            "update_ms": update_s * 1e3}

    def run_steps(name, model, step_fn, expect):
        before = [p.detach().clone() for p in model.parameters()]
        gen = torch.Generator(device=device).manual_seed(SEED + 32)
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        losses = [float(step_fn(gen, k)) for k in range(2)]
        _sync()
        seconds = (time.perf_counter() - t0) / 2
        counts = {"k1": k1.launches, "k2": k2.launches, "k5": k5.launches}
        if counts != expect():
            raise AssertionError(f"{name}: launches {counts}, want {expect()}")
        check_training(losses, before, model)
        res[name] = {"losses": losses, "seconds_a_step": seconds, **counts}

    renv, rparams = gft.make("FlockingRelative-v0")
    draws = []

    def count_draws(fn):
        def run(gen, k):
            out = fn(gen, k)
            draws.append(renv.last_reset_tries)
            return out
        return run

    ftr = FlockingImitationTrainer(renv, rparams, device=device)
    ftr.init(torch.Generator(device=device).manual_seed(SEED))
    dp_step = ftr.make_sharded_train_step(n_envs=1024, n_steps=8)
    run_steps("dp_flocking", ftr.model, count_draws(lambda gen, k: dp_step(gen)),
              lambda: {"k1": sum(draws), "k2": 0, "k5": 0})

    draws.clear()
    dgen = torch.Generator(device=device).manual_seed(SEED)
    dtr = DaggerTrainer(renv, rparams, capacity=8192, device=device,
                        model=AggregationGNN(k_hops=4, hidden=(128, 128), generator=dgen,
                                             device=device))
    d_step, d_init = make_sharded_iteration(dtr, n_envs=8, n_steps=16, n_grad_steps=4)
    d_init(dgen)
    run_steps("sharded_dagger", dtr.model,
              count_draws(lambda gen, k: d_step(gen, dtr.beta_decay ** k)),
              lambda: {"k1": sum(draws), "k2": 0, "k5": 0})
    res["sharded_dagger"]["filled"] = dtr.state.filled

    cenv, cparams = world
    cgen = torch.Generator(device=device).manual_seed(SEED)
    ctr = CoverageImitationTrainer(cenv, cparams, device=device,
                                   model=EdgeGraphNet(64, 6, generator=cgen, device=device))
    ctr.init(cgen)
    c_step = make_sharded_train_step(ctr, n_envs=8, n_steps=16)
    run_steps("dp_coverage", ctr.model, lambda gen, k: c_step(gen),
              lambda: {"k1": 0, "k2": 0, "k5": 2 * 16})
    res["k1_launches"] = res["dp_flocking"]["k1"] + res["sharded_dagger"]["k1"]
    res["k5_launches"] = res["dp_coverage"]["k5"]
    res["k2_launches"] = res["agent_sharded"]["k2_launches"]
    return res


def ulp_gap(got, want) -> int:
    """The largest distance in float64 ulps between two tensors of the same
    shape (0 where both are the same NaN or infinity)."""
    a, b = got.cpu().double().numpy(), want.cpu().double().numpy()
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} against {b.shape}")
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0

    def ordered(v):
        i = v.view(np.int64)
        return np.where(i < 0, np.int64(-(2 ** 63)) - i, i)

    ia, ib = ordered(a[~same]), ordered(b[~same])
    return int(max(abs(int(p) - int(q)) for p, q in zip(ia.tolist(), ib.tolist())))


def phase_parity(device: str, n_steps: int) -> dict:
    """Phase 33: ``parity_exact`` at float64 on the card against the host.
    FlockingRelative-v0 (N=50, from ``compat.parity.reference_flocking_reset``
    of numpy seed 7) free-running for ``n_steps`` expert steps: the actions,
    states, observations, networks and rewards must be bitwise the host's.
    Shepherding-v0 (from ``reference_shepherding_reset(5)``, headings drawn
    with numpy seed 6) and Mapping-v0 (a float64 state drawn on the host,
    its in-radius targets retired as the reset retires them):
    each step from the card's state is repeated on the host, and their
    largest ulp gap is reported (the card's f64 cos/sin/atan2 are CUDA's,
    not the host C library's)."""
    import dataclasses

    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.compat import parity
    from gym_flock_tpu_torch.envs.mapping import MappingState, _mapping_helpers

    res = {}
    n = 50
    x0 = parity.reference_flocking_reset(n, math.sqrt(n), 5.0, 0.81,
                                         rng=np.random.RandomState(7))
    env, params = gft.make("FlockingRelative-v0", n_agents=n, parity_exact=True)
    card = env.init_state(torch.from_numpy(x0)[None].to(device), params)
    host = env.init_state(torch.from_numpy(x0)[None], params)
    t0 = time.perf_counter()
    for t in range(n_steps):
        uc, uh = env.controller(card, params), env.controller(host, params)
        card, oc, rc, _, _ = env.step_env(None, card, uc, params)
        host, oh, rh, _, _ = env.step_env(None, host, uh, params)
        for what, a, b in (("action", uc, uh), ("state", card.x, host.x), ("values", oc[0], oh[0]),
                           ("network", oc[1], oh[1]), ("reward", rc, rh)):
            if a.dtype != torch.float64 or not torch.equal(a.cpu(), b):
                raise AssertionError(f"parity FlockingRelative-v0 step {t}: the card's {what} "
                                     f"is {ulp_gap(a, b)} ulp from the host's")
    res["FlockingRelative-v0"] = {"N": n, "steps": n_steps, "max_ulp": 0,
                                  "seconds": time.perf_counter() - t0}

    def locked(name, env, card_params, host_params, state):
        """Each step from the card's state, again on the host: the largest
        ulp gaps."""
        gaps = {"action": 0, "state": 0, "obs": 0, "reward": 0}
        for _ in range(n_steps):
            hs = host_head(state, None)
            uc, uh = env.controller(state, card_params), env.controller(hs, host_params)
            state, oc, rc, _, _ = env.step_env(None, state, uc, card_params)
            hs2, oh, rh, _, _ = env.step_env(None, hs, uh, host_params)
            for what, a, b in (("action", uc, uh), ("state", state.x, hs2.x),
                               ("obs", torch.cat([o.flatten(1) for o in oc], 1),
                                torch.cat([o.flatten(1) for o in oh], 1)), ("reward", rc, rh)):
                gaps[what] = max(gaps[what], ulp_gap(a, b))
        check_all_finite(name, state.x)
        res[name] = {"steps": n_steps, "max_ulp": gaps}

    sx = parity.reference_shepherding_reset(5)
    sx[:, 2] = np.random.RandomState(6).uniform(-np.pi, np.pi, size=(sx.shape[0],))
    senv, sp = gft.make("Shepherding-v0", parity_exact=True)
    locked("Shepherding-v0", senv, sp, sp,
           senv.init_state(torch.from_numpy(sx)[None].to(device), sp))

    menv, mp = gft.make("Mapping-v0", parity_exact=True, device=device)
    mp_host = dataclasses.replace(mp, target_x=mp.target_x.cpu())
    gen = torch.Generator().manual_seed(SEED)
    half = torch.tensor([mp.px_max, mp.py_max, mp.v_max, mp.v_max], dtype=torch.float64)
    x = (2.0 * torch.rand(1, mp.n_agents, 4, generator=gen, dtype=torch.float64) - 1.0) * half
    unobserved = torch.ones(1, mp.n_targets, dtype=torch.bool)
    _, _, obs_t, newly, _ = _mapping_helpers(x, unobserved, mp_host)
    mstate = MappingState(time=torch.zeros(1, dtype=torch.int32, device=device),
                          x=x.to(device), unobserved=(unobserved & ~newly).to(device),
                          last_obs_target=obs_t.to(device))
    locked("Mapping-v0", menv, mp, mp_host, mstate)
    return res


TRACED_PAIRS = 48  # one coverage queue at its cap of 48
DIFF_EVENTS = 120


def without_facade(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "legacy"}


def bit_equal(a, b) -> bool:
    """Two results of the legacy facade equal bit for bit: arrays by their
    bytes, dtype and shape; floats and bools by value and type."""
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(bit_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def traced_pairs(legacy, n: int) -> dict:
    """``n`` more pairs of ``legacy_loop``'s loop under ``torch.profiler``:
    the launches, synchronisations and idle share a pair."""
    from tools.profile_facades import traced

    coverage = legacy.env_id.startswith("Coverage")

    def pairs():
        for _ in range(n):
            u = legacy.controller(greedy=True) if coverage else legacy.controller()
            if legacy.step(u)[2]:
                legacy.reset()

    t = traced(pairs, n)
    return {k: t[k] for k in ("wall_ms_each", "launches_each", "syncs_each", "idle_share")}


def lookahead_differential(device: str, env_id: str, n_events: int) -> dict:
    """The randomized interleaving of ``tests/test_torch_legacy_lookahead.py``
    on the card: pairs, doubled controller calls, perturbed steps and resets
    on a facade with the lookahead and on its flushed twin; every result
    bit for bit and the final generator states equal.  The facade queues
    after every hit (``_RAMP`` 1), so that the queue meets every kind of
    event.  K1 once a reset draw and K5 once a greedy controller
    evaluation, over both facades."""
    import torch

    from gym_flock_tpu_torch.compat import make_legacy
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5

    greedy = env_id.startswith("Coverage")
    a, b = make_legacy(env_id, device=device), make_legacy(env_id, device=device)
    a._RAMP = 1
    _sync()
    reset_counts()
    draws = 0

    def ctrl(e):
        return e.controller(greedy=True) if greedy else e.controller()

    def unfused():
        u = ctrl(b)
        b._flush_queue()
        return u

    def check(what, x, y):
        if not bit_equal(x, y):
            raise AssertionError(f"{env_id} differential: {what} differs from the twin's")

    def resets():
        nonlocal draws
        check("reset", a.reset(), b.reset())
        draws += getattr(a.env, "last_reset_tries", 0) + getattr(b.env, "last_reset_tries", 0)

    a.seed(9), b.seed(9)
    resets()
    rng = np.random.RandomState(0)
    events = {}
    for i in range(n_events):
        ev = str(rng.choice(["pair", "double", "miss", "reset"], p=[0.6, 0.15, 0.15, 0.1]))
        events[ev] = events.get(ev, 0) + 1
        if ev == "reset":
            resets()
            continue
        ua, ub = ctrl(a), unfused()
        if ev == "double":
            ua, ub = ctrl(a), unfused()
        check(f"event {i} action", ua, ub)
        if ev == "miss":
            ua = (ua + 1) % 4 if greedy else ua + np.float32(0.25)
            ub = ua.copy()
        ra, rb = a.step(ua)[:3], b.step(ub)[:3]
        check(f"event {i} ({ev}) step", ra, rb)
        if ra[2]:
            resets()
    _sync()
    if not torch.equal(a._gen.get_state(), b._gen.get_state()):
        raise AssertionError(f"{env_id} differential: the generator states differ")
    evals = a.controller_evals + b.controller_evals if greedy else 0
    if k1.launches != draws or k5.launches != evals:
        raise AssertionError(f"{env_id} differential: K1 {k1.launches} for {draws} draws, "
                             f"K5 {k5.launches} for {evals} controller evaluations")
    return {"events": events, "computed_pairs": a.computed_pairs,
            "controller_evals": a.controller_evals,
            "twin_controller_evals": b.controller_evals, "k1_launches": k1.launches,
            "k5_launches": k5.launches}


def phase_lookahead(device: str, n_steps: int) -> dict:
    """Phase 34: the legacy facade's lookahead against its flushed twin,
    which runs the eager path.  The traced windows (the lookahead's only)
    come after every timed loop, so that no profiler session runs before a
    timed one."""
    import torch

    out, facades, k1_total, k5_total = {}, {}, 0, 0
    t0 = time.perf_counter()
    keys = ("steps_per_s", "ms_a_pair", "depth", "computed_pairs", "controller_evals",
            "resets", "reset_draws", "k1_launches", "k5_launches")
    for env_id, kw in LEGACY_IDS:
        runs, records, gens = {}, {}, {}
        for name, flush in (("twin", True), ("lookahead", False)):
            records[name] = []
            res = legacy_loop(device, env_id, n_steps, flush=flush, record=records[name], **kw)
            facades[env_id, name] = res["legacy"]
            gens[name] = res["legacy"]._gen.get_state()
            runs[name] = {k: res[k] for k in keys}
            k1_total += res["k1_launches"]
            k5_total += res["k5_launches"]
        got, want = records.pop("lookahead"), records.pop("twin")
        if len(got) != len(want):
            raise AssertionError(f"{env_id}: {len(got)} results against the twin's {len(want)}")
        for i, (x, y) in enumerate(zip(got, want)):
            if not bit_equal(x, y):
                raise AssertionError(f"{env_id}: call {i} differs from the flushed twin's")
        if not torch.equal(gens["lookahead"], gens["twin"]):
            raise AssertionError(f"{env_id}: the generator states differ from the twin's")
        out[env_id] = runs | {"calls_compared": len(got), "lookahead_over_eager": (
            runs["lookahead"]["steps_per_s"] / runs["twin"]["steps_per_s"])}
    t1 = time.perf_counter()
    for env_id, _ in LEGACY_IDS:
        out[env_id]["lookahead"]["traced"] = traced_pairs(facades[env_id, "lookahead"],
                                                          TRACED_PAIRS)
    t2 = time.perf_counter()
    out["differential"] = {env_id: lookahead_differential(device, env_id, DIFF_EVENTS)
                           for env_id in ("FlockingRelative-v0", "Coverage-v0")}
    out["seconds"] = {"loops": t1 - t0, "traced": t2 - t1,
                      "differential": time.perf_counter() - t2}
    out["k1_launches"] = k1_total + sum(d["k1_launches"] for d in out["differential"].values())
    out["k5_launches"] = k5_total + sum(d["k5_launches"] for d in out["differential"].values())
    return out


EXAMPLES = (
    ("torch_run_flocking.py", "-n", "100"),
    ("torch_run_flocking.py", "--batch", "1024", "--steps", "16"),
    ("torch_run_coverage.py", "-g", "-n", "1"),
    ("torch_run_shepherding.py", "-N", "1", "--steps", "50"),
    ("torch_run_shepherding.py", "--batch", "1024", "--steps", "50"),
    ("torch_train_flocking_large.py", "--agents", "2048", "--iters", "3"),
)
EXAMPLE_TIMEOUT_S = 300


def phase_examples() -> dict:
    """Phase 35: the example drivers on the card, each a subprocess of a
    few steps, all started at once; each must exit with 0."""
    t0 = time.perf_counter()
    procs = [(argv, subprocess.Popen([sys.executable, str(ROOT / "examples" / argv[0]),
                                      *argv[1:]], cwd=str(ROOT), text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE))
             for argv in EXAMPLES]
    out = {}
    try:
        for argv, proc in procs:
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            name = " ".join(argv)
            if proc.returncode != 0:
                raise AssertionError(f"example {name} exited with {proc.returncode}:\n"
                                     f"{stderr[-3000:]}")
            lines = stdout.strip().splitlines()
            out[name] = {"seconds": time.perf_counter() - t0,
                         "last_line": lines[-1] if lines else ""}
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


QUALITY_ITERS = 16  # phase 36's flocking BC, on cosine_decay_schedule(1e-3, 16, 0.03)
QUALITY_LOOP = (8, 20)  # phase 36's closed loop: envs x steps
QUALITY_VRP = (2, 4)  # phase 36's VRP-labelled states: envs x steps
QUALITY_EVAL = (8, 10)  # phase 36's coverage evaluations: envs x steps


def load_quality_tool():
    """``tools/train_quality_torch.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_quality_torch", ROOT / "tools" / "train_quality_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_closed_loop(what: str, entry: dict, probe: dict) -> None:
    """The three modes from equal resets, finite rewards, and the expert's
    cost below random's."""
    import torch

    resets = probe["resets"]
    if not all(torch.equal(resets["policy"], x) for x in resets.values()):
        raise AssertionError(f"{what}: the closed loop's modes start from different resets")
    ep = entry["episode_reward_200_steps"]
    if not all(math.isfinite(ep[m]) for m in ("policy", "expert", "random")):
        raise AssertionError(f"{what}: closed-loop rewards {ep}")
    if not ep["expert"] > ep["random"]:
        raise AssertionError(f"{what}: the expert's cost {-ep['expert']} is not below "
                             f"random's {-ep['random']}")


def phase_quality(device: str, world, eval_params) -> dict:
    """Phase 36: the training-quality pipelines of
    ``tools/train_quality_torch.py`` at full width with few iterations:
    flocking BC on its schedule, flocking DAgger, VRP-label BC on phase 17's
    banks with phase 19's solver; K1 and K5 launch counts; then K1 "full" at
    the collects' and the closed loop's reset shapes and K5 at the VRP
    rollout's, each held to plain."""
    import torch

    import gym_flock_tpu_torch as gft
    from gym_flock_tpu_torch.models import AggregationGNN
    from gym_flock_tpu_torch.ops import flocking_sums as k1
    from gym_flock_tpu_torch.ops import rowmin as k5
    from gym_flock_tpu_torch.parallel import cosine_decay_schedule

    tq = load_quality_tool()
    loop_envs, loop_steps = QUALITY_LOOP
    t0 = time.perf_counter()

    # flocking BC: each step's Adam lr is the schedule's, K1 once a reset
    # draw, the first loss a CPU copy's
    _sync()
    reset_counts()
    probe = {}
    bc = tq.run_flocking(device, n_iters=QUALITY_ITERS, eval_envs=loop_envs,
                         eval_steps=loop_steps, probe=probe)
    _sync()
    bc_k1 = k1.launches
    if bc_k1 != bc["reset_draws"] or k5.launches != 0:
        raise AssertionError(f"flocking BC: K1 {bc_k1} launches for {bc['reset_draws']} "
                             f"reset draws, K5 {k5.launches}")
    schedule = cosine_decay_schedule(1e-3, QUALITY_ITERS, alpha=0.03)
    want_lrs = [schedule(i) for i in range(QUALITY_ITERS)]
    if probe["lrs"] != want_lrs:
        raise AssertionError(f"flocking BC: Adam's lr {probe['lrs']} against the schedule's "
                             f"{want_lrs}")
    check_closed_loop("flocking BC", bc, probe)
    cpu = AggregationGNN(k_hops=4, hidden=(128, 128))
    cpu.load_state_dict({k: v.cpu() for k, v in probe["initial_weights"].items()})
    feats, adj, acts = (b.cpu() for b in probe["first_batch"])
    with torch.no_grad():
        cpu_loss = float(torch.mean((cpu(feats, adj) - acts) ** 2))
    loss_rel = abs(bc["train"]["loss_first"] - cpu_loss) / abs(cpu_loss)
    if not loss_rel < 1e-5:
        raise AssertionError(f"flocking BC: first loss {bc['train']['loss_first']} against "
                             f"{cpu_loss} on the CPU copy: relative {loss_rel:.3e}")
    if not all(math.isfinite(v) for v in (bc["heldout_action_mse"], bc["predict_zero_mse"])):
        raise AssertionError(f"flocking BC: held-out MSE {bc['heldout_action_mse']}")
    loop_x = probe["resets"]["policy"]

    # flocking DAgger, two iterations
    reset_counts()
    probe = {}
    dg = tq.run_flocking_dagger(device, n_iters=2, eval_envs=loop_envs, eval_steps=loop_steps,
                                probe=probe)
    _sync()
    dg_k1 = k1.launches
    if dg_k1 != dg["reset_draws"] or k5.launches != 0:
        raise AssertionError(f"flocking DAgger: K1 {dg_k1} launches for "
                             f"{dg['reset_draws']} reset draws, K5 {k5.launches}")
    check_closed_loop("flocking DAgger", dg, probe)
    if not all(math.isfinite(v) for v in (dg["train"]["loss_first"], dg["train"]["loss_last"])):
        raise AssertionError(f"flocking DAgger: losses {dg['train']}")

    # VRP-label BC: the greedy rollout (K5 a step) and the evaluations (K5
    # a collect step and an expert step, two banks, two models)
    env, params = world
    n_envs, n_steps = QUALITY_VRP
    eval_envs, eval_steps = QUALITY_EVAL
    reset_counts()
    probe = {}
    vr = tq.run_bc_vrp(device, n_envs=n_envs, n_steps=n_steps, n_epochs=2,
                       minibatch=n_envs * n_steps // 2, eval_envs=eval_envs,
                       eval_steps=eval_steps, world=(env, params, eval_params), probe=probe)
    _sync()
    vr_k5 = check_k5_count("bc_vrp", n_steps + 2 * 2 * 2 * eval_steps)
    for name, labels in probe["labels"].items():
        if labels.shape != (n_envs * n_steps, params.n_robots) or not (
                (labels >= 0) & (labels < params.n_actions)).all():
            raise AssertionError(f"bc_vrp {name} labels {labels.shape} out of range")
    a, b = (probe["initial_weights"][n] for n in ("or_default", "last_accept"))
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("bc_vrp: the two models start from different weights")
    if not all(math.isfinite(m["loss_last"]) for m in vr["models"].values()):
        raise AssertionError(f"bc_vrp: losses {vr['models']}")
    seconds = time.perf_counter() - t0

    # the kernels at this slice's shapes (comparison and timing only)
    fenv, fp = gft.make("FlockingRelative-v0")
    big_x, _ = fenv.reset_env(torch.Generator(device=device).manual_seed(SEED), fp, 64)
    k1_errs, k1_timings = [], []
    for x in (loop_x, big_x.x):
        k1_errs.append(k1_reset_check(x, fp.comm_radius, fp.comm_radius2))
        k1_timings.append(k1_timing(x, fp.comm_radius, fp.comm_radius2, "full", plain=True))
    arl_state, _ = env.reset_env(torch.Generator(device=device).manual_seed(SEED), params, 32)
    k5_timing = k5_state_case(params, arl_state)
    return {"seconds": seconds,
            "flocking_bc": {"train": bc["train"], "heldout_action_mse": bc["heldout_action_mse"],
                            "predict_zero_mse": bc["predict_zero_mse"],
                            "episode": bc["episode_reward_200_steps"], "k1_launches": bc_k1,
                            "loss_vs_cpu_rel": loss_rel},
            "flocking_dagger": {"train": dg["train"], "episode": dg["episode_reward_200_steps"],
                                "k1_launches": dg_k1},
            "bc_vrp": {"label_flip_rate": vr["label_flip_rate"],
                       "label_seconds": vr["label_seconds"], "k5_launches": vr_k5,
                       "heldout_ratio": {n: m["closedloop_heldout"]["reward_ratio"]
                                         for n, m in vr["models"].items()}},
            "k1_launches": bc_k1 + dg_k1, "k5_launches": vr_k5,
            "k1_vs_plain": {k: max(e[k] for e in k1_errs) for k in k1_errs[0]},
            "k1_timings": k1_timings, "k5_timing": k5_timing}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from gym_flock_tpu_torch.envs.coverage import CACHE_ENV
    from gym_flock_tpu_torch.ops import _build

    # the run's own bank cache: phase 6 builds its banks (and writes them
    # there), phase 26 reads the ExploreFull bank back
    bank_cache = tempfile.TemporaryDirectory(prefix="gft_bank_cache_")
    os.environ[CACHE_ENV] = bank_cache.name

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"phase 1 device: {kind}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    device = "cuda"

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = "; ".join(line.strip() for line in _build.build_log.splitlines()
                     if "registers" in line or "spill" in line or "Compiling entry" in line)
    print(f"phase 2 build: {build_s:.2f} s ({_build.library_path().name}) {regs}")
    _sync()

    # 3. K1 against its plain version
    k = phase_kernel_check(device, [(16, 4096), (4, 4096), (8192, 100), (3, 1000)],
                           [(16, 4096, "core"), (4, 4096, "full"), (8192, 100, "full"),
                            (8192, 100, "core")])
    _sync()
    print("phase 3 K1 vs plain: " + json.dumps(k))

    # 4. FlockingLarge-v0 main path
    large = phase_large(device, n_envs=16, n_steps=16)
    _sync()
    print("phase 4 FlockingLarge-v0 B=16 N=4096 16 steps: " + json.dumps(large))

    # 5. FlockingRelative-v0 main path
    rel = phase_relative(device, n_envs=8192, n_steps=8)
    _sync()
    print("phase 5 FlockingRelative-v0 B=8192 N=100 8 steps: " + json.dumps(rel))

    # 6. banks and K5 against its plain version
    xenv, xparams, x_build_s, x_write_s = make_building(device, "ExploreFullEnv-v0",
                                                        real_map=True)
    t_real = xparams.bank["target_mask"].shape[1]
    if t_real < 4096:
        raise AssertionError(f"ExploreFullEnv-v0 has T={t_real}: not the real map")
    cenv, cparams, c_build_s, c_write_s = make_building(device, "Coverage-v0")
    print(f"phase 6 banks: ExploreFullEnv-v0 T={t_real} R={xparams.n_robots} built in "
          f"{x_build_s:.2f} s (then {x_write_s:.2f} s to write it to the disk cache); "
          f"Coverage-v0 G={cparams.bank['target_mask'].shape[0]} T={cparams.max_targets} "
          f"built in {c_build_s:.2f} s (then {c_write_s:.2f} s)")
    k5r = phase_rowmin_check(device, (xparams.bank, cparams.bank))
    _sync()
    print("phase 6 K5 vs plain: " + json.dumps(k5r))

    # 7. ExploreFullEnv-v0 main path
    xf = phase_coverage(device, xenv, xparams, n_envs=512, n_steps=8)
    xf["bank_build_seconds"] = x_build_s
    _sync()
    print("phase 7 ExploreFullEnv-v0 real map B=512 R=100 8 steps: " + json.dumps(xf))

    # 8. Coverage-v0 main path
    cv = phase_coverage(device, cenv, cparams, n_envs=8192, n_steps=16)
    cv["bank_build_seconds"] = c_build_s
    _sync()
    print("phase 8 Coverage-v0 B=8192 R=6 16 steps: " + json.dumps(cv))

    # 9. K3 against its plain version
    k3 = phase_sparse_kernel_check(device, [(1, 65536), (16, 16384)])
    _sync()
    print("phase 9 K3 vs plain: " + json.dumps(k3))

    # 10. FlockingSparse-v0 main path at N=65,536
    sp = phase_sparse_main(device, n_agents=65536, n_steps=SPARSE_STEPS)
    _sync()
    print(f"phase 10 FlockingSparse-v0 B=1 N=65536 {SPARSE_STEPS} steps: " + json.dumps(sp))

    # 11. FlockingSparse-v0 from its registered reset
    sr = phase_sparse_reset(device, n_envs=4, n_steps=8)
    _sync()
    print("phase 11 FlockingSparse-v0 reset B=4 N=16384 8 steps: " + json.dumps(sr))

    # 12. K2 against its plain version
    a2 = phase_adj_check(device, b=16, n=4096, f=6)
    _sync()
    print("phase 12 K2 vs plain: " + json.dumps(a2))

    # 13. K4 against its plain version
    a4 = phase_sparse_adj_check(device, [(1, 65536), (16, 16384)])
    _sync()
    print("phase 13 K4 vs plain: " + json.dumps(a4))

    # 14. the large GNN trained on FlockingLarge-v0 through K2
    t14 = phase_large_train(device, n_envs=4, n_steps=4, n_updates=5)
    _sync()
    print("phase 14 LargeFlockingImitationTrainer FlockingLarge-v0 N=4096 4 envs x 4 steps, "
          "5 updates: " + json.dumps(t14))

    # 15. the large GNN with the cell-list aggregation through K4
    t15 = phase_sparse_train(device, n_agents=65536, n_steps=4, n_updates=3)
    _sync()
    print("phase 15 LargeAggregationGNN + khop_aggregate_sparse FlockingSparse-v0 N=65536 "
          "4 steps, 3 updates: " + json.dumps(t15))

    # 16. the dense GNN trained on FlockingRelative-v0
    t16 = phase_relative_train(device, n_envs=1024, n_steps=8, n_updates=5)
    _sync()
    print("phase 16 FlockingImitationTrainer FlockingRelative-v0 N=100 1024 envs x 8 steps, "
          "5 updates: " + json.dumps(t16))

    # 17. coverage imitation on the real CoverageARL-v0 world through K5
    t0 = time.perf_counter()
    world = arl_world(device, bank_seed=0)
    _, eval_params = arl_world(device, bank_seed=1234)
    banks_s = time.perf_counter() - t0
    t17 = phase_coverage_train(device, world, eval_params, n_envs=8, n_steps=16, n_updates=5,
                               eval_envs=64, eval_steps=50)
    t17["banks_seconds"] = banks_s
    _sync()
    print("phase 17 CoverageImitationTrainer CoverageARL-v0 real map EdgeGraphNet(64, 6) "
          "8 envs x 16 steps, 5 updates: " + json.dumps(t17))

    # 18. coverage DAGGER on the same world
    t18 = phase_coverage_dagger(device, world, capacity=1024, n_envs=8, n_steps=16,
                                n_grad_steps=32, batch_size=128)
    _sync()
    print("phase 18 CoverageDaggerTrainer 2 iterations of 8 envs x 16 steps, 32 grad steps: "
          + json.dumps(t18))

    # 19. VRP labels of the greedy rollout's states
    t19 = phase_vrp_labels(device, world, n_envs=4, n_steps=8)
    _sync()
    print("phase 19 collect_vrp_labeled_batch 4 envs x 8 steps or_default workers=2: "
          + json.dumps(t19))

    # 20. flocking DAGGER
    t20 = phase_flocking_dagger(device, n_envs=8, n_steps=16, n_grad_steps=4)
    _sync()
    print("phase 20 DaggerTrainer FlockingRelative-v0 N=100 2 iterations of 8 envs x 16 steps: "
          + json.dumps(t20))

    # 21. the five flocking variants
    t21 = phase_flocking_variants(device, FLOCKING_VARIANTS, n_steps=8)
    _sync()
    print("phase 21 flocking variants, reset + 8 fused steps: " + json.dumps(t21))

    # 22. Shepherding-v0
    t22 = phase_shepherding(device, n_envs=4096, n_steps=64)
    _sync()
    print("phase 22 Shepherding-v0 B=4096 64 expert steps: " + json.dumps(t22))

    # 23. FormationFlying-v0 and LQR-v0
    t23 = phase_formation_lqr(device, n_formation=8192, n_lqr=4096, n_steps=64)
    _sync()
    print("phase 23 FormationFlying-v0 B=8192, LQR-v0 B=4096, 64 steps: " + json.dumps(t23))

    # 24. the mapping envs
    t24 = phase_mapping(device, n_envs=128, n_steps=32, n_others=1024, other_steps=4)
    _sync()
    print("phase 24 Mapping-v0 B=128 32 expert steps, the other mapping ids B=1024 4 steps: "
          + json.dumps(t24))

    # 25. FlockingMulti-v0 on K1 and K2
    t25 = phase_flocking_multi(device, n_envs=4096, n_steps=16)
    _sync()
    print("phase 25 FlockingMulti-v0 B=4096 N=80 16 steps: " + json.dumps(t25))

    # 26. the coverage flag modes, and the bank's disk format and cache
    t26 = phase_flag_modes(device, xparams.bank, x_build_s, x_write_s)
    _sync()
    print(f"phase 26 coverage flag modes B={FLAG_ENVS} {FLAG_STEPS} steps, ExploreFull bank "
          "save/load: " + json.dumps(t26))

    # 27. the gym facades
    t27 = phase_facades(device)
    _sync()
    print(f"phase 27 facades: make_legacy {LEGACY_STEPS} controller/step pairs, "
          "make_gymnasium, make_gymnasium_vector: " + json.dumps(t27))

    # 28. the AirSim bridges
    t28 = phase_bridges(device, BRIDGE_STEPS)
    _sync()
    print(f"phase 28 AirSim bridges {BRIDGE_STEPS} steps, card against host: "
          + json.dumps(t28))

    try:
        # 29. the process group: NCCL at world size 1
        t29 = phase_process_group(device, bank_cache.name)
        _sync()
        print("phase 29 torch.distributed NCCL world size 1: " + json.dumps(t29))

        # 30. the ring's K1 and K2 tiles at P=4 on one card
        t30 = phase_ring_tiles(device, RING_P)
        _sync()
        print(f"phase 30 ring tiles P={RING_P} FlockingLarge-v0 B=16 N=4096: "
              + json.dumps(t30))

        # 31. the agent-sharded rollout
        t31 = phase_sharded_rollout(device, n_envs=16, n_steps=16)
        _sync()
        print("phase 31 agent_sharded_rollout 1x1 mesh B=16 N=4096 16 steps: "
              + json.dumps(t31))

        # 32. the sharded train steps
        t32 = phase_sharded_training(device, t14["losses"][0], world)
        _sync()
        print("phase 32 sharded train steps (agent-sharded, DP flocking, DAGGER, DP "
              "coverage): " + json.dumps(t32))

        # 33. the parity mode on the card against the host
        t33 = phase_parity(device, PARITY_STEPS)
        _sync()
        print(f"phase 33 parity_exact float64 {PARITY_STEPS} steps, card against host: "
              + json.dumps(t33))
    finally:
        # NCCL's watchdog keeps a process whose group was not destroyed alive
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    # 34. the legacy facade's lookahead against its flushed twin
    t34 = phase_lookahead(device, LEGACY_STEPS)
    _sync()
    print(f"phase 34 make_legacy lookahead vs flushed twin, {LEGACY_STEPS} pairs, "
          f"{DIFF_EVENTS}-event differential: " + json.dumps(t34))

    # 35. the example drivers
    t35 = phase_examples()
    print("phase 35 examples/torch_*.py on the card: " + json.dumps(t35))

    # 36. the training-quality pipelines at full width, few iterations
    t0 = time.perf_counter()
    t36 = phase_quality(device, world, eval_params)
    _sync()
    t36["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 36 train_quality_torch pipelines (flocking BC {QUALITY_ITERS} iterations, "
          f"flocking DAgger 2, bc_vrp {QUALITY_VRP[0]} x {QUALITY_VRP[1]} states) in "
          f"{t36['phase_seconds']:.2f} s: " + json.dumps(t36))

    # 37. K6 against its plain version
    t37 = phase_dense_pass(device, [(8192, 100), (8, 100)])
    _sync()
    print("phase 37 K6 vs plain B=8192 and B=8, N=100: " + json.dumps(t37))

    # 38. K8 against its plain version at the three flocking cells' shapes
    t38 = phase_step_tail(device, [(65535, 100, "k6"), (8192, 100, "k6"), (16, 4096, "k1")])
    _sync()
    print("phase 38 K8 vs plain B=65535 and B=8192 N=100, B=16 N=4096: " + json.dumps(t38))

    big = k["timings"][0]
    k5_big = k5r["cases"][0]
    k3_big = k3["timings"][0]
    k4_big = a4["timings"][0]
    print(json.dumps({"kernels": [{
        "name": "block_sums",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/block_sums.cu",
        "replaces": "gym_flock_tpu/ops/pallas_flocking.py:268",
        "launches": (large["launches"] + rel["launches"] + sr["k1_launches"]
                     + t14["k1_collect_launches"] + t15["k1_launches"] + t16["k1_launches"]
                     + t20["k1_launches"] + t21["k1_launches"] + t25["k1_launches"]
                     + t27["k1_launches"] + t31["k1_launches"] + t32["k1_launches"]
                     + t34["k1_launches"] + t36["k1_launches"]),
        "max_abs_err": max(k["worst"]["abs"], k3["k1_dense_a"]["abs"],
                           sr["k1_core_vs_plain"]["abs"], sr["k1_full_vs_plain"]["abs"],
                           t21["k1_vs_plain"]["abs"], t25["k1_vs_plain"]["abs"],
                           t27["legacy"]["FlockingRelative-v0"]["k1_vs_plain"]["abs"],
                           t30["k1_worst"]["abs"], t36["k1_vs_plain"]["abs"]),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "timings": k["timings"] + [t25["k1_timing"]] + t36["k1_timings"],
        "ring_tiles": {key: t30[key] for key in ("P", "k1_ring_tiles_ms", "k1_gather_tiles_ms",
                                                 "k1_whole_ms")},
    }, {
        "name": "rowmin",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/rowmin.cu",
        "replaces": "gym_flock_tpu/ops/rowmin.py:72",
        "launches": (xf["launches"] + cv["launches"] + t17["k5_launches"]
                     + t17["eval_k5_launches"] + t18["k5_launches"] + t19["k5_launches"]
                     + t26["k5_launches"] + t27["k5_launches"] + t32["k5_launches"]
                     + t34["k5_launches"] + t36["k5_launches"]),
        "max_abs_err": k5r["max_abs_err"],
        "ms": k5_big["ms"],
        "plain_ms": k5_big["plain_ms"],
        "bound_ms": k5_big["bound_ms"],
        "bound_by": k5_big["bound_by"],
        "library_ms": None,
        "timings": k5r["cases"][:2] + [t17["k5_timing"], t36["k5_timing"]],
    }, {
        "name": "sparse_sums",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/sparse_sums.cu",
        "replaces": "gym_flock_tpu/ops/sparse_flocking.py:249",
        "launches": sp["k3_launches"] + sr["k3_launches"] + t15["k3_launches"],
        "max_abs_err": k3["worst"]["abs"],
        "ms": k3_big["ms"],
        "plain_ms": k3_big["plain_ms"],
        "bound_ms": k3_big["bound_ms"],
        "bound_by": k3_big["bound_by"],
        "library_ms": None,
        "timings": k3["timings"],
    }, {
        "name": "adj_matmul",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/adj_matmul.cu",
        "replaces": "gym_flock_tpu/ops/pallas_flocking.py:488",
        "launches": (t14["k2_launches"] + t15["k2_launches"] + t25["k2_launches"]
                     + t32["k2_launches"]),
        "backward_launches": t14["k2_backward_launches"],
        "checked_backward_launches": a2["backward_launches"] + t30["k2_backward_launches"],
        "max_abs_err": max(a2["max_abs_err"], t25["aggregation_vs_plain"]["abs"],
                           t30["k2_max_abs_err"]),
        "ms": a2["timings"][0]["ms"],
        "plain_ms": a2["timings"][0]["plain_ms"],
        "bound_ms": a2["timings"][0]["bound_ms"],
        "bound_by": a2["timings"][0]["bound_by"],
        "library_ms": None,
        "timings": a2["timings"] + [t25["k2_timing"]],
        "ring_tiles": {key: t30[key] for key in ("P", "k2_ring_tiles_ms", "k2_whole_ms")},
    }, {
        "name": "sparse_adj",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/sparse_adj.cu",
        "replaces": "gym_flock_tpu/ops/sparse_flocking.py:712",
        "launches": t15["k4_launches"],
        "backward_launches": t15["k4_backward_launches"],
        "checked_backward_launches": a4["backward_launches"],
        "max_abs_err": a4["max_abs_err"],
        "ms": k4_big["ms"],
        "plain_ms": k4_big["plain_ms"],
        "bound_ms": k4_big["bound_ms"],
        "bound_by": k4_big["bound_by"],
        "library_ms": None,
        "timings": a4["timings"],
    }, {
        "name": "dense_pass",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/dense_pass.cu",
        "replaces": None,
        "launches": rel["k6_launches"] + t21["k6_launches"],
        "max_rel_err": t37["worst"],
        "ms": t37["timings"][0]["ms"],
        "plain_ms": t37["timings"][0]["plain_ms"],
        "bound_ms": t37["timings"][0]["bound_ms"],
        "bound_by": t37["timings"][0]["bound_by"],
        "library_ms": None,
        "timings": t37["timings"],
    }, {
        "name": "resolve_conflicts",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/conflicts.cu",
        "replaces": None,
        "launches": xf["k7_launches"] + cv["k7_launches"],
        "max_abs_err": 0,
        "ms": xf["k7_timing"]["ms"],
        "plain_ms": xf["k7_timing"]["plain_ms"],
        "bound_ms": xf["k7_timing"]["bound_ms"],
        "bound_by": xf["k7_timing"]["bound_by"],
        "library_ms": None,
        "timings": [xf["k7_timing"], cv["k7_timing"]],
    }, {
        "name": "step_tail",
        "route": "cuda",
        "source": "gym_flock_tpu_torch/csrc/step_tail.cu",
        "replaces": None,
        "launches": large["k8_launches"] + rel["k8_launches"] + t21["k8_launches"],
        "max_rel_err": t38["worst_reward"],
        "ms": t38["timings"][0]["ms"],
        "plain_ms": t38["timings"][0]["plain_ms"],
        "bound_ms": t38["timings"][0]["bound_ms"],
        "bound_by": t38["timings"][0]["bound_by"],
        "library_ms": None,
        "timings": t38["timings"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
