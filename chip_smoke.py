#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc).  Imports no JAX and nothing of the JAX package.
Phases, one line each; any failed phase makes the script exit non-zero and
print no result:

  build  compile every CUDA source of the port (one nvcc each, in parallel)
  K1     fingerprint kernel vs its plain PyTorch version, bit for bit, on
         the port's int64 lanes and bool mask at M = 109,260 rows of K = 3
         lanes, all valid (the enabled candidates of Kip320 3r's largest
         chunk, as check() hands them over), at M = 32768 x 51 (a full
         chunk's lattice) and M = 65,537, K = 7, ~10% invalid rows; then
         its own time, route time, bound and plain time at the first shape
         (utils/kernel_times.py)
  K2     hash insert-or-find kernel vs its plain version at cap 2^22 and
         M = 109,260 with in-batch duplicates, pre-seeded keys and invalid
         rows (winners, count, membership identical); ten calls on two
         tables of one capacity in turn, every third with no mask; M = 1
         and M = 0; a tiny table that overflows, grown and re-run, against
         the same loop on the plain version; then its own, route and host
         time, bound and plain time on the call check() makes (no mask)
  K4     the six rungs of the construct ladder (run_ladder at n = 256, the
         TPU script's arange input, and at n = 2^24, 134 MB a pass: launched,
         bit-identical to their plain versions, timed with CUDA events over
         1,000 launches, own and route, with host us a call, beside their
         bound and, for every rung but dyn_read and dyn_slice, one PyTorch
         call), then bit for bit on random u32 at n = 65,536, 2^24 and
         2^24 + 3, on int32 views one element into their storage (off the
         16-byte boundary), at n = 4 with x[0] = 6 (the clamp), with pos in
         the tail and in the last vector, and with x[0] = 2^31, rest
         2^32 - 1 (unsigned remainder, wrap); the host time of one call split
         into the launch route's parts for a rung, K1 and K2, beside
         torch.add's (utils/kernel_times.py::host_split); and K2's route
         split into host work and read-back, one launch floor and the
         kernel's own work, all in this run
  main   configs/Kip320.cfg through check() on the card with the knobs
         visited_backend="device-hash", pipeline="legacy", compact_shift=0:
         ok, 737,794 states, diameter 25, per-level counts equal to the JAX
         package's (pinned below), both kernels launched
  trace  KafkaTruncateToHighWatermark 3r L2 R2 E2 with StrongIsr only, the
         same knobs: violated at depth 8 with the JAX package's trace for
         them (pinned below)
  default        configs/Kip320.cfg through check() with no knobs (the
         sorted `device` visited set, the fused pipeline, compact_shift 2,
         compact_gate 4096): the same counts, K1 launched, K2 not
  trace-default  the trace model with no knobs: the JAX package's trace
         for its defaults (pinned below)
  host   configs/Kip320.cfg through check() on the card with
         visited_backend="host" (the native C++ fingerprint set, built by
         g++): the same counts, K1 launched, K2 not
  resume configs/Kip320.cfg with a checkpoint every level, cut at
         max_depth=12, then resumed in a fresh check() to the end, on each
         of `device`, `device-hash` and `host`: the same counts, and the
         digest chain in the newest checkpoint equal, row for row, to the
         JAX package's (pinned below) on all three
  first-try-strong  configs/Kip320FirstTry.cfg with StrongIsr only, no
         knobs: violated at depth 12 after 284,803 states with the JAX
         package's trace (pinned below)
  cli    `python -m kafka_specification_tpu_torch.cli check
         configs/Kip320FirstTry.cfg --json` in a subprocess: exit 1 and the
         JAX package's kspec-verdict/1 record (WeakIsr at depth 11; pinned
         below, timing fields aside); then `cli check configs/Kip320.cfg
         --max-states 100000 --json --stats FILE`: exit 0, the JAX
         package's record and the deterministic fields of its stats lines
         (pinned below)
  async-isr  AsyncIsr 4r M3 V3 (Replicas {b1..b4}, MaxOffset 3,
         MaxVersion 3: the widest the encoding admits) through check() with
         no knobs and with visited_backend="device-hash": ok, 8,134,400
         states, diameter 30, per-level counts equal to the JAX package's
         (pinned below), K1 launched (and K2 on device-hash); then `cli check
         configs/AsyncIsr.cfg --json` in a subprocess: exit 0 and the JAX
         package's record (4,088 states, diameter 16; pinned below)
  product  TINY^3, the product of three Kip320 2r L2 R1 E1 partitions
         (27 actions, all four invariants), through check() with no knobs:
         ok, 21,253,933 states, diameter 33, per-level counts equal to the
         closed form (the base's 12 JAX levels convolved three times,
         computed here), K1 launched; then TruncateToHW 2r (TypeOk, WeakIsr)
         x 2 with no knobs: WeakIsr at depth 8 after 15,997 states with the
         JAX package's trace (pinned below as a digest of the whole trace)
  simulate  `cli simulate` in a subprocess, twice: configs/
         KafkaTruncateToHighWatermark.cfg --walks 200 --depth 30 --seed 0
         (exit 1, WeakIsr at depth 12 after 1,673 states, the JAX package's
         rendered trace, pinned as a digest) and configs/Kip320Stretch.cfg
         --module Kip320 --walks 10 --depth 50 --seed 0 (exit 0, "498
         states visited, no violations"); each run's process wall and the
         states/s it printed
  device-pipeline  check(pipeline="device"), the device-resident level
         pipeline: configs/Kip320.cfg on `device` and `host` (737,794
         states, diameter 25, the pinned levels, the JAX package's chain
         from one checkpoint after the last level, 18 levels on the card as
         a JAX CPU run gave), then on device-hash (the same counts, 0 levels
         and the JAX package's fallback reason); the trace model (the JAX
         package's default trace, 4 levels on the card); AsyncIsr 4r M3 V3
         and TINY^3 to the end (a level on the card wherever the JAX
         package's plan puts one); each run's host reads a level (1, or 2
         when a level is re-dispatched); then one warm Kip320 level (the
         frontier at depth 12) queued under
         torch.cuda.set_sync_debug_mode("error"): no host sync inside it
  disk-tier  the disk tier (mem_budget), the resource governor and fault
         injection: Kip320 3r E3 (MaxLeaderEpoch 3, 9,985,570 states,
         diameter 31) uncut, in RAM on `host`, then on the tier at a 16M
         budget (runs of 1,048,576 fingerprints) on `fused` and on
         pipeline="device": equal levels and digest chains, at least 9
         spills and 1 merge, disk + hot = every state; K1's launches on
         the tier one a level fewer than in RAM (a spilled frontier is not
         re-fingerprinted); each run's wall, peak device memory and spill
         bytes; the trace model on the tier at 64K with a checkpoint,
         crash@level:4 and resumed: the in-RAM host trace and the JAX
         package's host pin; Kip320 3r at 1M with a merge every 2 runs,
         crash@merge:1 and resumed: 737,794 states and the JAX chain; `cli
         check configs/Kip320.cfg --mem-budget 1M --checkpoint D --fault
         enospc@spill:3 --json` exit 75 with its record, `cli
         verify-checkpoint D --json` ok, the same check without the fault
         exit 0 with 737,794 states, and a --disk-budget of half that run's
         directory exit 75
  obs    the run context (obs/): `cli check configs/Kip320.cfg --run-dir D
         --stats D/stats.jsonl --json` in this process: the record's run_id
         is the manifest's and every stats line's, the stats lines'
         clock-free fields equal the JAX package's CPU run (pinned below),
         one level B/E pair a level, kspec_states_distinct 737794 in
         metrics.prom; `cli report D` and `--json`: complete; the same
         check under `--profile P`: as many device events of K1's
         fingerprint_kernel in the Chrome trace as the wrapper counted;
         `--visited-backend device-hash --run-dir`: 737,794 states, K2
         launched, the gauges present; crash@level:4 with a checkpoint into
         a run directory (manifest at running, the report's stall verdict
         past the timeout), then resumed into it (the run id kept, lineage
         open/reopen/finish, 737,794 states); E3 in RAM on `host` under a
         run context (its timed metrics snapshots); Kip320 3r check() with
         without run=, and with only a stats file, in turns (P S C C S P,
         10 runs a side), the walls' medians and quartiles beside the
         card's name and power limit
  overlap  the overlap layer (overlap.py, check(overlap=)), each path run
         with the layer on and then off, each counted from 0: Kip320 3r with
         no knobs, on `host`, and with a checkpoint every level; E3 on the
         tier at 16M on `fused` and on pipeline="device" (one checkpoint
         after the last level): the same levels and digest chain on both
         sides (the JAX package's pinned chain for Kip320), K1's launches
         and largest launch equal on both sides, K1 held bit for bit at that
         launch, staged_chunks_peak 2 with the layer on where a level has
         more than one chunk and at most 1 off, and each side's wall, the
         checkpoint writer's and merge worker's jobs and the levels' mean
         overlap_efficiency (every earlier phase runs with the layer on,
         the default)
  oracle  the card's engine against the port's reference interpreter
         (oracle/, each model's set-semantics twin, pure Python on the
         host), one decoded level at a time: every level's packed rows
         unpacked on the card, copied to the host once and decoded there,
         equal as a set to the oracle's level.  Kip320 3r (configs/
         Kip320.cfg) with no knobs: 26 levels, 737,794 states, diameter 25,
         every level equal; Kip320FirstTry 3r with StrongIsr only on
         visited_backend="device-hash": StrongIsr at depth 12 in both,
         levels 0-12 equal; configs/AsyncIsr.cfg on visited_backend="host":
         4,088 states, diameter 16, every level equal (its state packs into
         two lanes, so its fingerprint is the state itself and K1 is not
         launched); TruncateToHW 2r (TypeOk, WeakIsr) x 2 on
         pipeline="device": WeakIsr at depth 8, levels 0-8 equal.  Each
         run's oracle wall (and states/s), engine wall and decode wall.
         Meanwhile four commands in subprocesses: `cli oracle configs/
         Kip320.cfg` exit 0 with 737,794 states, diameter 25; `cli oracle
         configs/Kip320FirstTry.cfg` exit 1 with 184,141 states, diameter
         11 and WeakIsr at depth 11 (what the JAX package's `cli oracle`
         prints); `cli analyze --json` exit 0, ok, no HIGH or MEDIUM
         finding, the Kip320 and engine-sources targets; `cli pipelines
         --json` listing device, fused and legacy

Each path run through one check() (main, default, host, first-try-strong,
async-isr on both backends, both products, each device-pipeline run, the
three E3 runs of disk-tier, each check of obs, each side of each overlap
path, each oracle run that launches K1) then
holds K1, and K2 where the
path launched it, against the plain versions at the path's own largest
launch, read from the wrappers' LARGEST: K1 at that (M, K), every row
valid; K2 with that batch size (a table rebuild's, where the table grew)
and with K1's largest M (no smaller than any chunk's batch: a chunk's keys
are rows K1 hashed in one launch), each into a table of the largest
capacity the path grew, holding the path's states less the batch, grown
and re-run on an overflow as check() does.  The phase line names those
shapes; these launches come after the path's counts are read.

A kernel's `ms` is its own time (CUDA events around back-to-back launches),
`route_ms` the entry point's time as check() calls it, host work included.
A kernel's `launches` is its count on the default path (K1) or on the
device-hash path (K2), and `launches_by_path` its count on every path it
runs, each counted from 0 just before that path and read just after.
Then three lines: the kernels as JSON, the card's name and power limit as
nvidia-smi gives them, and the device as JSON.  Exits 1 with no result
when CUDA is not available or the port's package is not beside it.
Checkpoints, stats files and the run directories of every `cli check`
(KSPEC_RUNS_ROOT, unless set) go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# JAX package, check() of configs/Kip320.cfg on the CPU: distinct new
# states per level (the same for every backend and pipeline)
KIP320_LEVELS = [
    1, 6, 30, 138, 366, 1170, 2715, 5673, 10836, 18648, 28818, 40629, 53691,
    66432, 77400, 84072, 85404, 78909, 66447, 49422, 32916, 19542, 9939, 3660,
    834, 96,
]
# JAX package, check() of KafkaTruncateToHighWatermark(3r, L2, R2, E2) with
# StrongIsr only, visited_backend="device-hash", pipeline="legacy",
# compact_shift=0, on the CPU
THW_LEVELS = [1, 6, 36, 207, 837, 2244, 4557, 8937, 17187]
THW_ACTIONS = [
    "<init>", "ControllerElectLeader", "ControllerShrinkIsr", "BecomeLeader",
    "LeaderWrite", "BecomeFollowerTruncateToHighWatermark", "FollowerReplicate",
    "LeaderIncHighWatermark", "BecomeFollowerTruncateToHighWatermark",
]
# the violating state, decoded, with every frozenset as a sorted list
THW_STATE = [
    [[[0, 1]], [], []],
    [[1, 1, 0, [0, 2]], [0, -1, -1, []], [0, 1, 0, [0, 2]]],
    1, 2, [[0, 0, [0, 1, 2]], [1, 0, [0, 2]]], [1, 0, [0, 2]],
]
# the same model, check() with no knobs (sorted `device` set, fused) on the
# CPU: the same levels, the new states of a chunk committed in fingerprint
# order, so another trace
THW_DEFAULT_ACTIONS = [
    "<init>", "ControllerElectLeader", "ControllerShrinkIsr", "BecomeLeader",
    "BecomeFollowerTruncateToHighWatermark", "LeaderWrite", "FollowerReplicate",
    "LeaderIncHighWatermark", "BecomeFollowerTruncateToHighWatermark",
]
THW_DEFAULT_STATE = [
    [[], [[0, 1]], []],
    [[0, -1, -1, []], [1, 1, 1, [1, 2]], [0, 1, 1, [1, 2]]],
    1, 2, [[0, 1, [0, 1, 2]], [1, 1, [1, 2]]], [1, 1, [1, 2]],
]
# the same model, the JAX package's check() with visited_backend="host" on
# the CPU (its reference for the disk tier's trace): the host set commits a
# chunk's new states in candidate order, as the hash table does, so the trace
# is the device-hash pin's
THW_HOST_ACTIONS = [
    "<init>", "ControllerElectLeader", "ControllerShrinkIsr", "BecomeLeader",
    "LeaderWrite", "BecomeFollowerTruncateToHighWatermark", "FollowerReplicate",
    "LeaderIncHighWatermark", "BecomeFollowerTruncateToHighWatermark",
]
THW_HOST_STATE = [
    [[[0, 1]], [], []],
    [[1, 1, 0, [0, 2]], [0, -1, -1, []], [0, 1, 0, [0, 2]]],
    1, 2, [[0, 0, [0, 1, 2]], [1, 0, [0, 2]]], [1, 0, [0, 2]],
]
# Kip320 3r E3 (configs/Kip320.cfg with MaxLeaderEpoch 3): RESULTS.md; on
# the disk tier at a 16M budget, runs of 1,048,576 fingerprints (16 B each)
E3_CONSTANTS = {"MaxLeaderEpoch": 3}
E3_TOTAL = 9_985_570
E3_DIAMETER = 31
E3_BUDGET = "16M"
# JAX package, `cli check configs/Kip320FirstTry.cfg --json --cpu`, with
# seconds, states_per_sec and run_id left out
FIRST_TRY_VERDICT = {
    "schema": "kspec-verdict/1", "model": "Kip320FirstTry(3r,L2,R2,E2)",
    "distinct_states": 184141, "diameter": 11,
    "levels": [1, 6, 36, 207, 837, 2244, 4563, 8991, 17307, 30030, 48150, 71769],
    "violation": {"invariant": "WeakIsr", "depth": 11, "trace_len": 12},
    "exit_code": 1,
}
# JAX package, `cli check configs/Kip320.cfg --max-states 100000 --json
# --stats FILE --cpu`: the record, with seconds, states_per_sec and run_id
# left out, and per stats line (depth, frontier, enabled_candidates, new,
# duplicates, total, action_enablement in the order of KIP320_ACTIONS)
KIP320_MAX_STATES_VERDICT = {
    "schema": "kspec-verdict/1", "model": "Kip320(3r,L2,R2,E2)",
    "distinct_states": 109030, "diameter": 11, "levels": KIP320_LEVELS[:12],
    "violation": None, "exit_code": 0,
}
KIP320_ACTIONS = [
    "ControllerElectLeader", "ControllerShrinkIsr", "BecomeLeader", "FencedLeaderExpandIsr",
    "FencedLeaderShrinkIsr", "LeaderWrite", "FencedLeaderIncHighWatermark",
    "FencedBecomeFollowerAndTruncate", "FencedFollowerFetch",
]
KIP320_MAX_STATES_STATS = [
    (1, 1, 6, 6, 0, 7, [3, 3, 0, 0, 0, 0, 0, 0, 0]),
    (2, 6, 30, 30, 0, 37, [12, 15, 3, 0, 0, 0, 0, 0, 0]),
    (3, 30, 153, 138, 15, 175, [42, 63, 33, 0, 6, 3, 0, 6, 0]),
    (4, 138, 573, 366, 207, 541, [72, 117, 204, 0, 42, 48, 0, 90, 0]),
    (5, 366, 2100, 1170, 930, 1711, [222, 387, 294, 18, 156, 369, 0, 648, 6]),
    (6, 1170, 5889, 2715, 3174, 4426, [429, 786, 924, 144, 432, 1251, 33, 1800, 90]),
    (7, 2715, 13164, 5673, 7491, 10099, [729, 1401, 1701, 414, 1068, 2967, 198, 4014, 672]),
    (8, 5673, 26193, 10836, 15357, 20935, [1101, 2259, 2781, 984, 2400, 5529, 837, 8142, 2160]),
    (9, 10836, 46182, 18648, 27534, 39583,
     [1476, 3294, 4065, 2064, 4590, 8328, 2433, 14562, 5370]),
    (10, 18648, 72645, 28818, 43827, 68401,
     [1773, 4314, 5352, 3972, 7536, 10884, 5592, 23196, 10026]),
    (11, 28818, 103389, 40629, 62760, 109030,
     [2076, 5391, 6225, 6426, 10464, 12867, 10476, 33408, 16056]),
]
# JAX package, check() of configs/Kip320.cfg on the CPU with stats_path:
# per stats line (depth, frontier, enabled_candidates, new, duplicates,
# total, action_enablement in the order of KIP320_ACTIONS)
KIP320_STATS = [
    (1, 1, 6, 6, 0, 7,
     [3, 3, 0, 0, 0, 0, 0, 0, 0]),
    (2, 6, 30, 30, 0, 37,
     [12, 15, 3, 0, 0, 0, 0, 0, 0]),
    (3, 30, 153, 138, 15, 175,
     [42, 63, 33, 0, 6, 3, 0, 6, 0]),
    (4, 138, 573, 366, 207, 541,
     [72, 117, 204, 0, 42, 48, 0, 90, 0]),
    (5, 366, 2100, 1170, 930, 1711,
     [222, 387, 294, 18, 156, 369, 0, 648, 6]),
    (6, 1170, 5889, 2715, 3174, 4426,
     [429, 786, 924, 144, 432, 1251, 33, 1800, 90]),
    (7, 2715, 13164, 5673, 7491, 10099,
     [729, 1401, 1701, 414, 1068, 2967, 198, 4014, 672]),
    (8, 5673, 26193, 10836, 15357, 20935,
     [1101, 2259, 2781, 984, 2400, 5529, 837, 8142, 2160]),
    (9, 10836, 46182, 18648, 27534, 39583,
     [1476, 3294, 4065, 2064, 4590, 8328, 2433, 14562, 5370]),
    (10, 18648, 72645, 28818, 43827, 68401,
     [1773, 4314, 5352, 3972, 7536, 10884, 5592, 23196, 10026]),
    (11, 28818, 103389, 40629, 62760, 109030,
     [2076, 5391, 6225, 6426, 10464, 12867, 10476, 33408, 16056]),
    (12, 40629, 135726, 53691, 82035, 162721,
     [2526, 6633, 7008, 9600, 12798, 14049, 16380, 43440, 23292]),
    (13, 53691, 166455, 66432, 100023, 229153,
     [3000, 7749, 8022, 13128, 14760, 14565, 22089, 52464, 30678]),
    (14, 66432, 192123, 77400, 114723, 306553,
     [3429, 8508, 8712, 17598, 16278, 13989, 26721, 60516, 36372]),
    (15, 77400, 209256, 84072, 125184, 390625,
     [3396, 8163, 9531, 21624, 18096, 12633, 29319, 67248, 39246]),
    (16, 84072, 214368, 85404, 128964, 476029,
     [3099, 7131, 8880, 23976, 20088, 10299, 30171, 71832, 38892]),
    (17, 85404, 205221, 78909, 126312, 554938,
     [2088, 4983, 8007, 25764, 21156, 7806, 28953, 71442, 35022]),
    (18, 78909, 179136, 66447, 112689, 621385,
     [1266, 2988, 5376, 25428, 19878, 5409, 25521, 64824, 28446]),
    (19, 66447, 141561, 49422, 92139, 670807,
     [576, 1338, 3294, 22824, 16008, 2787, 20346, 52764, 21624]),
    (20, 49422, 99258, 32916, 66342, 703723,
     [228, 480, 1524, 18282, 10656, 1008, 15354, 37290, 14436]),
    (21, 32916, 61227, 19542, 41685, 723265,
     [48, 126, 618, 13056, 6360, 162, 9363, 22956, 8538]),
    (22, 19542, 33444, 9939, 23505, 733204,
     [6, 18, 156, 9240, 3036, 12, 5190, 12174, 3612]),
    (23, 9939, 14940, 3660, 11280, 736864,
     [0, 0, 18, 5406, 954, 0, 2286, 4938, 1338]),
    (24, 3660, 5118, 834, 4284, 737698,
     [0, 0, 0, 2598, 276, 0, 678, 1332, 234]),
    (25, 834, 924, 96, 828, 737794,
     [0, 0, 0, 558, 12, 0, 132, 210, 12]),
    (26, 96, 72, 0, 72, 737794,
     [0, 0, 0, 48, 0, 0, 18, 6, 0]),
]
STATS_FIELDS = ("depth", "frontier", "enabled_candidates", "new", "duplicates", "total")
# JAX package, check() of configs/Kip320.cfg with checkpoint_dir on the CPU:
# the digest_chain of its last checkpoint, (count, xor, sum, link) a level
KIP320_CHAIN = [
    (1, 0xA6B28F315173DD33, 0xA6B28F315173DD33, 0xC0330C80E17CFE32),
    (6, 0xFEF7079FA398CAC4, 0x55801BDE4124FB50, 0x9DF70F8EA5A2A21B),
    (30, 0xEEE5D887D2589EED, 0x35165C36F9E704AB, 0x732EFFB42F620CE0),
    (138, 0x6FA4672DEB3EDFC4, 0x34BE496812C47574, 0xE574A273797AC99B),
    (366, 0x8A9B2379A3096111, 0x80852F5FEC2E2FC1, 0x554113A9B57F0480),
    (1170, 0x10459B81B7DF8489, 0x8FCC5C4DF1F002BD, 0xA07617CFA35DEC78),
    (2715, 0xEB01A72F271C0664, 0x9B20217ABCE9973E, 0xBC5849C6C1E13562),
    (5673, 0x3B75129C478349F0, 0x459FC6B077593AB8, 0x6620952505F131EA),
    (10836, 0x8846B6F79B3F4DCB, 0xB5240B36146B7BAD, 0x84975C9B3D8D53D9),
    (18648, 0x81240DC00E8461E1, 0x41E3D6174D776ECF, 0xAB770A9292F2F31C),
    (28818, 0xE0CE9B7D3D826783, 0x4A50652BA510400F, 0x56284D204B322259),
    (40629, 0x608A9EE01F80D438, 0xFF11A97278C98EDC, 0x6C4C46AF60ED66C6),
    (53691, 0xDD1E4FD764F7A853, 0x6652214DF5BB9D19, 0x1E851C36050A79C2),
    (66432, 0x4B8E3E28B6F2E33A, 0x4D6DE5756AF30D90, 0xE39DB9AC371350AE),
    (77400, 0x2E6F6FE2E6E004BF, 0x8A5D16A69B2829E5, 0x7FDC57E2CF99355B),
    (84072, 0xB0170748C8F9C179, 0x710B8D2650A7A0DF, 0xDB883F27DDB0E70D),
    (85404, 0x19A38FFEB0C5D8F8, 0xF288F4C2719A0BF0, 0x7CA022C478FB13A1),
    (78909, 0x2EDCA0B9F51292B2, 0x3781DDE764BD2E5C, 0x00C20C4B57FF294E),
    (66447, 0x4E62335A065346A8, 0x9BE0908BA7445870, 0x2AB0677157A4339E),
    (49422, 0xDBCE8A1F88DA1ABC, 0x508EF82F2CE02834, 0xF9BFD6848ABF94BE),
    (32916, 0x73C37B783E9819C9, 0x3CC1EC1F46075A3D, 0x0F3407F29C04D0D7),
    (19542, 0xAC1041C59C8D4C86, 0x424C58AEBCC7966C, 0xFC54C344967017E4),
    (9939, 0xC5014C296F60BFCA, 0xC59B946BF5EEC5F8, 0xE7A97950F75E8F3F),
    (3660, 0xCDDF200BAF1C0BBD, 0x7D46D3E3D5640F83, 0x2DB91949F7271865),
    (834, 0xA974FF5036640607, 0xA479A68E5AC86663, 0x0D4935DE08EA4FF1),
    (96, 0x9B50DDEFF69C3136, 0xC19685495D38368E, 0x2A66CFFD77374827),
]
# JAX package, check() of configs/Kip320FirstTry.cfg with StrongIsr only,
# no knobs, on the CPU
FIRST_TRY_STRONG_LEVELS = [
    1, 6, 36, 207, 837, 2244, 4563, 8991, 17307, 30030, 48150, 71769, 100662,
]
FIRST_TRY_STRONG_ACTIONS = [
    "<init>", "ControllerElectLeader", "ControllerElectLeader", "ControllerElectLeader",
    "BecomeLeader", "BecomeFollower", "LeaderWrite", "FollowerFetch",
    "LeaderShrinkIsrBetterFencing", "ImprovedLeaderIncHighWatermark", "BecomeFollower",
    "BecomeLeader", "FollowerTruncate",
]
FIRST_TRY_STRONG_STATE = [
    [[], [], [[0, 2]]],
    [[0, 1, 1, [0, 1, 2]], [0, 1, 1, [0, 1, 2]], [1, 2, 2, [0, 2]]],
    1, 3, [[0, 2, [0, 1, 2]], [1, 1, [0, 1, 2]], [2, 2, [0, 1, 2]]], [2, 2, [0, 2]],
]
# JAX package, check() of AsyncIsr(4r, M3, V3) on the CPU (visited_backend
# "host"; the counts do not depend on the knobs)
ASYNC_4R_LEVELS = [
    1, 7, 31, 116, 377, 1082, 2819, 6829, 15413, 32324, 63333, 115993, 197528,
    312282, 458565, 623812, 783474, 907380, 967941, 947673, 847266, 687960,
    503619, 328506, 187557, 91359, 36627, 11493, 2622, 384, 27,
]
# JAX package, `cli check configs/AsyncIsr.cfg --json --cpu`, timing fields
# and run_id left out
ASYNC_CFG_VERDICT = {
    "schema": "kspec-verdict/1", "model": "AsyncIsr(3r,M2,V2)",
    "distinct_states": 4088, "diameter": 16,
    "levels": [1, 5, 16, 42, 92, 171, 282, 414, 535, 614, 620, 536, 390, 232, 104, 30, 4],
    "violation": None, "exit_code": 0,
}
# JAX package, check() of Kip320(2r, L2, R1, E1): the base of the product
TINY_LEVELS = [1, 4, 12, 18, 36, 44, 48, 48, 30, 22, 12, 2]
# JAX package, check() of product_model(TruncateToHW(2r, L2, R1, E1) with
# TypeOk and WeakIsr, 2) with no knobs on the CPU: its levels, the actions
# of its trace, and the sha256 of json.dumps(canon(trace))
PRODUCT_VIOLATION_LEVELS = [1, 8, 44, 172, 520, 1276, 2588, 4488, 6900]
PRODUCT_VIOLATION_ACTIONS = [
    "<init>", "p1.ControllerElectLeader", "p1.BecomeFollowerTruncateToHighWatermark",
    "p1.BecomeLeader", "p1.LeaderWrite", "p1.FollowerReplicate",
    "p1.LeaderIncHighWatermark", "p1.ControllerShrinkIsr",
    "p1.BecomeFollowerTruncateToHighWatermark",
]
PRODUCT_VIOLATION_SHA = "5e2872b44018e2da38fa1fd54093d4811bcf64a35d28dd15d50e9cde843d99fe"
# JAX package, `cli simulate configs/KafkaTruncateToHighWatermark.cfg --walks
# 200 --depth 30 --seed 0 --cpu --hand`: exit 1, WeakIsr at depth 12 after
# 1,673 states; the sha256 of the lines of its rendered trace (91 lines)
SIM_THW_ARGS = ["configs/KafkaTruncateToHighWatermark.cfg", "--walks", "200", "--depth", "30",
                "--seed", "0"]
SIM_THW_HEAD = [
    "Model: KafkaTruncateToHighWatermark(3r,L2,R2,E2)",
    "1673 distinct states found, diameter 0, ",
    "Invariant WeakIsr is VIOLATED at depth 12.",
    "Counterexample trace:",
]
SIM_THW_TRACE_SHA = "bbe403f0f02c486d20d8e347650c438f3dddd07470e9b66e1b5f5dd3df9ffb0e"
# JAX package, `cli simulate configs/Kip320Stretch.cfg --module Kip320
# --walks 10 --depth 50 --seed 0 --cpu --hand`: exit 0 and this line, up to
# its rate
SIM_STRETCH_ARGS = ["configs/Kip320Stretch.cfg", "--module", "Kip320", "--walks", "10",
                    "--depth", "50", "--seed", "0"]
SIM_STRETCH_LINE = "Simulation: 10 walks x depth 50, 498 states visited, no violations ("
# levels run device-resident at check()'s default knobs: Kip320.cfg
# (`device` and `host`) and the trace model from the JAX package's
# check(pipeline="device") on the CPU; AsyncIsr 4r M3 V3 and TINY^3 from
# the JAX package's DevicePipeline.plan_level applied to their pinned
# level sizes (chunk 32768, min_bucket 256, compact_shift 2, gate 4096),
# which gives 18 and 4 for the first two as well
KIP320_DEVICE_LEVELS = 18
THW_DEVICE_LEVELS = 4
ASYNC_4R_DEVICE_LEVELS = 23
TINY_DEVICE_LEVELS = 26
# the `cli oracle` lines, as the JAX package's `cli oracle` printed them on
# the CPU (the rate aside)
ORACLE_KIP320_HEAD = "Oracle: 737794 distinct states, diameter 25, "
ORACLE_FIRST_TRY_HEAD = "Oracle: 184141 distinct states, diameter 11, "
ORACLE_FIRST_TRY_VIOLATION = "Invariant WeakIsr is VIOLATED at depth 11."
# the knobs of the path before the sorted backend was ported
HASH_KNOBS = dict(visited_backend="device-hash", pipeline="legacy", compact_shift=0)
# where checkpoints and stats files go: inside the checkout, gitignored
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"

DEV = torch.device("cuda")


def canon(x):
    if isinstance(x, frozenset):
        return sorted(canon(v) for v in x)
    if isinstance(x, (tuple, list)):
        return [canon(v) for v in x]
    return x


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            detail = fn()
        except Exception as e:  # noqa: BLE001 - report every phase
            self.failed.append(name)
            print(f"[{name}] FAIL after {time.perf_counter() - t0:.1f}s: "
                  f"{type(e).__name__}: {e}", flush=True)
            return None
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s: {detail['line']}",
              flush=True)
        return detail


def phase_build():
    from kafka_specification_tpu_torch.ops import build

    paths = build.build_all()
    regs = []
    for name in paths:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line:
                regs.append(f"{name}: {line.split('info    : ')[-1].strip()}")
    return {"line": f"built {', '.join(sorted(paths))}; " + "; ".join(regs)}


def _kernel_entry(name, source, replaces, err, t):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "max_abs_err": err,
        "ms": t["own_ms"],
        "route_ms": t["route_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }


def _time_line(t):
    return (f"own {t['own_ms']:.4f} ms, route {t['route_ms']:.4f} ms "
            f"(min {t['route_spread']['min']:.4f}, max {t['route_spread']['max']:.4f}), "
            f"host {t['host_us']:.1f} us a launch, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.3f} ms")


def phase_k1():
    from kafka_specification_tpu_torch.ops import cuda_fingerprint as k1
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    checked, err = [], 0
    for m, k, invalid in ((kt.K1_M, kt.K1_K, 0.0), (32768 * 51, 3, 0.1), (65537, 7, 0.1)):
        lanes, valid = kt.k1_inputs(DEV, m, k, invalid=invalid)
        hi, lo = k1.fingerprint(lanes, valid)
        p_hi, p_lo = k1.fingerprint_plain(lanes, valid)
        torch.cuda.synchronize()
        diff = max(int((hi - p_hi).abs().max()), int((lo - p_lo).abs().max()))
        if diff:
            raise AssertionError(f"K1 differs from its plain version at M={m} K={k} "
                                 f"(max |diff| {diff})")
        err = max(err, diff)
        checked.append(f"M={m} K={k} invalid={m - int(valid.sum())}")
    t = kt.k1_times(*kt.k1_inputs(DEV))
    return {
        "line": f"bit-identical at {'; '.join(checked)}; {_time_line(t)}",
        "kernel": _kernel_entry(
            "fingerprint", "kafka_specification_tpu_torch/ops/csrc/fingerprint.cu",
            "kafka_specification_tpu/ops/pallas_fingerprint.py:41", err, t),
    }


def _members(table):
    return torch.sort(table[table != -1]).values


def _k2_same(t_plain, t_kern, q, valid, what):
    """One call of the plain version and one of the kernel, each on its own
    table: winners, count and membership identical, no overflow."""
    from kafka_specification_tpu_torch.ops import cuda_hashset as k2
    from kafka_specification_tpu_torch.ops import hashset

    _, p_new, p_n, p_ovf = hashset.probe_insert(t_plain, q, valid)
    _, k_new, k_n, k_ovf = k2.probe_insert(t_kern, q, valid)
    if bool(p_ovf) or k_ovf:
        raise AssertionError(f"{what}: overflowed")
    if not torch.equal(p_new, k_new):
        raise AssertionError(f"{what}: K2 winners differ ({int(k_new.sum())} vs "
                             f"{int(p_new.sum())} new)")
    if int(p_n) != k_n or not torch.equal(_members(t_plain), _members(t_kern)):
        raise AssertionError(f"{what}: K2 count or membership differs from its plain version")


def _insert_as_check(insert, table, q):
    """`insert` (the kernel's or the plain probe_insert) as check()'s
    device-hash set calls it: on an overflow the table is doubled and the
    batch re-run, the novelty OR-ed.  -> (growths, novelty, sorted members,
    new keys summed over the runs)."""
    from kafka_specification_tpu_torch.ops import hashset

    isnew = torch.zeros(q.shape[0], dtype=torch.bool, device=DEV)
    rounds = total = 0
    while True:
        table, new, n, ovf = insert(table, q)
        isnew |= new
        total += int(n)
        if not bool(ovf):
            return rounds, isnew, _members(table), total
        rounds += 1
        table = hashset.rehash_into(table, 2 * table.shape[0])


def phase_k2():
    from kafka_specification_tpu_torch.ops import cuda_hashset as k2
    from kafka_specification_tpu_torch.ops import hashset
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    table0, q, valid = kt.k2_fixture(DEV)
    m = q.shape[0]
    _k2_same(table0.clone(), table0.clone(), q, valid, f"cap 2^22 M={m}")

    # two tables of one capacity, five calls each in turn: the claim code
    # falls every call, the claim words are shared and never reset; the
    # batches draw from the fixture's keys (duplicates, seeded keys), every
    # third call with no mask; then M = 1 and M = 0
    rng = np.random.default_rng(7)
    tables = [(table0.clone(), table0.clone()) for _ in range(2)]
    for call in range(10):
        sel = torch.from_numpy(rng.integers(0, m, size=20000)).to(DEV)
        _k2_same(*tables[call % 2], q[sel], None if call % 3 == 0 else valid[sel],
                 f"call {call} on table {call % 2}")
    for n in (1, 0):
        _k2_same(*tables[0], q[:n], None, f"M={n}")

    # overflow: 4096 distinct keys into 1024 slots, grown and re-run
    small_q = kt.keys(np.random.default_rng(6), 4096, DEV)
    (p_rounds, p_isnew, p_mem, p_total), (k_rounds, k_isnew, k_mem, k_total) = (
        _insert_as_check(insert, hashset.new_table(1024, DEV), small_q)
        for insert in (hashset.probe_insert, k2.probe_insert))
    if k_rounds == 0 or p_rounds == 0:
        raise AssertionError("the tiny table did not overflow")
    if not (torch.equal(p_isnew, k_isnew) and torch.equal(p_mem, k_mem)):
        raise AssertionError("grow-and-rerun novelty differs after overflow")
    if k_total != int(k_isnew.sum()) or p_total != k_total:
        raise AssertionError(f"counts summed over re-runs differ: {k_total}, {p_total}")

    t = kt.k2_times(table0, q)
    kernel = _kernel_entry(
        "hash_probe_insert", "kafka_specification_tpu_torch/ops/csrc/hashset.cu",
        "kafka_specification_tpu/ops/pallas_hashset.py:380", 0, t)
    kernel["also_replaces"] = "kafka_specification_tpu/ops/pallas_hashset.py:313"
    return {
        "line": f"cap=2^22 M={m} winners/count/membership identical; "
                f"10 calls on two tables in turn, M=1, M=0 identical; overflow re-run "
                f"identical ({k_rounds} growths); no mask: new={t['n_new']}, {_time_line(t)}",
        "kernel": kernel,
        "times": t,
    }


def _k2_split(k2, vec):
    """K2's route split by the ladder's launch floor, all from this run.

    A call as check() makes it puts the cooperative kernel on the card and
    reads its two counts back (one 8-byte copy).  Its route time (events
    around one call on an idle card) less its own time (events around
    back-to-back launches, the host's time kept out) is the host's work
    before the launch plus the read, beside the host's time a launch() call
    by the host's clock; its own time less one launch-to-launch floor (K4's
    `vec` rung launched back to back from C) is the kernel's own work."""
    floor = vec["back_to_back_ms"]
    return {
        "k2_route_ms": k2["route_ms"],
        "k2_own_ms": k2["own_ms"],
        "k2_host_work_and_read_ms": k2["route_ms"] - k2["own_ms"],
        "k2_host_us_a_launch": k2["host_us"],
        "ops_on_card": "1 kernel + 1 copy of 8 bytes",
        "launch_floor_ms": floor,
        "k2_own_work_ms": k2["own_ms"] - floor,
    }


def _rung_edges():
    """{label: int64 u32 input} held bit for bit against the plain versions:
    sizes past the 16-byte vectors' tail, the edges of pos and of u32."""
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    rng = np.random.default_rng(11)
    top = np.full(256, 0xFFFFFFFF, dtype=np.uint32)
    top[0] = 0x80000000
    small = lambda n, x0: np.concatenate(
        [[x0], rng.integers(0, 2**32, size=n - 1, dtype=np.uint32)])
    edges = {f"n={n}": kt.ladder_input(n, DEV, seed=n) for n in (65536, 1 << 24, (1 << 24) + 3)}
    for label, arr in {
        "n=4 x[0]=6": small(4, 6),            # the clamp: pos = 3
        "n=7 x[0]=6 (pos in the tail)": small(7, 6),
        "n=9 x[0]=6 (pos in the last vector)": small(9, 6),
        "n=3 x[0]=2 (all tail)": small(3, 2),
        "x[0]=2^31, rest 2^32-1": top,       # unsigned remainder, wrap
    }.items():
        edges[label] = torch.from_numpy(arr.astype(np.int64)).to(DEV)
    return edges


def phase_k4(k2):
    from kafka_specification_tpu_torch.ops import cuda_ladder as k4
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    for rung in k4.RUNGS:
        k4.LAUNCHES[rung] = 0
    recs = k4.run_ladder(DEV, kt.LADDER_N)  # the TPU script's path: arange(256)
    large = k4.run_ladder(DEV, kt.LADDER_LARGE_N)  # arange(2^24): 134 MB a pass
    for n, rs in ((kt.LADDER_N, recs), (kt.LADDER_LARGE_N, large)):
        bad = [f"{r['rung']}: {r['error'] or 'max |diff| %s' % r['max_abs_err']}"
               for r in rs if not (r["ok"] and r["bits_equal"])]
        if bad:
            raise AssertionError(f"rungs failed at n={n}: {bad}")
        if any(r["launches"] != 1 for r in rs):
            raise AssertionError(f"a rung was not launched: {[r['launches'] for r in rs]}")
        if any(r["library_bits_equal"] is False for r in rs):
            raise AssertionError("a library call's bits differ from the plain version")

    edges = _rung_edges()
    # an int32 view one element into its storage: off the 16-byte boundary
    base = kt.ladder_input((1 << 24) + 1, DEV, seed=13)
    views = {label: (k4.to_i32(x), x) for label, x in edges.items()}
    views["unaligned view, n=2^24"] = (k4.to_i32(base)[1:], base[1:])
    views["unaligned view, n=9"] = (k4.to_i32(base[:10])[1:], base[1:10])
    for label, (x32, x) in views.items():
        for rung in k4.RUNGS:
            got = k4.from_i32(k4.launch(rung, x32))
            torch.cuda.synchronize()
            if not torch.equal(got, k4.PLAIN[rung](x)):
                raise AssertionError(f"{rung} differs from its plain version at {label}")

    split = kt.host_split()
    if k2 is None:
        raise AssertionError("the rungs passed, but K2 failed: no time to split")
    k2_split = _k2_split(k2["times"], recs[0])
    kernels = []
    for r, big in zip(recs, large):
        kernels.append({
            "name": f"ladder_{r['rung']}",
            "route": "cuda",
            "source": "kafka_specification_tpu_torch/ops/csrc/ladder.cu",
            "replaces": k4.REPLACES[r["rung"]],
            # own time: launches back to back from C; route: launch() from Python
            "ms": r["back_to_back_ms"],
            "route_ms": r["ms"],
            **{key: r[key] for key in (
                "launches", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "host_us_per_launch")},
            "large_n": kt.LADDER_LARGE_N,
            "large_n_ms": big["back_to_back_ms"],
            "large_n_route_ms": big["ms"],
            "large_n_host_us_per_launch": big["host_us_per_launch"],
            "large_n_bound_ms": big["bound_ms"],
            "large_n_plain_ms": big["plain_ms"],
            "large_n_library_ms": big["library_ms"],
        })

    def times(rs):
        return "; ".join(
            f"{r['rung']} own {r['back_to_back_ms']:.4f} ms, route {r['ms']:.4f}, "
            f"host {r['host_us_per_launch']:.1f} us, library "
            + ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
            for r in rs)

    return {
        "line": f"6 rungs bit-identical at n=256, n=2^24 (arange), {', '.join(views)}; "
                f"n=256 (bound {recs[0]['bound_ms']:.2e} ms): {times(recs)}; "
                f"n=2^24 (bound {large[0]['bound_ms']:.4f} ms): {times(large)}; "
                f"host split (us a call, medians): {kt.split_line(split)}; "
                f"k2_split {json.dumps(k2_split)}",
        "kernels": kernels,
    }


def _reset_counts():
    from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset

    cuda_fingerprint.LAUNCHES = 0
    cuda_hashset.LAUNCHES = 0
    cuda_fingerprint.LARGEST = (0, 0)
    cuda_hashset.LARGEST = (0, 0)


def _read_counts(path_kernels):
    """The launch counts since _reset_counts; every kernel of the path
    (`path_kernels`) must have been launched, and no other."""
    from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset

    counts = {"fingerprint": cuda_fingerprint.LAUNCHES,
              "hash_probe_insert": cuda_hashset.LAUNCHES}
    if any(bool(n) != (name in path_kernels) for name, n in counts.items()):
        raise AssertionError(f"launches {counts}, but the path's kernels are {path_kernels}")
    return counts


def _k2_filled(cap, m, fill, seed=8):
    """-> (table0, keys): a k2_batch of m keys (in-batch duplicates), its
    first eighth in a table of `cap` slots that holds `fill` other random
    keys besides, all put there by the plain version (a key past its probe
    budget is left out: the fill's load only has to match the run's)."""
    from kafka_specification_tpu_torch.ops import hashset
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    rng = np.random.default_rng(seed)
    q = kt.k2_batch(rng, m, DEV)
    seeded = torch.cat([kt.keys(rng, fill, DEV), q[: m // 8]])
    table = hashset.new_table(cap, DEV)
    for start in range(0, seeded.shape[0], 1 << 20):
        table = hashset.probe_insert(table, seeded[start : start + (1 << 20)])[0]
    return table, q


def _hold_path_shapes(shapes, total):
    """K1, and K2 where the path launched it, against their plain versions
    at the path's largest launch (launches made here are not the path's):
    K1 at its largest (M, K), every row valid as check() passes them; K2 on
    its largest batch, and on K1's largest M (which bounds every chunk's
    batch), each into a table of the largest capacity the path grew,
    holding the path's `total` states less the batch, as check() calls it
    (no mask; on an overflow, doubled and re-run).  -> the phase line's
    note of the shapes."""
    from kafka_specification_tpu_torch.ops import cuda_fingerprint as k1
    from kafka_specification_tpu_torch.ops import cuda_hashset as k2
    from kafka_specification_tpu_torch.ops import hashset
    from kafka_specification_tpu_torch.utils import kernel_times as kt

    m, k = shapes["fingerprint"]
    lanes, valid = kt.k1_inputs(DEV, m, k, seed=m)
    (hi, lo), (p_hi, p_lo) = k1.fingerprint(lanes, valid), k1.fingerprint_plain(lanes, valid)
    if not (torch.equal(hi, p_hi) and torch.equal(lo, p_lo)):
        raise AssertionError(f"K1 differs from its plain version at the path's M={m} K={k}")
    note = f"K1 bit-identical at the path's largest launch M={m} K={k}"
    cap, m2 = shapes["hash_probe_insert"]
    # the largest batch (a rebuild's, when the table grew), and K1's largest
    # M, which bounds every chunk's batch (a chunk's keys are rows K1 hashed)
    for m_k2 in sorted({m2, m} if cap else ()):
        table0, q = _k2_filled(cap, m_k2, max(0, total - m_k2))
        fill = int((table0 != hashset.SENT_KEY).sum())
        (p_rounds, p_isnew, p_mem, p_total), (k_rounds, k_isnew, k_mem, k_total) = (
            _insert_as_check(insert, table0.clone(), q)
            for insert in (hashset.probe_insert, k2.probe_insert))
        if not (torch.equal(p_isnew, k_isnew) and torch.equal(p_mem, k_mem)
                and p_total == k_total == int(k_isnew.sum())):
            raise AssertionError(f"K2 differs from its plain version at the path's cap={cap} "
                                 f"M={m_k2} (table holding {fill})")
        note += (f"; K2 winners/count/membership identical at the path's cap={cap} M={m_k2}, "
                 f"table holding {fill} (new {k_total}, growths {k_rounds} / plain {p_rounds})")
    return note


def _largest():
    """The wrappers' largest launches since _reset_counts."""
    from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset

    return {"fingerprint": cuda_fingerprint.LARGEST, "hash_probe_insert": cuda_hashset.LARGEST}


def _timed_check(model, path_kernels, **knobs):
    """check() on the card with the launch counts from 0, then the path's
    kernels held at its largest launch: (result, wall, counts, note)."""
    from kafka_specification_tpu_torch import check

    _reset_counts()
    t0 = time.perf_counter()
    res = check(model, device=DEV, **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(path_kernels)
    return res, wall, counts, _hold_path_shapes(_largest(), res.total)


def _crashed_check(model, fault, path_kernels, **knobs):
    """check() on the card under the fault plan `fault`, which must stop it
    with InjectedCrash, the launch counts from 0; then the path's kernels
    held at its largest launch: (counts, note)."""
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.resilience.faults import InjectedCrash

    _reset_counts()
    os.environ["KSPEC_FAULT"] = fault
    try:
        check(model, device=DEV, **knobs)
        raise AssertionError(f"{fault} did not fire")
    except InjectedCrash:
        pass
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    counts = _read_counts(path_kernels)
    return counts, _hold_path_shapes(_largest(), 0)


def _cli_check_counted(args, want_rc, path_kernels=("fingerprint",)):
    """`cli check args` in this process, so that its launches are counted
    (from 0), then the path's kernels held at their largest launch: (the
    JSON record, wall, counts, note)."""
    from kafka_specification_tpu_torch import cli

    _reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["check", *args])
    finally:
        os.environ.pop("KSPEC_FAULT", None)  # --fault exports it into the process
    wall = time.perf_counter() - t0
    if rc != want_rc:
        raise AssertionError(f"cli check {args}: exit {rc}, expected {want_rc}")
    counts = _read_counts(path_kernels)
    rec = json.loads(out.getvalue().splitlines()[-1])
    return rec, wall, counts, _hold_path_shapes(_largest(), rec["distinct_states"] or 0)


def _kip320(knobs, path_kernels):
    """configs/Kip320.cfg through check() on the card with `knobs`."""
    from kafka_specification_tpu_torch import build_model, load_config

    model = build_model("Kip320", load_config("configs/Kip320.cfg"))
    res, wall, counts, held = _timed_check(model, path_kernels, **knobs)
    if not res.ok or res.total != 737_794 or res.diameter != 25:
        raise AssertionError(f"ok={res.ok} total={res.total} diameter={res.diameter}")
    if res.levels != KIP320_LEVELS:
        raise AssertionError(f"per-level counts differ: {res.levels}")
    stats = {k: res.stats[k] for k in ("visited_backend", "pipeline", "visited_capacity",
                                       "hash_table_capacity") if k in res.stats}
    return {
        "line": f"Kip320 3r ok, {res.total} states, diameter 25, levels as pinned; "
                f"{wall:.2f} s wall, {res.total / wall:.0f} states/s; "
                f"launches {counts}; {stats}; {held}",
        "counts": counts,
    }


def phase_main():
    return _kip320(HASH_KNOBS, ("fingerprint", "hash_probe_insert"))


def phase_default():
    return _kip320({}, ("fingerprint",))


def _trace(knobs, path_kernels, actions, state):
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.models import variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config

    model = variants.make_model(
        "KafkaTruncateToHighWatermark", Config(3, 2, 2, 2), invariants=("StrongIsr",)
    )
    _reset_counts()
    res = check(model, device=DEV, **knobs)
    counts = _read_counts(path_kernels)
    v = res.violation
    if v is None or (v.invariant, v.depth) != ("StrongIsr", 8):
        raise AssertionError(f"expected StrongIsr at depth 8, got {v and (v.invariant, v.depth)}")
    if res.levels != THW_LEVELS:
        raise AssertionError(f"levels differ: {res.levels}")
    if [a for a, _ in v.trace] != actions:
        raise AssertionError(f"trace actions differ: {[a for a, _ in v.trace]}")
    if canon(v.state) != state:
        raise AssertionError(f"violating state differs: {canon(v.state)}")
    return {"line": f"StrongIsr violated at depth 8, trace as pinned "
                    f"({res.stats['visited_backend']}, {res.stats['pipeline']}); launches {counts}"}


def phase_trace():
    return _trace(HASH_KNOBS, ("fingerprint", "hash_probe_insert"), THW_ACTIONS, THW_STATE)


def phase_trace_default():
    return _trace({}, ("fingerprint",), THW_DEFAULT_ACTIONS, THW_DEFAULT_STATE)


def phase_host():
    return _kip320({"visited_backend": "host"}, ("fingerprint",))


def phase_resume():
    """Kip320 3r checkpointed every level, cut at depth 12 and resumed by a
    fresh check(), per backend; the newest checkpoint's digest chain must
    be the JAX package's."""
    from kafka_specification_tpu_torch import build_model, check, load_config
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    want = np.array(KIP320_CHAIN, dtype=np.uint64)
    parts = []
    for backend, path_kernels in (("device", ("fingerprint",)),
                                  ("device-hash", ("fingerprint", "hash_probe_insert")),
                                  ("host", ("fingerprint",))):
        ckpt = WORK / f"resume-{backend}"
        shutil.rmtree(ckpt, ignore_errors=True)
        _reset_counts()
        walls, results = [], []
        for leg in (dict(max_depth=12), {}):
            model = build_model("Kip320", load_config("configs/Kip320.cfg"))
            t0 = time.perf_counter()
            results.append(check(model, device=DEV, visited_backend=backend,
                                 checkpoint_dir=str(ckpt), **leg))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = _read_counts(path_kernels)
        cut, res = results
        if not cut.ok or cut.levels != KIP320_LEVELS[:13]:
            raise AssertionError(f"{backend}: the cut leg gave {cut.levels}")
        if not res.ok or res.levels != KIP320_LEVELS or res.diameter != 25:
            raise AssertionError(f"{backend}: the resumed leg gave {res.levels}")
        chain = verify_file(str(ckpt / CHECKPOINT_BASENAME))["digest_chain"]
        if chain.shape != want.shape or not np.array_equal(chain, want):
            bad = [d for d in range(min(len(chain), len(want)))
                   if not np.array_equal(chain[d], want[d])]
            raise AssertionError(f"{backend}: digest chain {chain.shape} differs from the JAX "
                                 f"package's at levels {bad[:5]}")
        parts.append(f"{backend} {walls[0]:.2f} s + {walls[1]:.2f} s, launches {counts}")
    return {"line": f"Kip320 3r cut at depth 12 and resumed to {res.total} states, diameter 25; "
                    f"chain equal to the JAX package's on all three ({'; '.join(parts)})"}


def phase_first_try_strong():
    from kafka_specification_tpu_torch import build_model, load_config

    cfg = load_config("configs/Kip320FirstTry.cfg")
    cfg.invariants = ["StrongIsr"]
    res, wall, counts, held = _timed_check(build_model("Kip320FirstTry", cfg), ("fingerprint",))
    v = res.violation
    if v is None or (v.invariant, v.depth, res.total) != ("StrongIsr", 12, 284_803):
        raise AssertionError(f"expected StrongIsr at depth 12 after 284803 states, got "
                             f"{v and (v.invariant, v.depth)} after {res.total}")
    if res.levels != FIRST_TRY_STRONG_LEVELS:
        raise AssertionError(f"levels differ: {res.levels}")
    if [a for a, _ in v.trace] != FIRST_TRY_STRONG_ACTIONS:
        raise AssertionError(f"trace actions differ: {[a for a, _ in v.trace]}")
    if canon(v.state) != FIRST_TRY_STRONG_STATE:
        raise AssertionError(f"violating state differs: {canon(v.state)}")
    return {"line": f"Kip320FirstTry StrongIsr violated at depth 12 after {res.total} states, "
                    f"trace as pinned; {wall:.2f} s; launches {counts}; {held}"}


def stats_fields(rec):
    """The fields of a per-level stats record that do not depend on timing."""
    return {k: rec[k] for k in ("kind", *STATS_FIELDS, "action_enablement")}


def kip320_stats():
    """KIP320_STATS as the records' deterministic fields."""
    return [{"kind": "level", **dict(zip(STATS_FIELDS, row[:6])),
             "action_enablement": dict(zip(KIP320_ACTIONS, row[6]))}
            for row in KIP320_STATS]


def max_states_stats():
    """KIP320_MAX_STATES_STATS as the records' deterministic fields."""
    return [{"kind": "level", **dict(zip(STATS_FIELDS, row[:6])),
             "action_enablement": dict(zip(KIP320_ACTIONS, row[6]))}
            for row in KIP320_MAX_STATES_STATS]


def _run_cli(cmd, args, want_rc):
    """`python -m kafka_specification_tpu_torch.cli cmd args` in a
    subprocess: (stdout, process wall)."""
    argv = [sys.executable, "-m", "kafka_specification_tpu_torch.cli", cmd, *args]
    t0 = time.perf_counter()
    out = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != want_rc:
        raise AssertionError(f"{cmd} {args}: exit {out.returncode}, expected {want_rc}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout, wall


def _cli(args, want_rc):
    stdout, wall = _run_cli("check", args, want_rc)
    rec = json.loads(stdout.splitlines()[-1])
    got = {k: v for k, v in rec.items() if k not in ("seconds", "states_per_sec", "run_id")}
    return rec, got, wall


def phase_cli():
    rec, got, wall = _cli(["configs/Kip320FirstTry.cfg", "--json"], 1)
    if got != FIRST_TRY_VERDICT:
        raise AssertionError(f"verdict differs from the JAX package's: {got}")
    WORK.mkdir(parents=True, exist_ok=True)
    stats = WORK / "cli-stats.jsonl"
    stats.unlink(missing_ok=True)
    rec2, got2, wall2 = _cli(["configs/Kip320.cfg", "--max-states", "100000", "--json",
                              "--stats", str(stats)], 0)
    if got2 != KIP320_MAX_STATES_VERDICT:
        raise AssertionError(f"--max-states record differs from the JAX package's: {got2}")
    with open(stats) as fh:
        lines = [stats_fields(json.loads(line)) for line in fh]
    if lines != max_states_stats():
        bad = [i for i, (a, b) in enumerate(zip(lines, max_states_stats())) if a != b]
        raise AssertionError(f"stats lines differ from the JAX package's ({len(lines)} lines, "
                             f"first differing {bad[:3]})")
    return {"line": f"Kip320FirstTry: WeakIsr at depth 11, {rec['distinct_states']} states, "
                    f"record as pinned, exit 1; check {rec['seconds']} s, process {wall:.1f} s; "
                    f"Kip320 --max-states 100000: {rec2['distinct_states']} states at depth "
                    f"{rec2['diameter']}, record and {len(lines)} stats lines as pinned, exit 0; "
                    f"check {rec2['seconds']} s, process {wall2:.1f} s"}


def phase_async_isr():
    """AsyncIsr 4r M3 V3 from configs/AsyncIsr.cfg's constants widened, on
    the default path and on device-hash; then `cli check` of the .cfg."""
    from kafka_specification_tpu_torch import build_model, load_config

    cfg = load_config("configs/AsyncIsr.cfg")
    cfg.constants.update(Replicas=["b1", "b2", "b3", "b4"], MaxOffset=3, MaxVersion=3)
    parts, counts = [], {}
    for backend, path_kernels in (("device", ("fingerprint",)),
                                  ("device-hash", ("fingerprint", "hash_probe_insert"))):
        knobs = {} if backend == "device" else {"visited_backend": backend}
        model = build_model("AsyncIsr", cfg)
        res, wall, counts[backend], held = _timed_check(model, path_kernels, **knobs)
        if (res.model, res.ok, res.total, res.diameter) != ("AsyncIsr(4r,M3,V3)", True,
                                                            8_134_400, 30):
            raise AssertionError(f"{backend}: {res.model} ok={res.ok} total={res.total} "
                                 f"diameter={res.diameter}")
        if res.levels != ASYNC_4R_LEVELS:
            raise AssertionError(f"{backend}: per-level counts differ: {res.levels}")
        parts.append(f"{backend} {wall:.2f} s, {res.total / wall:.0f} states/s, "
                     f"{res.stats['lanes']} lanes, launches {counts[backend]}, "
                     f"{ {k: res.stats[k] for k in res.stats if 'capacity' in k} }; {held}")
    rec, got, wall = _cli(["configs/AsyncIsr.cfg", "--json"], 0)
    if got != ASYNC_CFG_VERDICT:
        raise AssertionError(f"AsyncIsr.cfg record differs from the JAX package's: {got}")
    return {"line": f"AsyncIsr 4r M3 V3 ok, 8134400 states, diameter 30, levels as pinned: "
                    f"{'; '.join(parts)}; cli check configs/AsyncIsr.cfg: record as pinned, "
                    f"exit 0, check {rec['seconds']} s, process {wall:.1f} s",
            "counts": counts}


def phase_product():
    """TINY^3 to the end against the closed form; a product violation's
    trace against the JAX pin."""
    import hashlib

    from kafka_specification_tpu_torch.models import kip320, variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config
    from kafka_specification_tpu_torch.models.product import product_model

    want = np.convolve(np.convolve(TINY_LEVELS, TINY_LEVELS), TINY_LEVELS).tolist()
    model = product_model(kip320.make_model(Config(2, 2, 1, 1), (
        "TypeOk", "LeaderInIsr", "WeakIsr", "StrongIsr")), 3)
    res, wall, counts, held = _timed_check(model, ("fingerprint",))
    if (res.ok, res.total, res.diameter) != (True, 21_253_933, 33):
        raise AssertionError(f"TINY^3: ok={res.ok} total={res.total} diameter={res.diameter}")
    if res.levels != want:
        raise AssertionError(f"TINY^3 per-level counts differ from the closed form: {res.levels}")
    base = variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1),
                               ("TypeOk", "WeakIsr"))
    vres, vwall, vcounts, vheld = _timed_check(product_model(base, 2), ("fingerprint",))
    v = vres.violation
    if v is None or (v.invariant, v.depth, vres.total) != ("WeakIsr", 8, 15_997):
        raise AssertionError(f"expected WeakIsr at depth 8 after 15997 states, got "
                             f"{v and (v.invariant, v.depth)} after {vres.total}")
    if vres.levels != PRODUCT_VIOLATION_LEVELS:
        raise AssertionError(f"levels differ: {vres.levels}")
    if [a for a, _ in v.trace] != PRODUCT_VIOLATION_ACTIONS:
        raise AssertionError(f"trace actions differ: {[a for a, _ in v.trace]}")
    sha = hashlib.sha256(json.dumps(canon(v.trace)).encode()).hexdigest()
    if sha != PRODUCT_VIOLATION_SHA:
        raise AssertionError(f"the trace differs from the JAX package's (sha256 {sha})")
    return {"line": f"TINY^3 ok, {res.total} states, diameter 33, levels = the closed form; "
                    f"{wall:.2f} s, {res.total / wall:.0f} states/s, {res.stats['lanes']} "
                    f"lanes, launches {counts}; {held}; TruncateToHW 2r x 2: WeakIsr at depth 8 "
                    f"after {vres.total} states, trace as pinned, {vwall:.2f} s, launches "
                    f"{vcounts}; {vheld}",
            "counts": counts, "violation_counts": vcounts}


class _RecordingPipelines:
    """Within the block, every DevicePipeline check() makes records its host
    reads, one count per level run on the card."""

    def __enter__(self):
        from kafka_specification_tpu_torch.engine import bfs, pipeline

        made = self.made = []

        class Recording(pipeline.DevicePipeline):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.level_reads = []
                made.append(self)

            def run_level(self, *a, **k):
                out = super().run_level(*a, **k)
                self.level_reads.append(out.reads)
                return out

        self._bfs, self._real = bfs, bfs.DevicePipeline
        bfs.DevicePipeline = Recording
        return self

    def __exit__(self, *exc):
        self._bfs.DevicePipeline = self._real
        return False

    def reads(self) -> str:
        reads = self.made[-1].level_reads
        return (f"host reads a level: {reads.count(1)} levels x 1, "
                f"{reads.count(2)} x 2 (re-dispatched)")


def _device_stats(res, levels):
    got = res.stats.get("device")
    if res.stats["pipeline"] != "device" or got != {"levels": levels, "fallback": None}:
        raise AssertionError(f"pipeline {res.stats['pipeline']}, stats['device'] {got}, "
                             f"expected {levels} levels and no fallback")


def _sync_free_level(model):
    """Queue one warm Kip320 level (the frontier at depth 12, two chunks)
    under torch.cuda.set_sync_debug_mode("error"): any host
    synchronisation inside the chunks raises.  The level is read afterwards
    and must equal a run queued the ordinary way."""
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.engine import bfs
    from kafka_specification_tpu_torch.engine.pipeline import DevicePipeline
    from kafka_specification_tpu_torch.ops import devlevel

    levels = []
    check(model, device=DEV, pipeline="device", max_depth=12, collect_levels=levels,
          store_trace=False)
    frontier = levels[12]
    visited = bfs._SortedVisited.fresh(*bfs.fp_stage(model.spec, torch.cat(levels)),
                                       next_pow2_cap(sum(x.shape[0] for x in levels)))
    pipe = DevicePipeline(model, "device", True, False, 2, 4096)
    B, nc, handled = pipe.plan_level(frontier.shape[0], 32768, 256)
    # the widths this level needs, measured by one run at the first rung
    widths = pipe.widths(B)
    LN = devlevel.level_new_bound(nc * sum(widths))
    visited.reserve(LN + sum(widths))
    first = pipe.read_level(pipe.queue_level(frontier, handled, B, nc, widths, LN, visited.keys))
    widths = pipe.widths(B, first[5].astype(np.float64))
    T = sum(widths)
    LN = devlevel.level_new_bound(nc * T)
    visited.reserve(LN + T)
    runs = []
    for debug in (False, True):
        torch.cuda.synchronize()
        if debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = pipe.queue_level(frontier, handled, B, nc, widths, LN, visited.keys)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs.append(pipe.read_level(st))
    (ovf, kind, _, _, on, *_), again = runs
    if ovf or kind or runs[0][:5] != again[:5] or on != KIP320_LEVELS[13]:
        raise AssertionError(f"the level queued under the sync check gave {again[:5]}, the "
                             f"ordinary one {runs[0][:5]}; want {KIP320_LEVELS[13]} new")
    return (f"a warm level ({frontier.shape[0]} rows, {nc} chunks at B = {B}, T = {T}) queued "
            f"with no host synchronisation under set_sync_debug_mode('error'), {on} new")


def next_pow2_cap(n):
    return 1 << max(1, (n - 1).bit_length())


def phase_device_pipeline():
    """check(pipeline="device"): the device-resident level pipeline on
    Kip320 3r (`device` and `host`, with the JAX package's chain; then
    device-hash, which degrades), the trace model, AsyncIsr 4r M3 V3 and
    TINY^3; the host reads of each level; one warm level with no sync."""
    from kafka_specification_tpu_torch import build_model, load_config
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.models import kip320, variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config
    from kafka_specification_tpu_torch.models.product import product_model
    from kafka_specification_tpu_torch.pipeline_registry import backend_fallback_reason
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    parts, counts = [], {}
    want_chain = np.array(KIP320_CHAIN, dtype=np.uint64)
    for backend in ("device", "host"):
        ckpt = WORK / f"device-pipeline-{backend}"
        shutil.rmtree(ckpt, ignore_errors=True)
        model = build_model("Kip320", load_config("configs/Kip320.cfg"))
        with _RecordingPipelines() as rec:
            # one checkpoint, after the last level: the whole run's chain
            res, wall, counts[f"Kip320 {backend}"], held = _timed_check(
                model, ("fingerprint",), pipeline="device", visited_backend=backend,
                checkpoint_dir=str(ckpt), checkpoint_every=26)
        if (res.ok, res.total, res.diameter, res.levels) != (True, 737_794, 25, KIP320_LEVELS):
            raise AssertionError(f"Kip320 {backend}: ok={res.ok} total={res.total} "
                                 f"levels {res.levels}")
        _device_stats(res, KIP320_DEVICE_LEVELS)
        chain = verify_file(str(ckpt / CHECKPOINT_BASENAME))["digest_chain"]
        if not np.array_equal(chain, want_chain):
            raise AssertionError(f"Kip320 {backend}: the digest chain differs from the JAX "
                                 f"package's")
        parts.append(f"Kip320 3r {backend}: ok, 737794 states, diameter 25, levels and chain "
                     f"as pinned, {KIP320_DEVICE_LEVELS} levels on the card, {rec.reads()}; "
                     f"{wall:.2f} s (one checkpoint); launches {counts[f'Kip320 {backend}']}; "
                     f"{held}")
    model = build_model("Kip320", load_config("configs/Kip320.cfg"))
    res, wall, c, held = _timed_check(model, ("fingerprint", "hash_probe_insert"),
                                      pipeline="device", visited_backend="device-hash")
    reason = backend_fallback_reason("device", "device-hash")
    if (res.total, res.levels, res.stats["device"]) != (
            737_794, KIP320_LEVELS, {"levels": 0, "fallback": reason}):
        raise AssertionError(f"device-hash: total {res.total}, stats['device'] "
                             f"{res.stats['device']}")
    parts.append(f"device-hash: the same counts, 0 levels on the card, the JAX package's "
                 f"reason; {wall:.2f} s, launches {c}")
    thw = variants.make_model("KafkaTruncateToHighWatermark", Config(3, 2, 2, 2),
                              invariants=("StrongIsr",))
    with _RecordingPipelines() as rec:
        res, wall, counts["trace"], held = _timed_check(thw, ("fingerprint",), pipeline="device")
    v = res.violation
    if (v is None or (v.invariant, v.depth) != ("StrongIsr", 8) or res.levels != THW_LEVELS
            or [a for a, _ in v.trace] != THW_DEFAULT_ACTIONS
            or canon(v.state) != THW_DEFAULT_STATE):
        raise AssertionError(f"trace model: {v and (v.invariant, v.depth)}, {res.levels}")
    _device_stats(res, THW_DEVICE_LEVELS)
    parts.append(f"TruncateToHW 3r StrongIsr: violated at depth 8, trace as pinned, "
                 f"{THW_DEVICE_LEVELS} levels on the card, {rec.reads()}")
    cfg = load_config("configs/AsyncIsr.cfg")
    cfg.constants.update(Replicas=["b1", "b2", "b3", "b4"], MaxOffset=3, MaxVersion=3)
    tiny = product_model(kip320.make_model(Config(2, 2, 1, 1), (
        "TypeOk", "LeaderInIsr", "WeakIsr", "StrongIsr")), 3)
    tiny_levels = np.convolve(np.convolve(TINY_LEVELS, TINY_LEVELS), TINY_LEVELS).tolist()
    for name, model, want, on_card in (
            ("AsyncIsr 4r M3 V3", build_model("AsyncIsr", cfg), ASYNC_4R_LEVELS,
             ASYNC_4R_DEVICE_LEVELS),
            ("TINY^3", tiny, tiny_levels, TINY_DEVICE_LEVELS)):
        counts[name], line = _device_path(name, model, want, on_card)
        parts.append(line)
    parts.append(_sync_free_level(build_model("Kip320", load_config("configs/Kip320.cfg"))))
    return {"line": "; ".join(parts), "counts": counts}


def _device_path(name, model, want, on_card):
    """A passing model through check(pipeline="device") to the end: its
    pinned levels, and `on_card` levels on the card, the JAX package's
    count.  -> (launch counts, the phase line's part)."""
    with _RecordingPipelines() as rec:
        res, wall, counts, held = _timed_check(model, ("fingerprint",), pipeline="device")
    if (res.ok, res.levels) != (True, want):
        raise AssertionError(f"{name}: ok={res.ok} total={res.total} levels {res.levels}")
    _device_stats(res, on_card)
    return counts, (f"{name}: ok, {res.total} states, diameter {res.diameter}, levels as pinned, "
                    f"{res.stats['device']['levels']} levels on the card, {rec.reads()}; "
                    f"{wall:.2f} s, {res.total / wall:.0f} states/s; launches {counts}; {held}")


def phase_simulate():
    import hashlib

    out, wall = _run_cli("simulate", SIM_THW_ARGS, 1)
    lines = out.splitlines()
    head_ok = all(a.startswith(b) for a, b in zip(lines[:4], SIM_THW_HEAD))
    if not head_ok or len(lines) < 5:
        raise AssertionError(f"TruncateToHW simulate printed {lines[:4]}")
    sha = hashlib.sha256("\n".join(lines[4:]).encode()).hexdigest()
    if sha != SIM_THW_TRACE_SHA:
        raise AssertionError(f"the TruncateToHW walk differs from the JAX package's "
                             f"(sha256 {sha} of {len(lines) - 4} lines)")
    rate = lines[1].rsplit("(", 1)[-1].rstrip(")")
    out2, wall2 = _run_cli("simulate", SIM_STRETCH_ARGS, 0)
    line = out2.strip()
    if not (line.startswith(SIM_STRETCH_LINE) and len(out2.splitlines()) == 1):
        raise AssertionError(f"Stretch simulate printed {out2[-500:]!r}")
    return {"line": f"TruncateToHW 200 x 30 seed 0: exit 1, WeakIsr at depth 12 after 1673 "
                    f"states, trace as pinned, {rate}, process {wall:.1f} s; Stretch 10 x 50 "
                    f"seed 0: exit 0, {line.split(', ', 1)[1]} process {wall2:.1f} s"}


def _dir_bytes(path) -> int:
    from kafka_specification_tpu_torch.resilience.resources import dir_usage_bytes

    return dir_usage_bytes([str(path)])


def _e3_run(name, **knobs):
    """Kip320 3r E3 through check() on the card with `knobs`, one checkpoint
    after its last level (the whole run's chain).  -> (result, wall, K1
    launches, held note, peak device bytes, chain, bytes of its spill
    directory)."""
    from kafka_specification_tpu_torch import build_model, load_config
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    cfg = load_config("configs/Kip320.cfg")
    cfg.constants.update(E3_CONSTANTS)
    ckpt = WORK / f"disk-tier-{name}"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(DEV)
    res, wall, counts, held = _timed_check(build_model("Kip320", cfg), ("fingerprint",),
                                           checkpoint_dir=str(ckpt),
                                           checkpoint_every=E3_DIAMETER + 1, **knobs)
    peak = torch.cuda.max_memory_allocated(DEV)
    if (res.ok, res.total, res.diameter) != (True, E3_TOTAL, E3_DIAMETER):
        raise AssertionError(f"E3 {name}: ok={res.ok} total={res.total} diameter={res.diameter}")
    chain = verify_file(str(ckpt / CHECKPOINT_BASENAME))["digest_chain"]
    spill = _dir_bytes(ckpt / "spill")
    shutil.rmtree(ckpt, ignore_errors=True)
    return res, wall, counts, held, peak, chain, spill


def phase_disk_tier():
    """The disk tier (mem_budget), the resource governor's exit 75, fault
    injection and cli verify-checkpoint on the card: (a) Kip320 3r E3 in RAM
    on `host` and on the tier at 16M (fused, then pipeline="device"); (b) the
    trace model on the tier, crashed at level 4 and resumed; (c) Kip320 3r at
    1M, a merge every 2 runs, crashed in its first merge and resumed; (d) the
    CLI's exit 75 (an injected full disk, then a disk budget), verify-checkpoint,
    and the resume to exit 0.  Every check() run, crashed or not, and every
    cli check is counted from 0 and holds K1 at its own largest launch."""
    from kafka_specification_tpu_torch import build_model, check, load_config
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.models import variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    parts, counts = [], {}
    # (a) E3, uncut: in RAM, then on the tier, fused and device
    ram = _e3_run("ram", visited_backend="host")
    disk = _e3_run("fused", mem_budget=E3_BUDGET)
    dev = _e3_run("device", mem_budget=E3_BUDGET, pipeline="device")
    for name, run in (("fused", disk), ("device", dev)):
        if run[0].levels != ram[0].levels or not np.array_equal(run[5], ram[5]):
            raise AssertionError(f"E3 on the tier ({name}): levels or chain differ from the "
                                 f"in-RAM host run's")
        sp = run[0].stats["spill"]
        if sp["disk"] + sp["hot"] != E3_TOTAL or run[0].stats["visited_backend"] != "host":
            raise AssertionError(f"E3 on the tier ({name}): backend "
                                 f"{run[0].stats['visited_backend']}, spill stats {sp}")
    # the per-chunk path spills as soon as the hot set passes the budget; the
    # device path's once-a-level insert spills between slices of 262,144,
    # so its runs are larger and fewer
    sp = disk[0].stats["spill"]
    if sp["spills"] < 9 or sp["merges"] < 1:
        raise AssertionError(f"E3 on the tier (fused): {sp['spills']} spills, "
                             f"{sp['merges']} merges")
    counts["E3 host in RAM"], counts["E3 tier fused"], counts["E3 tier device"] = (
        ram[2], disk[2], dev[2])
    # the tier re-fingerprints no spilled frontier (its segments carry CRCs):
    # one K1 launch a level fewer than the in-RAM run's frontier checks
    if ram[2]["fingerprint"] - disk[2]["fingerprint"] != len(ram[0].levels):
        raise AssertionError(f"K1 launches: in RAM {ram[2]['fingerprint']}, on the tier "
                             f"{disk[2]['fingerprint']}, expected {len(ram[0].levels)} fewer")
    if dev[0].stats["device"]["fallback"] is not None or not dev[0].stats["device"]["levels"]:
        raise AssertionError(f"E3 device on the tier: stats['device'] {dev[0].stats['device']}")
    for name, run in (("in RAM (host)", ram), ("tier fused", disk), ("tier device", dev)):
        sp = run[0].stats.get("spill")
        tier = (f", {sp['spills']} spills, {sp['merges']} merges, disk {sp['disk']} + hot "
                f"{sp['hot']}, {sp['runs']} runs, spill directory {run[6]} bytes"
                if sp else "")
        parts.append(f"E3 {name}: {run[0].total} states, diameter {run[0].diameter}, "
                     f"{run[1]:.2f} s wall (one checkpoint), {run[0].total / run[1]:.0f} states/s, "
                     f"peak device memory {run[4]} bytes{tier}; launches {run[2]}; {run[3]}")
    parts.append("levels and chain equal across the three")
    # (b) the trace model on the tier, crashed at level 4 and resumed; the
    # crashed run and the resume each counted from 0 and held at its own
    # largest launch
    thw = lambda: variants.make_model(  # noqa: E731
        "KafkaTruncateToHighWatermark", Config(3, 2, 2, 2), invariants=("StrongIsr",))
    ref = check(thw(), device=DEV, visited_backend="host")
    ck = WORK / "disk-tier-trace"
    shutil.rmtree(ck, ignore_errors=True)
    tier = dict(mem_budget="64K", checkpoint_dir=str(ck))
    counts["trace on the tier, crash@level:4"], held_crash = _crashed_check(
        thw(), "crash@level:4", ("fingerprint",), **tier)
    res, _, counts["trace on the tier, resumed"], held = _timed_check(thw(), ("fingerprint",),
                                                                     **tier)
    v = res.violation
    if v is None or (v.invariant, v.depth) != ("StrongIsr", 8) or res.levels != THW_LEVELS:
        raise AssertionError(f"trace model on the tier: {v and (v.invariant, v.depth)}, "
                             f"{res.levels}")
    if not v.trace or canon(v.trace) != canon(ref.violation.trace):
        raise AssertionError("the resumed trace differs from the in-RAM host trace")
    if [a for a, _ in v.trace] != THW_HOST_ACTIONS or canon(v.state) != THW_HOST_STATE:
        raise AssertionError(f"the resumed trace differs from the JAX package's host trace: "
                             f"{[a for a, _ in v.trace]}")
    parts.append(f"trace model at 64K: crash@level:4 (launches "
                 f"{counts['trace on the tier, crash@level:4']}; {held_crash}), resumed "
                 f"(launches {counts['trace on the tier, resumed']}; {held}), StrongIsr at "
                 f"depth 8 with the in-RAM host trace and the JAX host pin ({len(v.trace)} "
                 f"steps), {res.stats['spill']['spills']} spills")
    # (c) Kip320 3r at 1M, a merge every 2 runs: crashed in its first merge
    kip = lambda: build_model("Kip320", load_config("configs/Kip320.cfg"))  # noqa: E731
    ck = WORK / "disk-tier-merge"
    shutil.rmtree(ck, ignore_errors=True)
    tier = dict(mem_budget="1M", checkpoint_dir=str(ck))
    os.environ["KSPEC_SPILL_RUNS_PER_MERGE"] = "2"
    try:
        counts["Kip320 1M crash@merge:1"], held_crash = _crashed_check(
            kip(), "crash@merge:1", ("fingerprint",), **tier)
        res, _, counts["Kip320 1M resumed"], held = _timed_check(kip(), ("fingerprint",), **tier)
    finally:
        os.environ.pop("KSPEC_SPILL_RUNS_PER_MERGE", None)
    chain = verify_file(str(ck / CHECKPOINT_BASENAME))["digest_chain"]
    if (res.ok, res.total, res.levels) != (True, 737_794, KIP320_LEVELS):
        raise AssertionError(f"Kip320 at 1M after crash@merge:1: {res.total}, {res.levels}")
    if not np.array_equal(chain, np.array(KIP320_CHAIN, dtype=np.uint64)):
        raise AssertionError("Kip320 at 1M after crash@merge:1: the chain differs from the "
                             "JAX package's")
    parts.append(f"Kip320 3r at 1M: crash@merge:1 (launches "
                 f"{counts['Kip320 1M crash@merge:1']}; {held_crash}), resumed (launches "
                 f"{counts['Kip320 1M resumed']}; {held}) to 737794 states with the JAX chain, "
                 f"{res.stats['spill']['spills']} spills, {res.stats['spill']['merges']} merges")
    # (d) the CLI: each check in this process, counted and held as above;
    # verify-checkpoint (no card) in a subprocess
    d = WORK / "disk-tier-cli"
    shutil.rmtree(d, ignore_errors=True)
    args = ["configs/Kip320.cfg", "--mem-budget", "1M", "--checkpoint", str(d), "--json"]
    rec, w75, counts["cli enospc@spill:3"], held75 = _cli_check_counted(
        [*args, "--fault", "enospc@spill:3"], 75)
    if rec["exit_code"] != 75 or not rec["error"].startswith("RESOURCE_EXHAUSTED[enospc]"):
        raise AssertionError(f"enospc@spill:3: record {rec}")
    out, _ = _run_cli("verify-checkpoint", [str(d), "--json"], 0)
    if json.loads(out)["ok"] is not True:
        raise AssertionError(f"verify-checkpoint: {out[-500:]}")
    rec0, w0, counts["cli resumed"], held0 = _cli_check_counted(args, 0)
    if rec0["distinct_states"] != 737_794 or rec0["exit_code"] != 0:
        raise AssertionError(f"the resumed cli check: {rec0}")
    used = _dir_bytes(d)
    d2 = WORK / "disk-tier-cli-budget"
    shutil.rmtree(d2, ignore_errors=True)
    rec2, wb, counts["cli --disk-budget"], heldb = _cli_check_counted(
        ["configs/Kip320.cfg", "--mem-budget", "1M", "--checkpoint", str(d2), "--disk-budget",
         str(used // 2), "--json"], 75)
    if rec2["exit_code"] != 75 or not rec2["error"].startswith("RESOURCE_EXHAUSTED[disk]"):
        raise AssertionError(f"--disk-budget {used // 2}: record {rec2}")
    out, _ = _run_cli("verify-checkpoint", [str(d2), "--json"], 0)
    if json.loads(out)["ok"] is not True:
        raise AssertionError(f"verify-checkpoint after --disk-budget: {out[-500:]}")
    parts.append(f"cli: enospc@spill:3 exit 75 ({w75:.1f} s; launches "
                 f"{counts['cli enospc@spill:3']}; {held75}), verify-checkpoint ok, resumed to "
                 f"737794 states exit 0 ({w0:.1f} s; launches {counts['cli resumed']}; {held0}; "
                 f"its directory {used} bytes), --disk-budget {used // 2} exit 75 "
                 f"({rec2['error']}; {wb:.1f} s; launches {counts['cli --disk-budget']}; "
                 f"{heldb}), verify-checkpoint ok")
    for p in (d, d2, WORK / "disk-tier-trace", WORK / "disk-tier-merge"):
        shutil.rmtree(p, ignore_errors=True)
    return {"line": "; ".join(parts), "counts": counts}


def _jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh.read().splitlines()]


def _quartiles(xs):
    q = np.percentile(np.asarray(xs), [25, 50, 75])
    return f"median {q[1]:.4f} s (quartiles {q[0]:.4f}-{q[2]:.4f})"


def _obs_report(d):
    """`cli report D` and `cli report D --json` in this process: (text,
    record)."""
    from kafka_specification_tpu_torch import cli

    outs = []
    for extra in ([], ["--json"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["report", str(d), *extra])
        if rc != 0:
            raise AssertionError(f"cli report {d} {extra}: exit {rc}")
        outs.append(buf.getvalue())
    return outs[0], json.loads(outs[1])


def phase_obs():
    """The run context on the card (obs/): (a) Kip320 3r through `cli check
    --run-dir D --stats D/stats.jsonl --json`, counted: the record's run_id
    is the manifest's and every stats line's, the stats lines' clock-free
    fields equal the JAX package's CPU run (pinned), one level B/E pair a
    level, kspec_states_distinct 737794 in metrics.prom; (b) `cli report D`
    and `--json`: complete; (c) the same run under `--profile P`: the
    Chrome trace holds exactly as many device events of K1's CUDA function
    as the wrapper counted; (d) `--visited-backend device-hash` under a run
    directory: K2 counted and held, the gauges present; (e) crash@level:4
    with a checkpoint into a run directory, the report's stall verdict,
    then the same command without the fault resumed into the same
    directory (the run id kept, the lineage open/reopen/finish); (f) E3 in
    RAM on `host` under a run context, so that the 5 s metrics snapshots
    fire; (g) Kip320 3r check() with and without run=, and with only a
    stats file, in turns."""
    from kafka_specification_tpu_torch import build_model, check, cli, load_config
    from kafka_specification_tpu_torch.obs import RunContext, metrics, tracer
    from kafka_specification_tpu_torch.obs.report import render_report, report_data
    from kafka_specification_tpu_torch.resilience.faults import InjectedCrash
    from kafka_specification_tpu_torch.utils.timing import card_line

    base = WORK / "obs"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    parts, counts = [], {}
    # (a) the run directory of a cli check
    d = base / "a"
    rec, wall, counts["cli --run-dir"], held = _cli_check_counted(
        ["configs/Kip320.cfg", "--run-dir", str(d), "--stats", str(d / "stats.jsonl"),
         "--json"], 0)
    rid = rec["run_id"]
    with open(d / "manifest.json") as fh:
        man = json.load(fh)
    lines = _jsonl(d / "stats.jsonl")
    if rec["distinct_states"] != 737_794 or man["run_id"] != rid or man["status"] != "complete":
        raise AssertionError(f"cli --run-dir: record {rec}, manifest {man['run_id']} "
                             f"{man['status']}")
    if any(line.get("run_id") != rid for line in lines):
        raise AssertionError("a stats line lacks the record's run_id")
    if [stats_fields(line) for line in lines] != kip320_stats():
        raise AssertionError("the stats lines differ from the JAX package's")
    levels = [(r["depth"], r["ph"]) for r in _jsonl(d / "spans.jsonl")
              if r["kind"] == "span" and r["span"] == "level"]
    if sorted(levels) != sorted((depth, ph) for depth in range(1, 27) for ph in "BE"):
        raise AssertionError(f"level spans: {levels}")
    prom = (d / "metrics.prom").read_text()
    if f'kspec_states_distinct{{run_id="{rid}"}} 737794' not in prom.splitlines():
        raise AssertionError("metrics.prom lacks kspec_states_distinct 737794")
    files = sorted(os.listdir(d))
    parts.append(f"(a) Kip320 3r cli --run-dir: run {rid}, {wall:.2f} s, files {files}, "
                 f"{len(lines)} stats lines = the JAX pin, 26 level B/E pairs; launches "
                 f"{counts['cli --run-dir']}; {held}")
    # (b) cli report
    text, data = _obs_report(d)
    if (data["verdict"]["status"] != "complete" or f"Run {rid}  [COMPLETE]" not in text
            or "Per-level throughput (26 levels recorded):" not in text):
        raise AssertionError(f"cli report: {text[:300]}")
    parts.append(f"(b) cli report: complete, {len(text.splitlines())} lines; --json verdict "
                 f"{data['verdict']['status']}")
    # (c) the profiler sees K1
    prof = base / "prof"
    rec_c, wall_c, counts["cli --profile"], held_c = _cli_check_counted(
        ["configs/Kip320.cfg", "--run-dir", str(base / "c"), "--profile", str(prof), "--json"],
        0)
    trace = prof / f"{rec_c['run_id']}.pt.trace.json"
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in kernels if "fingerprint_kernel" in e.get("name", "")]
    if len(k1_events) != counts["cli --profile"]["fingerprint"]:
        raise AssertionError(f"the profile holds {len(k1_events)} events of fingerprint_kernel, "
                             f"the wrapper counted {counts['cli --profile']['fingerprint']} "
                             f"({len(kernels)} kernel events in all)")
    k1_us = sum(e.get("dur", 0) for e in k1_events)
    parts.append(f"(c) --profile: {trace.stat().st_size} bytes of trace, {len(kernels)} kernel "
                 f"events, {len(k1_events)} of fingerprint_kernel = its counted launches "
                 f"({k1_us:.1f} us in all); {wall_c:.2f} s under the profiler; {held_c}")
    shutil.rmtree(prof, ignore_errors=True)
    # (d) device-hash under a run directory
    dd = base / "d"
    rec_d, wall_d, counts["cli device-hash --run-dir"], held_d = _cli_check_counted(
        ["configs/Kip320.cfg", "--visited-backend", "device-hash", "--run-dir", str(dd),
         "--json"], 0, ("fingerprint", "hash_probe_insert"))
    prom_d = (dd / "metrics.prom").read_text()
    want = ("kspec_states_distinct", "kspec_successor_launches_level",
            "kspec_integrity_checks_total", "kspec_levels_total", "kspec_duplicate_ratio")
    missing = [g for g in want if f"\n{g}{{" not in "\n" + prom_d]
    if rec_d["distinct_states"] != 737_794 or missing:
        raise AssertionError(f"device-hash run dir: {rec_d['distinct_states']} states, "
                             f"missing {missing}")
    parts.append(f"(d) device-hash --run-dir: 737794 states, {wall_d:.2f} s, gauges {want} "
                 f"present; launches {counts['cli device-hash --run-dir']}; {held_d}")
    # (e) a crash, the stall verdict, and the resume into the same directory
    de, ck = base / "e", base / "e-ck"
    args = ["configs/Kip320.cfg", "--checkpoint", str(ck), "--run-dir", str(de), "--json"]
    _reset_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["check", *args, "--fault", "crash@level:4"])
        raise AssertionError("crash@level:4 did not fire")
    except InjectedCrash:
        pass
    finally:
        os.environ.pop("KSPEC_FAULT", None)
    counts["cli crash@level:4"] = _read_counts(("fingerprint",))
    held_e = _hold_path_shapes(_largest(), 0)
    with open(de / "manifest.json") as fh:
        crashed = json.load(fh)
    later = time.time() + 10_000
    stall = report_data(str(de), now=later)["verdict"]["status"]
    live = report_data(str(de))["verdict"]["status"]
    text_e = render_report(str(de), now=later)
    if (crashed["status"] != "running" or stall != "stalled" or live != "live"
            or "Stall verdict: stalled" not in text_e):
        raise AssertionError(f"crashed run: manifest {crashed['status']}, verdicts {stall} "
                             f"(later) / {live} (now)")
    # the crash skipped the observer's teardown, as the JAX engine's does
    tracer.set_tracer(None)
    metrics.set_registry(None)
    rec_e, wall_e, counts["cli resumed into the run dir"], held_r = _cli_check_counted(args, 0)
    with open(de / "manifest.json") as fh:
        resumed = json.load(fh)
    lineage = [e["event"] for e in resumed["lineage"]]
    if (not crashed["run_id"] or {rec_e["run_id"], resumed["run_id"]} != {crashed["run_id"]}
            or lineage != ["open", "reopen", "finish"] or rec_e["distinct_states"] != 737_794):
        raise AssertionError(f"resume: run ids {crashed['run_id']} / {rec_e['run_id']}, "
                             f"lineage {lineage}, {rec_e['distinct_states']} states")
    parts.append(f"(e) crash@level:4 (launches {counts['cli crash@level:4']}; {held_e}): "
                 f"manifest running, report {live} now, {stall} past the stall timeout; "
                 f"resumed into the same run {rec_e['run_id']} ({wall_e:.2f} s, lineage "
                 f"{lineage}, 737794 states; launches "
                 f"{counts['cli resumed into the run dir']}; {held_r})")
    # (f) E3 in RAM on host under a run context: the timed snapshots fire
    cfg = load_config("configs/Kip320.cfg")
    cfg.constants.update(E3_CONSTANTS)
    run = RunContext(str(base / "f"))
    res, wall_f, counts["E3 host run="], held_f = _timed_check(
        build_model("Kip320", cfg), ("fingerprint",), visited_backend="host", run=run)
    snaps = len(_jsonl(run.metrics_jsonl))
    if res.total != E3_TOTAL or snaps < 2:
        raise AssertionError(f"E3 under a run context: {res.total} states, {snaps} snapshots")
    parts.append(f"(f) E3 host run=: {res.total} states, {wall_f:.2f} s, metrics.jsonl "
                 f"{snaps} lines; launches {counts['E3 host run=']}; {held_f}")
    # (g) the run context's cost, in turns: without (P), with (C), and with
    # only a stats file (S: the stats collection a run context turns on,
    # without the run directory)
    model = build_model("Kip320", load_config("configs/Kip320.cfg"))
    walls = {"P": [], "S": [], "C": []}
    (base / "g").mkdir()
    for i in range(5):
        for side in "PSCCSP":
            tag = base / "g" / f"{i}{side}{len(walls[side])}"
            kw = ({"run": RunContext(str(tag))} if side == "C"
                  else {"stats_path": str(tag) + ".jsonl"} if side == "S" else {})
            t0 = time.perf_counter()
            r = check(model, device=DEV, **kw)
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
            if r.total != 737_794:
                raise AssertionError(f"run-context cost run: {r.total} states")
    parts.append(f"(g) Kip320 3r check(), P S C C S P x5 on {card_line()}: without run= "
                 f"{_quartiles(walls['P'])}, stats_path only {_quartiles(walls['S'])}, with "
                 f"run= {_quartiles(walls['C'])}; walls "
                 + " ".join(f"{k} {[round(w, 4) for w in v]}" for k, v in walls.items()))
    shutil.rmtree(base, ignore_errors=True)
    return {"line": "; ".join(parts), "counts": counts}


def _overlap_side(name, model_fn, on, chain_every, **knobs):
    """One overlap path, one side: check() on the card with the layer `on`,
    counted from 0, with a stats file and a checkpoint every `chain_every`
    levels (the last one holds the run's chain).  -> (result, wall, counts,
    held note, largest launches, chain)."""
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    side = "on" if on else "off"
    ckpt = WORK / f"overlap-{name}-{side}"
    stats = WORK / f"overlap-{name}-{side}.jsonl"
    shutil.rmtree(ckpt, ignore_errors=True)
    stats.unlink(missing_ok=True)
    res, wall, counts, held = _timed_check(model_fn(), ("fingerprint",), overlap=on,
                                           checkpoint_dir=str(ckpt),
                                           checkpoint_every=chain_every,
                                           stats_path=str(stats), **knobs)
    largest = _largest()["fingerprint"]
    chain = verify_file(str(ckpt / CHECKPOINT_BASENAME))["digest_chain"]
    shutil.rmtree(ckpt, ignore_errors=True)
    stats.unlink(missing_ok=True)
    return res, wall, counts, held, largest, chain


def phase_overlap():
    """The overlap layer on the card: each path with the layer on, then
    off, each side counted from 0 and held at its own largest launch; the
    same levels and chain, K1's launches and largest launch equal on both
    sides, the staged-chunk bound."""
    from kafka_specification_tpu_torch import build_model, load_config

    def kip():
        return build_model("Kip320", load_config("configs/Kip320.cfg"))

    def e3():
        cfg = load_config("configs/Kip320.cfg")
        cfg.constants.update(E3_CONSTANTS)
        return build_model("Kip320", cfg)

    kip_chain = np.array(KIP320_CHAIN, dtype=np.uint64)
    # (name, model, checkpoint cadence, knobs, the pinned chain or None)
    paths = [
        ("Kip320 default", kip, 26, {}, kip_chain),
        ("Kip320 host", kip, 26, dict(visited_backend="host"), kip_chain),
        ("Kip320 checkpoint every level", kip, 1, {}, kip_chain),
        ("E3 tier fused", e3, E3_DIAMETER + 1, dict(mem_budget=E3_BUDGET), None),
        ("E3 tier device", e3, E3_DIAMETER + 1, dict(mem_budget=E3_BUDGET, pipeline="device"),
         None),
    ]
    parts, counts = [], {}
    for name, model_fn, every, knobs, pinned in paths:
        sides = {on: _overlap_side(name, model_fn, on, every, **knobs) for on in (True, False)}
        (r_on, w_on, c_on, h_on, l_on, ch_on), (r_off, w_off, c_off, h_off, l_off, ch_off) = (
            sides[True], sides[False])
        if r_on.levels != r_off.levels or not r_on.ok or not np.array_equal(ch_on, ch_off):
            raise AssertionError(f"overlap {name}: on {r_on.levels} / off {r_off.levels}, or "
                                 f"the chains differ")
        if pinned is not None and (r_on.levels != KIP320_LEVELS
                                   or not np.array_equal(ch_on, pinned)):
            raise AssertionError(f"overlap {name}: the levels or the chain differ from the "
                                 f"JAX package's")
        if c_on != c_off or l_on != l_off:
            raise AssertionError(f"overlap {name}: K1 launches on {c_on} {l_on}, off {c_off} "
                                 f"{l_off}")
        ov_on, ov_off = r_on.stats["overlap"], r_off.stats["overlap"]
        multi = any(n > (1 << 15) for n in r_on.levels)  # a level of several chunks
        if (not ov_on["enabled"] or ov_off["enabled"] or ov_off["staged_chunks_peak"] > 1
                or ov_on["staged_chunks_peak"] > 2
                or (multi and "pipeline" not in knobs and ov_on["staged_chunks_peak"] != 2)):
            raise AssertionError(f"overlap {name}: stats on {ov_on}, off {ov_off}")
        effs = [lv["overlap_efficiency"] for lv in r_on.stats["levels"]]
        counts[f"{name} on"], counts[f"{name} off"] = c_on, c_off
        jobs = {w: ov_on[w]["jobs"] for w in ("io_worker", "ckpt_worker") if w in ov_on}
        parts.append(f"{name}: {r_on.total} states, levels and chain equal on/off"
                     + (" and to the JAX pin" if pinned is not None else "")
                     + f"; wall on {w_on:.2f} s / off {w_off:.2f} s; K1 {c_on['fingerprint']} "
                     f"launches both sides, largest {l_on}; staged peak on "
                     f"{ov_on['staged_chunks_peak']} / off {ov_off['staged_chunks_peak']}; jobs "
                     f"{jobs}; mean overlap_efficiency {np.mean(effs):.3f}; sync ckpt on "
                     f"{ov_on['sync_ckpt_io_s']} s / off {ov_off['sync_ckpt_io_s']} s"
                     + (f"; spills {r_on.stats['spill']['spills']}/{r_off.stats['spill']['spills']}"
                        f", merges {r_on.stats['spill']['merges']}/"
                        f"{r_off.stats['spill']['merges']}" if "spill" in r_on.stats else "")
                     + f"; on: {h_on}")
    return {"line": "; ".join(parts), "counts": counts}


def _oracle_path(model, oracle, path_kernels, **knobs):
    """One path held against the port's oracle: the oracle's BFS on the
    host, check() on the card with collect_levels (counted from 0), then
    each level decoded (unpacked on the card, one copy to the host) and
    compared with the oracle's level as a set, up to the violation level
    on a violation.  -> (result, oracle result, counts, walls, held note)."""
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.engine.decode import decode_rows
    from kafka_specification_tpu_torch.oracle import oracle_bfs

    t0 = time.perf_counter()
    ores = oracle_bfs(oracle)
    o_wall = time.perf_counter() - t0
    packed = []
    _reset_counts()
    t0 = time.perf_counter()
    res = check(model, device=DEV, collect_levels=packed, **knobs)
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t0
    counts = _read_counts(path_kernels)
    largest = _largest()
    if ores.violation is None:
        if res.violation is not None or res.levels != ores.levels or res.total != ores.total:
            raise AssertionError(f"engine {res.levels} {res.violation}, oracle {ores.levels}")
        last = len(ores.levels) - 1
    else:
        v = res.violation
        if v is None or (v.invariant, v.depth) != ores.violation[:2]:
            raise AssertionError(f"oracle {ores.violation[:2]}, engine "
                                 f"{v and (v.invariant, v.depth)}")
        last = ores.violation[1]
    if len(packed) < last + 1:
        raise AssertionError(f"the engine collected {len(packed)} levels, the oracle {last + 1}")
    t0 = time.perf_counter()
    for d in range(last + 1):
        eng = set(decode_rows(model, packed[d]))
        packed[d] = None
        orc = ores.level_sets[d]
        if eng != orc:
            raise AssertionError(f"level {d}: {len(eng - orc)} engine-only states "
                                 f"{list(eng - orc)[:2]}, {len(orc - eng)} oracle-only "
                                 f"{list(orc - eng)[:2]}")
    d_wall = time.perf_counter() - t0
    held = (_hold_path_shapes(largest, res.total) if path_kernels
            else "no kernel launched (the state's fingerprint is the state itself)")
    return res, ores, counts, (o_wall, e_wall, d_wall), held


def _oracle_paths():
    """(name, model, its oracle twin, the path's kernels, knobs, (expected
    violation, total, diameter)) of the four runs of phase oracle."""
    from kafka_specification_tpu_torch import build_model, load_config
    from kafka_specification_tpu_torch.models import variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config
    from kafka_specification_tpu_torch.models.product import product_model, product_oracle

    kip = load_config("configs/Kip320.cfg")
    first_try = load_config("configs/Kip320FirstTry.cfg")
    first_try.invariants = ["StrongIsr"]
    asy = load_config("configs/AsyncIsr.cfg")
    base, weak = Config(2, 2, 1, 1), ("TypeOk", "WeakIsr")
    thw = "KafkaTruncateToHighWatermark"
    return [
        ("Kip320 3r", build_model("Kip320", kip), build_model("Kip320", kip, oracle=True),
         ("fingerprint",), {}, (None, 737_794, 25)),
        ("Kip320FirstTry StrongIsr device-hash", build_model("Kip320FirstTry", first_try),
         build_model("Kip320FirstTry", first_try, oracle=True),
         ("fingerprint", "hash_probe_insert"), dict(visited_backend="device-hash"),
         (("StrongIsr", 12), None, None)),
        ("AsyncIsr.cfg host", build_model("AsyncIsr", asy),
         build_model("AsyncIsr", asy, oracle=True), (), dict(visited_backend="host"),
         (None, 4_088, 16)),
        ("TruncateToHW 2r x 2 device",
         product_model(variants.make_model(thw, base, weak), 2),
         product_oracle(variants.make_oracle(thw, base, weak), 2),
         ("fingerprint",), dict(pipeline="device"), (("WeakIsr", 8), None, None)),
    ]


def _oracle_verbs(outs):
    """The four subprocesses' (exit code, stdout, stderr, wall) checked;
    -> the phase line's note of them."""
    rc, out, err, wall = outs["oracle Kip320"]
    if (rc != 0 or not out.startswith(ORACLE_KIP320_HEAD)
            or "No invariant violations" not in out):
        raise AssertionError(f"cli oracle Kip320.cfg: exit {rc}: {out[:300]} {err[-500:]}")
    kip_rate = out.splitlines()[0].rsplit("(", 1)[-1].rstrip(")")
    rc, out, err, wall2 = outs["oracle Kip320FirstTry"]
    lines = out.splitlines()
    if (rc != 1 or not out.startswith(ORACLE_FIRST_TRY_HEAD)
            or lines[1] != ORACLE_FIRST_TRY_VIOLATION):
        raise AssertionError(f"cli oracle Kip320FirstTry.cfg: exit {rc}: {out[:300]} "
                             f"{err[-500:]}")
    ft_rate = lines[0].rsplit("(", 1)[-1].rstrip(")")
    rc, out, err, wall3 = outs["analyze"]
    rec = json.loads(out) if rc == 0 else {}
    if (rc != 0 or not rec.get("ok") or rec["counts"]["HIGH"] or rec["counts"]["MEDIUM"]
            or not any(t.startswith("Kip320 (") for t in rec["targets"])
            or "engine sources (ownership + purity)" not in rec["targets"]):
        raise AssertionError(f"cli analyze --json: exit {rc}: {out[:500]} {err[-500:]}")
    rc, out, err, wall4 = outs["pipelines"]
    names = [e["name"] for e in json.loads(out)] if rc == 0 else []
    if names != ["device", "fused", "legacy"]:
        raise AssertionError(f"cli pipelines --json: exit {rc}, names {names}: {err[-500:]}")
    return (f"cli oracle Kip320.cfg: exit 0, 737794 states, diameter 25, {kip_rate}, process "
            f"{wall:.1f} s; cli oracle Kip320FirstTry.cfg: exit 1, 184141 states, diameter "
            f"11, WeakIsr at depth 11, {ft_rate}, process {wall2:.1f} s; cli analyze --json: "
            f"exit 0, {len(rec['targets'])} targets, counts {rec['counts']}, process "
            f"{wall3:.1f} s; cli pipelines --json: {names}, process {wall4:.1f} s")


def _start_verbs(cmds):
    """Start each `cli` command in a subprocess, with a thread that waits
    for it: -> {name: (process, thread, result dict)}; the result gets
    (exit code, stdout, stderr, process wall) when the process ends."""
    import threading

    def wait(proc, t0, out):
        stdout, stderr = proc.communicate()
        out["result"] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)

    started = {}
    for name, argv in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "kafka_specification_tpu_torch.cli", *argv],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out = {}
        th = threading.Thread(target=wait, args=(proc, t0, out), daemon=True)
        th.start()
        started[name] = (proc, th, out)
    return started


def phase_oracle():
    """The card's engine against the port's oracle, state set for state
    set, on four paths; the three one-shot verbs in subprocesses, which
    run on the host alone and so run meanwhile."""
    verbs = _start_verbs({
        "oracle Kip320": ["oracle", "configs/Kip320.cfg"],
        "oracle Kip320FirstTry": ["oracle", "configs/Kip320FirstTry.cfg"],
        "analyze": ["analyze", "--json"],
        "pipelines": ["pipelines", "--json"],
    })
    try:
        parts, counts = [], {}
        for name, model, oracle, path_kernels, knobs, (viol, total, diameter) in _oracle_paths():
            res, ores, counts[name], (ow, ew, dw), held = _oracle_path(
                model, oracle, path_kernels, **knobs)
            got_v = ores.violation and tuple(ores.violation[:2])
            if got_v != viol or (total is not None
                                 and (ores.total, ores.diameter) != (total, diameter)):
                raise AssertionError(f"{name}: oracle {got_v}, {ores.total} states, "
                                     f"diameter {ores.diameter}")
            if "pipeline" in knobs and res.stats["device"]["levels"] < 1:
                raise AssertionError(f"{name}: no level ran on the card: {res.stats['device']}")
            n_levels = (viol[1] if viol else ores.diameter) + 1
            n_states = sum(ores.levels[:n_levels])
            parts.append(
                f"{name}: " + (f"{viol[0]} at depth {viol[1]} in both, " if viol else
                               f"ok, {ores.total} states, diameter {ores.diameter}, ")
                + f"{n_levels} levels equal as sets ({n_states} states); oracle {ow:.2f} s "
                f"({ores.total / ow:.0f} states/s), engine {ew:.2f} s, decode {dw:.2f} s "
                f"({n_states / dw:.0f} states/s); launches {counts[name]}; {held}")
            del ores
        for _, th, _ in verbs.values():
            th.join(timeout=600)
        outs = {name: out["result"] for name, (_, _, out) in verbs.items()}
    finally:
        for proc, th, _ in verbs.values():
            if proc.poll() is None:
                proc.kill()
            th.join()
    parts.append(_oracle_verbs(outs))
    return {"line": "; ".join(parts), "counts": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        from kafka_specification_tpu_torch.utils.timing import card_line
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here ({e})", file=sys.stderr)
        return 1
    card = card_line()
    # the in-process and subprocess `cli check` runs open their run
    # directories here, not under the checkout's runs/
    os.environ.setdefault("KSPEC_RUNS_ROOT", str(WORK / "runs"))
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    ph = Phases()
    ph.run("build", phase_build)
    k1 = ph.run("K1", phase_k1)
    k2 = ph.run("K2", phase_k2)
    k4 = ph.run("K4", lambda: phase_k4(k2))
    main_path = ph.run("main", phase_main)
    ph.run("trace", phase_trace)
    default = ph.run("default", phase_default)
    ph.run("trace-default", phase_trace_default)
    ph.run("host", phase_host)
    ph.run("resume", phase_resume)
    ph.run("first-try-strong", phase_first_try_strong)
    ph.run("cli", phase_cli)
    async_isr = ph.run("async-isr", phase_async_isr)
    product = ph.run("product", phase_product)
    ph.run("simulate", phase_simulate)
    device_pipeline = ph.run("device-pipeline", phase_device_pipeline)
    disk_tier = ph.run("disk-tier", phase_disk_tier)
    obs = ph.run("obs", phase_obs)
    overlap = ph.run("overlap", phase_overlap)
    oracle = ph.run("oracle", phase_oracle)
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}", file=sys.stderr)
        return 1
    kernels = []
    # K1's launches on the default path, K2's on the device-hash path
    by_path = {"default": default["counts"], "main (device-hash)": main_path["counts"],
               "async-isr": async_isr["counts"]["device"],
               "async-isr device-hash": async_isr["counts"]["device-hash"],
               "product TINY^3": product["counts"],
               "product violation": product["violation_counts"],
               **{f"device-pipeline {p}": c for p, c in device_pipeline["counts"].items()},
               **{f"disk-tier {p}": c for p, c in disk_tier["counts"].items()},
               **{f"obs {p}": c for p, c in obs["counts"].items()},
               **{f"overlap {p}": c for p, c in overlap["counts"].items()},
               **{f"oracle {p}": c for p, c in oracle["counts"].items()}}
    for det, path in ((k1, default), (k2, main_path)):
        kern = dict(det["kernel"])
        kern["launches"] = path["counts"][kern["name"]]
        kern["launches_by_path"] = {p: c[kern["name"]] for p, c in by_path.items()}
        kernels.append(kern)
    kernels += k4["kernels"]  # a rung's launches: one ladder run (no rung is on check())
    kernels[0]["launches_device_pipeline"] = device_pipeline["counts"]["Kip320 device"][
        "fingerprint"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
