#!/usr/bin/env python3
"""Bounded Kip320 5-broker single-partition check, PyTorch port (the port's
copy of scripts/run_5broker_bounded.py, with its command line).

The model is configs/Kip320Stretch.cfg's constants without Partitions:
Kip320 at 5 replicas, LogSize 2, MaxRecords 2, MaxLeaderEpoch 2.  One
check() with the JAX script's knobs (no trace, the `host` visited set,
chunk_size 131072, min_bucket 8192), the stats stream at
$KSPEC_RUN_STATS when set, one JSON line a level (depth, new, total,
elapsed_s, states_per_sec, rss_gb, and on the card peak_device_gb), then
the `final` line, or the `cut` line when the wall-clock budget ran out
(the cut fires at a level boundary, so the run may pass its budget by
most of a level).

Usage:

    python scripts/torch_run_5broker_bounded.py [MINUTES] [--max-depth N]
        [--chunk N] [--visited-backend device|device-hash|host]
        [--pipeline fused|device] [--store-trace] [--against RECORD] [--cpu]

    # the reproduction gate: 195,528,316 states, diameter 15, each level
    # held against the JAX package's committed stats stream
    python scripts/torch_run_5broker_bounded.py 30 --max-depth 15 \\
        --visited-backend device --against RUN5R_r5_stats.jsonl

    python scripts/torch_run_5broker_bounded.py --cpu --max-depth 6   # 75,976 states

MINUTES (default 60) is the wall-clock budget; `--max-depth N` and
`--max-depth=N` stop after level N (the value of the two-token form is
never read as MINUTES).  Beyond the JAX script's flags it takes those of
the port's `cli check`: --visited-backend (default `host`, the JAX
script's), --pipeline, --cpu, and --store-trace (check()'s store_trace,
which `cli check --no-trace` turns off; off here, as in the JAX script).
--against RECORD holds each level's stats record, as it is written,
against the record's line of the same depth on `RECORD_FIELDS`, and
stops at the first field that differs, naming it (exit non-zero).  The
final line also gives the recovery layer's account (pipeline_fallback,
degradations, and the device levels with pipeline device), so that a
degraded run never reads as a plain one, and on the card K1's launches
and its largest launch (M, K), and K2's launches.

It runs on the card unless --cpu is given, and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the fields of a level's stats record that a run must reproduce exactly
RECORD_FIELDS = ("frontier", "enabled_candidates", "new", "duplicates", "total",
                 "action_enablement")
# the JAX script's knobs
CHUNK = 131072
MIN_BUCKET = 8192
# Kip320Stretch.cfg's constants without Partitions
N_REPLICAS, LOG_SIZE, MAX_RECORDS, MAX_LEADER_EPOCH = 5, 2, 2, 2


class RecordMismatch(AssertionError):
    """A level's stats record differs from the reference record."""


class _WallCut(Exception):
    """The wall-clock budget ran out at a level boundary."""


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("minutes", nargs="?", type=float, default=60.0, metavar="MINUTES",
                    help="wall-clock budget (default 60)")
    ap.add_argument("--max-depth", type=int, default=None, help="stop after level N")
    ap.add_argument("--chunk", type=int, default=CHUNK, help=f"chunk_size (default {CHUNK})")
    ap.add_argument("--visited-backend", choices=["device", "device-hash", "host"],
                    default="host")
    ap.add_argument("--pipeline", choices=["fused", "device"], default=None)
    ap.add_argument("--store-trace", action="store_true",
                    help="keep every level for the trace walk (check()'s store_trace)")
    ap.add_argument("--against", default=None, metavar="RECORD",
                    help="hold each level's stats record against this stats stream")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    return ap.parse_args(argv)


def make_model():
    from kafka_specification_tpu_torch.models import kip320
    from kafka_specification_tpu_torch.models.kafka_replication import Config

    return kip320.make_model(Config(n_replicas=N_REPLICAS, log_size=LOG_SIZE,
                                    max_records=MAX_RECORDS,
                                    max_leader_epoch=MAX_LEADER_EPOCH))


def read_record(path) -> dict:
    """A stats stream (one JSON record a level) -> {depth: record}."""
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return {int(r["depth"]): r for r in recs}


def hold_level(got: dict, want: dict) -> None:
    """Hold one level's stats record against the reference's record of the
    same depth on RECORD_FIELDS, in that order, with zero tolerance;
    raises RecordMismatch naming the first field that differs."""
    if got["depth"] != want["depth"]:
        raise RecordMismatch(f"depth {got['depth']} held against the record's depth "
                             f"{want['depth']}")
    for field in RECORD_FIELDS:
        if got.get(field) != want.get(field):
            raise RecordMismatch(f"depth {got['depth']}: {field} is {got.get(field)!r}, "
                                 f"the record has {want.get(field)!r}")


def hold_levels(got_levels, record: dict) -> int:
    """Hold every level of a run (its stats records, in depth order)
    against `record` (``read_record``): each depth the record has must
    match.  -> the number of levels held."""
    held = 0
    for rec in got_levels:
        want = record.get(int(rec["depth"]))
        if want is not None:
            hold_level(rec, want)
            held += 1
    return held


class _StatsTail:
    """The lines a stats stream has gained since the last read."""

    def __init__(self, path: str):
        # a stream that already holds lines (an appended $KSPEC_RUN_STATS)
        # is read from its current end
        self.path = path
        self.offset = os.path.getsize(path) if os.path.exists(path) else 0

    def new_records(self) -> list:
        with open(self.path) as fh:
            fh.seek(self.offset)
            text = fh.read()
        whole = text[: text.rfind("\n") + 1]
        self.offset += len(whole.encode())
        return [json.loads(line) for line in whole.splitlines() if line.strip()]


def bounded_check(minutes: float = 60.0, max_depth=None, chunk: int = CHUNK,
                  visited_backend: str = "host", pipeline=None, store_trace: bool = False,
                  record=None, device=None, stats_path=None, emit=print):
    """The script's check(): the 5-broker model with the JAX script's knobs,
    a progress line a level through `emit`, each level held against
    `record` (``read_record``'s dict, when given) as it is written.  ->
    (CheckResult, or None when the budget cut the run; the number of
    levels held)."""
    import torch

    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.engine.bfs import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    tmp = None
    if record is not None and stats_path is None:
        # the levels are held from the stream as check() writes it
        tmp = tempfile.TemporaryDirectory(prefix="kspec-5broker-")
        stats_path = os.path.join(tmp.name, "stats.jsonl")
    tail = _StatsTail(stats_path) if record is not None else None
    held = [0]
    model = make_model()
    deadline = time.time() + minutes * 60.0
    t0 = time.time()

    def progress(depth, new_n, total):
        if tail is not None:
            held[0] += hold_levels(tail.new_records(), record)
        now = time.time()
        rec = {
            "depth": depth,
            "new": int(new_n),
            "total": int(total),
            "elapsed_s": round(now - t0, 1),
            "states_per_sec": round(total / max(now - t0, 1e-9), 1),
            "rss_gb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        }
        if on_card:
            rec["peak_device_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9, 2)
        emit(json.dumps(rec))
        if now > deadline:
            raise _WallCut  # the wall-clock cut, at a level boundary

    try:
        res = check(model, store_trace=store_trace, visited_backend=visited_backend,
                    chunk_size=chunk, min_bucket=MIN_BUCKET, progress=progress,
                    max_depth=max_depth, stats_path=stats_path, pipeline=pipeline, device=dev)
    except _WallCut:
        emit(json.dumps({"cut": True, "budget_min": minutes,
                         "elapsed_min": round((time.time() - t0) / 60.0, 1)}))
        return None, held[0]
    finally:
        if tmp is not None:
            tmp.cleanup()
    if record is not None:
        # every level the record has up to where the run stopped
        want = sum(1 for d in record if 1 <= d <= res.diameter)
        if held[0] != want:
            raise RecordMismatch(f"{held[0]} levels held, the record has {want} up to depth "
                                 f"{res.diameter}")
    final = {
        "final": True,
        "ok": res.ok,
        "total": res.total,
        "diameter": res.diameter,
        "seconds": round(res.seconds, 1),
        "states_per_sec": round(res.states_per_sec, 1),
        "visited_backend": res.stats["visited_backend"],
        "pipeline": res.stats["pipeline"],
        "pipeline_fallback": res.stats["pipeline_fallback"],
        "degradations": len(res.stats["degradations"]),
    }
    if res.stats["pipeline"] == "device":
        final["device_levels"] = res.stats["device"]["levels"]
        final["device_fallback"] = res.stats["device"]["fallback"]
    if record is not None:
        final["levels_held"] = held[0]
    if on_card:
        from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset

        final["peak_device_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9, 2)
        final["k1_launches"] = cuda_fingerprint.LAUNCHES
        final["k1_largest"] = list(cuda_fingerprint.LARGEST)
        final["k2_launches"] = cuda_hashset.LAUNCHES
    emit(json.dumps(final))
    return res, held[0]


def main(argv=None) -> int:
    args = parse_args(argv)
    res, _ = bounded_check(
        args.minutes, max_depth=args.max_depth, chunk=args.chunk,
        visited_backend=args.visited_backend, pipeline=args.pipeline,
        store_trace=args.store_trace,
        record=read_record(args.against) if args.against else None,
        device="cpu" if args.cpu else None,
        stats_path=os.environ.get("KSPEC_RUN_STATS") or None,
        emit=lambda line: print(line, flush=True))
    return 0 if res is None or res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
