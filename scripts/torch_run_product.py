"""Closed-form product-space run of the PyTorch port (the port's copy of
scripts/run_product_tiny3.py).

Kip320 TINY (2 brokers, L=2, R=1, E=1) has exactly 277 reachable states.
Independent partitions interleaved (models/product.py) must reach exactly
the product of their bases' counts: 277^K for K TINY partitions, and for
the mixed bases below their closed forms, each base counted by the port's
reference interpreter (oracle/).  One single-device check() on the host
backend, with the disk tier when a memory budget is given, a checkpoint
every two levels and a per-level stats stream (the supervisor's
heartbeat), prints one JSON record and fails unless the count is exact.

Usage:

    python scripts/torch_run_product.py [--partitions K] [--cpu]
    python scripts/torch_run_product.py --base mixed464   # 463,797,477 states

    # what `scripts/torch_resilient_run.py --preset prod464` supervises:
    # the environment gives it its checkpoint, stats stream, budget and
    # spill directory
    KSPEC_PROD_CKPT=.prod464_ckpt KSPEC_PROD_STATS=stats.jsonl \\
        KSPEC_PROD_MEMBUDGET=8G python scripts/torch_run_product.py --base mixed464

It runs on the card unless --cpu is given.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kafka_specification_tpu_torch import check  # noqa: E402
from kafka_specification_tpu_torch.models import id_sequence, kip320  # noqa: E402
from kafka_specification_tpu_torch.models.kafka_replication import Config  # noqa: E402
from kafka_specification_tpu_torch.models.product import product_model, product_models  # noqa: E402
from kafka_specification_tpu_torch.oracle import oracle_bfs  # noqa: E402


def oracle_total(oracle) -> int:
    return oracle_bfs(oracle, keep_level_sets=False).total


def build(base: str, partitions: int):
    """-> (model, its closed-form state count, the workload's name)."""
    cfg_t, cfg_2r = Config(2, 2, 1, 1), Config(2, 2, 2, 2)
    if base in ("mixed107", "mixed464"):
        max_id = 1 if base == "mixed107" else 11
        tot_2r = oracle_total(kip320.make_oracle(cfg_2r))
        print(f"# base Kip320 2r: {tot_2r} states (oracle); IdSequence({max_id}): "
              f"{max_id + 2}", flush=True)
        model = product_models(
            [kip320.make_model(cfg_2r, invariants=("TypeOk",)),
             kip320.make_model(cfg_2r, invariants=("TypeOk",)),
             id_sequence.make_model(max_id)],
            name=f"Kip320 2r^2 x IdSeq{max_id} (mixed product)")
        return (model, tot_2r * tot_2r * (max_id + 2),
                f"Kip320 2r^2 x IdSequence({max_id}) mixed product exhaustive")
    if base == "mixed":
        tot_t = oracle_total(kip320.make_oracle(cfg_t))
        tot_2r = oracle_total(kip320.make_oracle(cfg_2r))
        print(f"# bases: tiny={tot_t}, 2r={tot_2r} (oracle)", flush=True)
        model = product_models(
            [kip320.make_model(cfg_t), kip320.make_model(cfg_t), kip320.make_model(cfg_2r)],
            name="Kip320 tiny^2 x 2r (mixed product)")
        return model, tot_t * tot_t * tot_2r, "Kip320 tiny^2 x 2r mixed product exhaustive"
    cfg = cfg_t if base == "tiny" else cfg_2r
    base_total = oracle_total(kip320.make_oracle(cfg))
    print(f"# base Kip320 {base}: {base_total} states (oracle)", flush=True)
    return (product_model(kip320.make_model(cfg), partitions), base_total ** partitions,
            f"Kip320 {base.upper()} ^{partitions} product exhaustive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partitions", type=int, default=3)
    ap.add_argument("--chunk-size", type=int, default=131072)
    ap.add_argument("--mem-budget", default=os.environ.get("KSPEC_PROD_MEMBUDGET"),
                    help="host fingerprint-set byte budget (K/M/G suffixes) before spilling "
                    "to the disk tier; also $KSPEC_PROD_MEMBUDGET")
    ap.add_argument("--spill-dir", default=os.environ.get("KSPEC_PROD_SPILL"),
                    help="disk-tier directory (default: <checkpoint>/spill); also "
                    "$KSPEC_PROD_SPILL")
    ap.add_argument("--base", choices=["tiny", "2r", "mixed", "mixed107", "mixed464"],
                    default="tiny",
                    help="base factor: tiny = Kip320 (2r,L2,R1,E1), 277 states; 2r = Kip320 "
                    "(2r,L2,R2,E2), 5,973 states; mixed = tiny^2 x 2r (458,302,317; "
                    "--partitions ignored); mixed107 = 2r^2 x IdSequence(MaxId=1) "
                    "(107,030,187); mixed464 = 2r^2 x IdSequence(MaxId=11) (463,797,477)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)

    model, golden, workload = build(args.base, args.partitions)
    print(f"# product: expect {golden:,} distinct states; fanout={model.total_fanout}, "
          f"lanes={model.spec.num_lanes}", flush=True)
    t0 = time.perf_counter()
    res = check(
        model,
        store_trace=False,
        visited_backend="host",
        chunk_size=args.chunk_size,
        min_bucket=4096,
        mem_budget=args.mem_budget or None,
        spill_dir=args.spill_dir or None,
        checkpoint_dir=os.environ.get("KSPEC_PROD_CKPT") or None,
        checkpoint_every=2,
        # the per-level stream the supervisor's stall detector watches
        stats_path=os.environ.get("KSPEC_PROD_STATS") or None,
        compact_shift=int(os.environ.get("KSPEC_PROD_SHIFT") or 2),
        progress=lambda d, n, t: print(
            f"#   level {d}: +{n:,} -> {t:,} ({time.perf_counter() - t0:.0f}s)", flush=True),
        device="cpu" if args.cpu else None,
    )
    print(json.dumps({
        "workload": workload,
        "distinct_states": res.total,
        "expected": golden,
        "match": res.total == golden,
        "ok": res.ok,
        "diameter": res.diameter,
        "seconds": round(res.seconds, 1),
        "states_per_sec": round(res.states_per_sec, 1),
    }), flush=True)
    return 0 if res.ok and res.total == golden else 1


if __name__ == "__main__":
    raise SystemExit(main())
