#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc).  Imports no JAX and nothing of the JAX package.
Phases, one line each; any failed phase makes the script exit non-zero and
print no result:

  build  compile every CUDA source of the port (one nvcc each, in parallel)
  K1     fingerprint kernel vs its plain PyTorch version, bit for bit, on
         the port's int64 lanes and bool mask at M = 32768 x 51 rows of
         K = 3 lanes (a full Kip320 3r chunk's lattice) and at M = 65,537,
         K = 7, ~10% invalid rows; then its own time, route time, bound and
         plain time (utils/kernel_times.py)
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
  main   configs/Kip320.cfg through check() on the card: ok, 737,794
         states, diameter 25, per-level counts equal to the JAX package's
         (pinned below), both kernels launched
  trace  KafkaTruncateToHighWatermark 3r L2 R2 E2 with StrongIsr only:
         violated at depth 8 with the JAX package's trace (pinned below)

A kernel's `ms` is its own time (CUDA events around back-to-back launches),
`route_ms` the entry point's time as check() calls it, host work included.
Then three lines: the kernels as JSON, the card's name and power limit as
nvidia-smi gives them, and the device as JSON.  Exits 1 with no result
when CUDA is not available or the port's package is not beside it.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# JAX package, check() of configs/Kip320.cfg on the CPU (device-hash,
# legacy step): distinct new states per level
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
    for m, k in ((kt.K1_M, kt.K1_K), (65537, 7)):
        lanes, valid = kt.k1_inputs(DEV, m, k)
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
    results = []
    for insert in (hashset.probe_insert, k2.probe_insert):
        table = hashset.new_table(1024, DEV)
        isnew = torch.zeros(4096, dtype=torch.bool, device=DEV)
        rounds = total = 0
        while True:
            table, new, n, ovf = insert(table, small_q)
            isnew |= new
            total += int(n)
            if not bool(ovf):
                break
            rounds += 1
            table = hashset.rehash_into(table, 2 * table.shape[0])
        results.append((rounds, isnew, _members(table), total))
    (p_rounds, p_isnew, p_mem, p_total), (k_rounds, k_isnew, k_mem, k_total) = results
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


def _read_counts():
    from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset

    counts = {"fingerprint": cuda_fingerprint.LAUNCHES,
              "hash_probe_insert": cuda_hashset.LAUNCHES}
    if not all(counts.values()):
        raise AssertionError(f"a kernel of the path was never launched: {counts}")
    return counts


def phase_main():
    from kafka_specification_tpu_torch import build_model, check, load_config

    model = build_model("Kip320", load_config("configs/Kip320.cfg"))
    _reset_counts()
    t0 = time.perf_counter()
    res = check(model, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    if not res.ok or res.total != 737_794 or res.diameter != 25:
        raise AssertionError(f"ok={res.ok} total={res.total} diameter={res.diameter}")
    if res.levels != KIP320_LEVELS:
        raise AssertionError(f"per-level counts differ: {res.levels}")
    return {
        "line": f"Kip320 3r ok, {res.total} states, diameter 25, levels as pinned; "
                f"{wall:.2f} s wall, {res.total / wall:.0f} states/s; "
                f"launches {counts}; table {res.stats['hash_table_capacity']} slots",
        "counts": counts,
    }


def phase_trace():
    from kafka_specification_tpu_torch import check
    from kafka_specification_tpu_torch.models import variants
    from kafka_specification_tpu_torch.models.kafka_replication import Config

    model = variants.make_model(
        "KafkaTruncateToHighWatermark", Config(3, 2, 2, 2), invariants=("StrongIsr",)
    )
    _reset_counts()
    res = check(model, device=DEV)
    counts = _read_counts()
    v = res.violation
    if v is None or (v.invariant, v.depth) != ("StrongIsr", 8):
        raise AssertionError(f"expected StrongIsr at depth 8, got {v and (v.invariant, v.depth)}")
    if res.levels != THW_LEVELS:
        raise AssertionError(f"levels differ: {res.levels}")
    if [a for a, _ in v.trace] != THW_ACTIONS:
        raise AssertionError(f"trace actions differ: {[a for a, _ in v.trace]}")
    if canon(v.state) != THW_STATE:
        raise AssertionError(f"violating state differs: {canon(v.state)}")
    return {"line": f"StrongIsr violated at depth 8, trace as pinned; launches {counts}"}


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
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    ph = Phases()
    ph.run("build", phase_build)
    k1 = ph.run("K1", phase_k1)
    k2 = ph.run("K2", phase_k2)
    k4 = ph.run("K4", lambda: phase_k4(k2))
    main_path = ph.run("main", phase_main)
    ph.run("trace", phase_trace)
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}", file=sys.stderr)
        return 1
    kernels = []
    for det in (k1, k2):
        kern = dict(det["kernel"])
        kern["launches"] = main_path["counts"][kern["name"]]
        kernels.append(kern)
    kernels += k4["kernels"]  # a rung's launches: one ladder run (no rung is on check())
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
