#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc).  Imports no JAX and nothing of the JAX package.
Phases, one line each; any failed phase makes the script exit non-zero and
print no result:

  build  compile every CUDA source of the port (one nvcc each, in parallel)
  K1     fingerprint kernel vs its plain PyTorch version, bit for bit, at
         M = 32768 x 51 rows of K = 3 lanes (a full Kip320 3r chunk's
         lattice), ~10% invalid rows; timed beside its bound
  K2     hash insert-or-find kernel vs its plain version at cap 2^22 with
         in-batch duplicates, pre-seeded keys and invalid rows (winners,
         count, membership identical; timed beside its bound), then a tiny
         table that overflows, grown and re-run, against the same loop on
         the plain version
  K4     the six rungs of the construct ladder (run_ladder at n = 256, the
         TPU script's arange input: launched, bit-identical to their plain
         versions, timed with CUDA events over 1,000 launches beside their
         bound and, for every rung but dyn_read and dyn_slice, one PyTorch
         call),
         then bit for bit at n = 65,536 (256 blocks), at n = 4 with x[0] = 6
         (the clamp) and with x[0] = 2^31, rest 2^32 - 1 (unsigned remainder,
         wrap); and K2's time split by the launch floor, all in this run
  main   configs/Kip320.cfg through check() on the card: ok, 737,794
         states, diameter 25, per-level counts equal to the JAX package's
         (pinned below), both kernels launched
  trace  KafkaTruncateToHighWatermark 3r L2 R2 E2 with StrongIsr only:
         violated at depth 8 with the JAX package's trace (pinned below)

Then three lines: the kernels as JSON, the card's name and power limit as
nvidia-smi gives them, and the device as JSON.  Exits 1 with no result
when CUDA is not available or the port's package is not beside it.
"""

from __future__ import annotations

import json
import subprocess
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


def phase_k1():
    from kafka_specification_tpu_torch.ops import cuda_fingerprint as k1
    from kafka_specification_tpu_torch.utils.timing import HBM_BYTES_PER_S, OPS_PER_S, cuda_ms

    m, k = 32768 * 51, 3
    rng = np.random.default_rng(1)
    lanes_np = rng.integers(0, 2**32, size=(m, k), dtype=np.uint32)
    valid_np = rng.random(m) >= 0.1
    lanes = torch.from_numpy(lanes_np.astype(np.int64)).to(DEV)
    valid = torch.from_numpy(valid_np).to(DEV)
    hi, lo = k1.fingerprint(lanes, valid)
    p_hi, p_lo = k1.fingerprint_plain(lanes, valid)
    torch.cuda.synchronize()
    err = max(int((hi - p_hi).abs().max()), int((lo - p_lo).abs().max()))
    if err:
        raise AssertionError(f"K1 differs from its plain version (max |diff| {err})")
    lanes32, valid8 = k1.to_i32(lanes), valid.to(torch.uint8)
    ms = cuda_ms(lambda: k1.launch(lanes32, valid8), 50)
    plain_ms = cuda_ms(lambda: k1.fingerprint_plain(lanes, valid), 5)
    n_valid = int(valid_np.sum())
    nbytes = m * k * 4 + m + 2 * m * 4
    ops = n_valid * (20 * k + 22)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
    return {
        "line": f"M={m} K={k} invalid={m - n_valid} bit-identical; "
                f"kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), plain {plain_ms:.3f} ms",
        "kernel": {
            "name": "fingerprint",
            "route": "cuda",
            "source": "kafka_specification_tpu_torch/ops/csrc/fingerprint.cu",
            "replaces": "kafka_specification_tpu/ops/pallas_fingerprint.py:41",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / OPS_PER_S else "operations",
            "library_ms": None,
        },
    }


def _keys(rng, n):
    from kafka_specification_tpu_torch.ops.dedup import pair_key

    hi = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64))
    lo = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64))
    # the all-ones pair marks an empty slot: never a key
    lo[(hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)] = 0
    return pair_key(hi, lo).to(DEV)


def _members(table):
    return torch.sort(table[table != -1]).values


def _k2_fixture():
    """K2's inputs at the main path's largest batch: in-batch duplicates,
    ~10% invalid rows, an eighth of the keys already in the table."""
    from kafka_specification_tpu_torch.ops import hashset
    from kafka_specification_tpu_torch.ops.dedup import split_key

    cap, m = 1 << 22, 109260  # the main path's largest batch
    rng = np.random.default_rng(5)
    q = _keys(rng, m)
    dup = torch.from_numpy(rng.integers(0, m // 2, size=m // 4)).to(DEV)
    q[m // 2 : m // 2 + m // 4] = q[dup]
    valid = torch.from_numpy(rng.random(m) < 0.9).to(DEV)
    s_hi, s_lo = split_key(q[: m // 8])
    return cap, m, hashset.table_from_pairs(s_hi, s_lo, min_cap=cap), q, valid


def phase_k2():
    from kafka_specification_tpu_torch.ops import cuda_hashset as k2
    from kafka_specification_tpu_torch.ops import hashset
    from kafka_specification_tpu_torch.utils.timing import HBM_BYTES_PER_S, cuda_ms

    cap, m, table0, q, valid = _k2_fixture()

    t_plain, p_new, p_n, p_ovf = hashset.probe_insert(table0.clone(), q, valid)
    t_kern, k_new, k_n, k_ovf = k2.probe_insert(table0.clone(), q, valid)
    torch.cuda.synchronize()
    if bool(p_ovf) or bool(k_ovf):
        raise AssertionError("fixture overflowed")
    if not torch.equal(p_new, k_new):
        raise AssertionError(
            f"K2 winners differ ({int(k_new.sum())} vs {int(p_new.sum())} new)"
        )
    if int(p_n) != int(k_n) or not torch.equal(_members(t_plain), _members(t_kern)):
        raise AssertionError("K2 count or membership differs from its plain version")
    err = int((k_new.to(torch.int64) - p_new.to(torch.int64)).abs().max())

    # overflow: 4096 distinct keys into 1024 slots, grown and re-run
    small_q = _keys(np.random.default_rng(6), 4096)
    small_v = torch.ones(4096, dtype=torch.bool, device=DEV)
    results = []
    for insert in (hashset.probe_insert, k2.probe_insert):
        table = hashset.new_table(1024, DEV)
        isnew = torch.zeros(4096, dtype=torch.bool, device=DEV)
        rounds = 0
        while True:
            table, new, _n, ovf = insert(table, small_q, small_v)
            isnew |= new
            if not bool(ovf):
                break
            rounds += 1
            table = hashset.rehash_into(table, 2 * table.shape[0])
        results.append((rounds, isnew, _members(table)))
    (p_rounds, p_isnew, p_mem), (k_rounds, k_isnew, k_mem) = results
    if k_rounds == 0 or p_rounds == 0:
        raise AssertionError("the tiny table did not overflow")
    if not (torch.equal(p_isnew, k_isnew) and torch.equal(p_mem, k_mem)):
        raise AssertionError("grow-and-rerun novelty differs after overflow")

    valid8 = valid.to(torch.uint8)
    ms = cuda_ms(lambda t: k2.launch(t, q, valid8), 20, setup=table0.clone)
    plain_ms = cuda_ms(lambda t: hashset.probe_insert(t, q, valid), 3, setup=table0.clone)
    n_valid, n_new = int(valid.sum()), int(k_n)
    # keys + valid flags read, one slot read per valid row, one slot
    # written per new key, one flag written per row
    nbytes = m * 9 + n_valid * 8 + n_new * 8 + m
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "line": f"cap={cap} M={m} new={n_new} winners/count/membership identical; "
                f"overflow re-run identical ({k_rounds} growths); "
                f"kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), plain {plain_ms:.3f} ms",
        "kernel": {
            "name": "hash_probe_insert",
            "route": "cuda",
            "source": "kafka_specification_tpu_torch/ops/csrc/hashset.cu",
            "replaces": "kafka_specification_tpu/ops/pallas_hashset.py:380",
            "also_replaces": "kafka_specification_tpu/ops/pallas_hashset.py:313",
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,
        },
    }


def _k2_split(k2_ms, vec):
    """K2's time split by the ladder's launch floor, all from this run.

    A wrapper call puts seven operations on the card: three zero fills
    (is_new, n_new, overflow) and the C entry's four steps.  The C entry is
    also timed alone with the same three fills inside its window and its
    scratch allocated outside it, in turns with the wrapper (wrapper, C, C,
    wrapper; the median of each side's calls, since one call's time has the
    host's jitter in it).  The wrapper's surplus is then host work only
    (Python checks, five allocations); the C call less seven
    launch-to-launch floors is the four steps' own work, scattered slot
    reads and the dependency between steps, with the fills' own work."""
    from kafka_specification_tpu_torch.ops import build
    from kafka_specification_tpu_torch.ops import cuda_hashset as k2
    from kafka_specification_tpu_torch.ops.hashset import MAX_PROBES
    from kafka_specification_tpu_torch.utils.timing import cuda_call_ms

    cap, m, table0, q, valid = _k2_fixture()
    valid8 = valid.to(torch.uint8)
    claim = torch.empty(cap, dtype=torch.int32, device=DEV)
    slot = torch.empty(m, dtype=torch.int32, device=DEV)
    is_new = torch.empty(m, dtype=torch.uint8, device=DEV)
    n_new = torch.empty(1, dtype=torch.int32, device=DEV)
    overflow = torch.empty(1, dtype=torch.int32, device=DEV)
    lib, stream = k2._lib(), torch.cuda.current_stream().cuda_stream

    def c_call(t):
        # the wrapper's three zero fills, then its C entry
        is_new.zero_()
        n_new.zero_()
        overflow.zero_()
        rc = lib.kspec_probe_insert(
            t.data_ptr(), claim.data_ptr(), cap, q.data_ptr(), valid8.data_ptr(), m,
            MAX_PROBES, slot.data_ptr(), is_new.data_ptr(), n_new.data_ptr(),
            overflow.data_ptr(), stream,
        )
        build.check_rc(lib, rc, "K2 C entry")

    def wrapper(t):
        k2.launch(t, q, valid8)

    turns = [cuda_call_ms(fn, 50, setup=table0.clone) for fn in (wrapper, c_call, c_call, wrapper)]
    wrapper_ms = float(np.median(turns[0] + turns[3]))
    c_ms = float(np.median(turns[1] + turns[2]))
    return {
        "k2_ms": k2_ms,
        "vec_ms": vec["ms"],
        "four_vec_ms": 4 * vec["ms"],
        "k2_rest_ms": k2_ms - 4 * vec["ms"],
        "k2_wrapper_ms": wrapper_ms,
        "k2_c_call_with_fills_ms": c_ms,
        "vec_back_to_back_ms": vec["back_to_back_ms"],
        "seven_launch_floors_ms": 7 * vec["back_to_back_ms"],
        "k2_host_work_ms": wrapper_ms - c_ms,
        "k2_steps_work_ms": c_ms - 7 * vec["back_to_back_ms"],
    }


def phase_k4(k2):
    from kafka_specification_tpu_torch.ops import cuda_ladder as k4

    for rung in k4.RUNGS:
        k4.LAUNCHES[rung] = 0
    recs = k4.run_ladder(DEV, 256)  # the TPU script's path: arange(256)
    bad = [f"{r['rung']}: {r['error'] or 'max |diff| %s' % r['max_abs_err']}"
           for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"rungs failed at n=256: {bad}")
    if any(r["launches"] != 1 or k4.LAUNCHES[r["rung"]] < 1 for r in recs):
        raise AssertionError(f"a rung was not launched: {[r['launches'] for r in recs]}")
    if any(r["library_bits_equal"] is False for r in recs):
        raise AssertionError("a library call's bits differ from the plain version")

    rng = np.random.default_rng(11)
    top = np.full(256, 0xFFFFFFFF, dtype=np.uint32)
    top[0] = 0x80000000
    edges = {
        "n=65536": rng.integers(0, 2**32, size=65536, dtype=np.uint32),
        "n=4 x[0]=6": np.concatenate([[6], rng.integers(0, 2**32, size=3, dtype=np.uint32)]),
        "x[0]=2^31, rest 2^32-1": top,
    }
    for label, arr in edges.items():
        x = torch.from_numpy(arr.astype(np.int64)).to(DEV)
        for rung in k4.RUNGS:
            got = k4.from_i32(k4.launch(rung, k4.to_i32(x)))
            torch.cuda.synchronize()
            if not torch.equal(got, k4.PLAIN[rung](x)):
                raise AssertionError(f"{rung} differs from its plain version at {label}")

    if k2 is None:
        raise AssertionError("the rungs passed, but K2 failed: no time to split")
    split = _k2_split(k2["kernel"]["ms"], recs[0])
    kernels = []
    for r in recs:
        kernels.append({
            "name": f"ladder_{r['rung']}",
            "route": "cuda",
            "source": "kafka_specification_tpu_torch/ops/csrc/ladder.cu",
            "replaces": k4.REPLACES[r["rung"]],
            **{key: r[key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "back_to_back_ms", "host_us_per_launch")},
        })
    times = "; ".join(
        f"{r['rung']} {r['ms']:.4f} ms (back to back {r['back_to_back_ms']:.4f}, "
        f"host {r['host_us_per_launch']:.1f} us, library "
        + ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f}") + ")"
        for r in recs
    )
    return {
        "line": f"6 rungs bit-identical at n=256, {', '.join(edges)}; bound "
                f"{recs[0]['bound_ms']:.2e} ms; {times}; k2_split {json.dumps(split)}",
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


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    try:
        import kafka_specification_tpu_torch  # noqa: F401
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
