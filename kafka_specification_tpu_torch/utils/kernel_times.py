"""Kernels K1 and K2 at the shapes check() of configs/Kip320.cfg gives them,
and K4's rungs at n = 256 and 2^24: their inputs, and their own, route,
host, bound and plain times on the card; and the split of one call's host
time into the parts of the launch route (``host_split``).

K1 (fingerprint) runs on M = 109,260 rows of K = 3 lanes, all valid: the
enabled candidates of the largest chunk, which check() packs and hands to
it with an all-true mask; K2 (hash insert-or-find) at cap 2^22 with the
same M = 109,260 keys (the path's largest batch): in-batch duplicates, an
eighth of the keys already in the table.  For each kernel:

  own_ms    the kernel's device time per call: CUDA events around 100
            back-to-back launches of its `launch` on a ring of prepared
            inputs (four lane matrices for K1, 100 clones of the table for
            K2, so that each call finds its table as check() does)
            (timing.ring_ms)
  route_ms  the entry point called as check() calls it,
            fingerprint(lanes, valid) and probe_insert(table, keys) with no
            mask and the counts read back: CUDA events around one call on
            an idle card, so the host's work before the launch (and K2's
            read) is in it; median (and min, max) of 50 calls
  host_us   the host's time a launch() call, by the host's clock around 50
            calls with no synchronize
  bound_ms  each input byte read once and each output byte written once
            at the port's carrier types, over 3.35 TB/s
  plain_ms  the plain PyTorch version on the card, median of a few calls

K4's rungs (``rung_times``, on u32 inputs of n elements): own time, the
rung launched back to back from one C call (``launch_repeated``); route,
CUDA events around ``launch()`` calls issued back to back from Python;
host µs a ``launch()`` call; plain and library times (one PyTorch call for
the same function), all over ``LADDER_LAUNCHES`` launches.

Every function takes the kernel modules as ``ops`` (``this_ops()`` by
default), so that ``scripts/cuda_k1k2_times.py --root`` times another
checkout's package with the same code in the same call.
``scripts/cuda_k1k2_times.py`` prints these; ``chip_smoke.py`` reports them
beside its bit-identity checks.
"""

from __future__ import annotations

import statistics
import types

import numpy as np
import torch

from ..ops.dedup import pair_key, split_key
from . import timing

K2_CAP, K2_M = 1 << 22, 109260
K1_M, K1_K = K2_M, 3
OWN_LAUNCHES, ROUTE_CALLS, HOST_CALLS = 100, 50, 50
LADDER_N, LADDER_LARGE_N = 256, 1 << 24
LADDER_LAUNCHES, LADDER_HOST_CALLS = 1000, 200
SPLIT_CALLS, SPLIT_REPEATS = 300, 3


def this_ops() -> types.SimpleNamespace:
    """This package's kernel modules, as the timing functions take them."""
    from ..ops import build, cuda_fingerprint, cuda_hashset, cuda_ladder, hashset

    return types.SimpleNamespace(build=build, cuda_fingerprint=cuda_fingerprint,
                                 cuda_hashset=cuda_hashset, cuda_ladder=cuda_ladder,
                                 hashset=hashset)


def _spread(times):
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def k1_inputs(dev, m=K1_M, k=K1_K, seed=1, invalid=0.0):
    """int64[m, k] random u32 lanes and a bool[m] mask with a share invalid
    (none by default, as check() calls it)."""
    rng = np.random.default_rng(seed)
    lanes = torch.from_numpy(rng.integers(0, 2**32, size=(m, k), dtype=np.uint32).astype(np.int64))
    valid = torch.from_numpy(rng.random(m) >= invalid)
    return lanes.to(dev), valid.to(dev)


def keys(rng, n, dev):
    """n random fingerprint keys; never the all-ones pair (the empty slot)."""
    hi = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64))
    lo = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64))
    lo[(hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)] = 0
    return pair_key(hi, lo).to(dev)


def k2_batch(rng, m, dev):
    """m keys, a quarter of the second half duplicating the first half."""
    q = keys(rng, m, dev)
    dup = torch.from_numpy(rng.integers(0, m // 2, size=m // 4)).to(dev)
    q[m // 2 : m // 2 + m // 4] = q[dup]
    return q


def k2_fixture(dev, cap=K2_CAP, m=K2_M, seed=5, hashset=None):
    """-> (table0, keys, valid): a k2_batch, the first eighth already in
    the table; `valid` masks ~10% of the rows for the checks that pass a
    mask (check() passes none)."""
    rng = np.random.default_rng(seed)
    q = k2_batch(rng, m, dev)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    s_hi, s_lo = split_key(q[: m // 8])
    hashset = hashset or this_ops().hashset
    return hashset.table_from_pairs(s_hi, s_lo, min_cap=cap), q, valid


def k1_times(lanes, valid, ops=None) -> dict:
    k1 = (ops or this_ops()).cuda_fingerprint
    m, k = lanes.shape
    # three more lane matrices, so that no call finds its input in L2
    ring = [(x, valid) for x in
            [lanes] + [k1_inputs(lanes.device, m, k, seed)[0] for seed in (2, 3, 4)]]
    k1.launch(*ring[0])  # warm-up
    own = timing.ring_ms(lambda a: k1.launch(*a), lambda: ring, OWN_LAUNCHES)
    route = timing.cuda_call_ms(lambda: k1.fingerprint(lanes, valid), ROUTE_CALLS)
    host = timing.host_us(lambda: k1.launch(lanes, valid), HOST_CALLS)
    plain = timing.cuda_call_ms(lambda: k1.fingerprint_plain(lanes, valid), 5)
    nbytes = 8 * m * k + m + 16 * m
    ops = int(valid.sum()) * (20 * k + 22)
    by_bytes, by_ops = nbytes / timing.HBM_BYTES_PER_S, ops / timing.OPS_PER_S
    return {
        "own_ms": own,
        "route_ms": statistics.median(route),
        "route_spread": _spread(route),
        "host_us": host,
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "plain_ms": statistics.median(plain),
    }


def k2_bound_ms(m, n_new) -> float:
    """No mask: keys read, one slot read per row, one slot written per new
    key, one flag written per row."""
    return (m * 8 + m * 8 + n_new * 8 + m) / timing.HBM_BYTES_PER_S * 1e3


def k2_times(table0, q, ops=None) -> dict:
    """K2 on the call check() makes, probe_insert(table, keys) with no mask,
    each call on a fresh clone of table0."""
    ops = ops or this_ops()
    k2, hashset = ops.cuda_hashset, ops.hashset
    n_new = int(k2.launch(table0.clone(), q)[1][0])
    own = timing.ring_ms(lambda tab: k2.launch(tab, q),
                         lambda: [table0.clone() for _ in range(OWN_LAUNCHES)], OWN_LAUNCHES)
    route = timing.cuda_call_ms(lambda tab: k2.probe_insert(tab, q), ROUTE_CALLS,
                                setup=table0.clone)
    table = table0.clone()  # the host's time does not depend on what the table holds
    host = timing.host_us(lambda: k2.launch(table, q), HOST_CALLS)
    plain = timing.cuda_call_ms(lambda tab: hashset.probe_insert(tab, q), 3, setup=table0.clone)
    return {
        "own_ms": own,
        "route_ms": statistics.median(route),
        "route_spread": _spread(route),
        "host_us": host,
        "bound_ms": k2_bound_ms(q.shape[0], n_new),
        "bound_by": "bytes",
        "plain_ms": statistics.median(plain),
        "n_new": n_new,
    }


def ladder_input(n: int, dev, seed: int) -> torch.Tensor:
    """int64[n] random u32 values from `seed`."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64)).to(dev)


def rung_times(rung, x, ref, ops=None) -> dict:
    """One rung's times on x (int64[n] u32 on the card), ref its plain
    result: own (back to back from C), route (launch() from Python), host
    µs a launch() call, plain and library ms; whether the first launch's
    bits and the library call's equal ref."""
    k4 = (ops or this_ops()).cuda_ladder
    launches = LADDER_LAUNCHES
    x32 = k4.to_i32(x)
    out = torch.empty_like(x32)
    k4.launch_repeated(rung, x32, out, 1)
    rec = {"bits_equal": bool(torch.equal(k4.from_i32(out), ref)),
           "back_to_back_ms": timing.back_to_back_ms(
               lambda: k4.launch_repeated(rung, x32, out, launches), 1) / launches,
           "ms": timing.back_to_back_ms(lambda: k4.launch(rung, x32), launches),
           "host_us_per_launch": timing.host_us(lambda: k4.launch(rung, x32),
                                                LADDER_HOST_CALLS),
           "plain_ms": timing.back_to_back_ms(lambda: k4.PLAIN[rung](x), max(1, launches // 10)),
           "library_ms": None, "library_bits_equal": None}
    lib_fn = k4.library_call(rung, x32)
    if lib_fn is not None:
        rec["library_bits_equal"] = bool(torch.equal(k4.from_i32(lib_fn()), ref))
        rec["library_ms"] = timing.back_to_back_ms(lib_fn, launches)
    return rec


def ladder_times(n, dev, ops=None) -> list[dict]:
    """Every rung's times at n on random u32, each with its bound and
    whether its bits equal its plain version's."""
    k4 = (ops or this_ops()).cuda_ladder
    x = ladder_input(n, dev, seed=12)
    recs = []
    for rung in k4.RUNGS:
        bound_ms, bound_by = k4.bound(n)
        recs.append({"rung": rung, "n": n, "bound_ms": bound_ms, "bound_by": bound_by,
                     **rung_times(rung, x, k4.PLAIN[rung](x), ops)})
    return recs


def split_inputs(ops) -> types.SimpleNamespace:
    """The inputs and outputs of the calls host_split times, on the card:
    a rung at n = 256, K1 at M = 109,260, K = 3, K2 at cap 2^22,
    M = 109,260 (its workspace for the stream, made by one call)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x32 = torch.arange(LADDER_N, dtype=torch.int32, device=dev)
    lanes, valid = k1_inputs(dev)
    table, q, _ = k2_fixture(dev, hashset=ops.hashset)
    m = lanes.shape[0]
    is_new, counts = ops.cuda_hashset.launch(table, q)
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        dev=dev, index=dev.index, x32=x32, o32=torch.empty_like(x32), lanes=lanes,
        valid=valid, hi=lanes.new_empty(m), lo=lanes.new_empty(m), table=table, q=q,
        is_new=is_new, counts=counts)


def route_parts(ops) -> dict:
    """{call: {part: fn()}}: the parts of one call's host time on the lean
    launch route (build.Entry, build.stream_handle), each a function of no
    arguments that does that part alone, and the whole call ("whole"):
    a rung (vec, n = 256), K1, K2 with no mask and its counts read, and
    torch.add(x32, 1) at n = 256 beside them.  "stream_public" is the
    public stream lookup that the route does not take, timed beside it."""
    build, k1, k2, k4 = ops.build, ops.cuda_fingerprint, ops.cuda_hashset, ops.cuda_ladder
    a = split_inputs(ops)
    index, dev = a.index, a.dev
    stream = build.stream_handle(index)
    scratch = {"launches": 0}

    def rc_and_count(entry, rc=0):
        if rc:
            raise entry.error(rc, "")
        scratch["launches"] += 1

    k4.launch("vec", a.x32)  # binds each entry
    k1.launch(a.lanes, a.valid)
    f4, f1, f2 = k4.KSPEC_LADDER.call, k1.KSPEC_FINGERPRINT.call, k2.KSPEC_PROBE_INSERT.call
    n, (m, k), cap, qm = a.x32.shape[0], a.lanes.shape, a.table.shape[0], a.q.shape[0]
    claim, code, slot = k2._workspace(a.table.device, stream, cap, qm)
    return {
        "ladder_vec_n256": {
            "checks": lambda: (k4._check_x32(a.x32), k4._check_rung("vec"), a.x32.contiguous()),
            "alloc": lambda: torch.empty_like(a.x32),
            "stream": lambda: build.stream_handle(index),
            "bind": lambda: k4.KSPEC_LADDER.call,
            "ctypes_call": lambda: f4(0, a.x32.data_ptr(), a.o32.data_ptr(), n, 1, index, stream),
            "rc_and_count": lambda: rc_and_count(k4.KSPEC_LADDER),
            "whole": lambda: k4.launch("vec", a.x32),
        },
        "K1": {
            "checks": lambda: k1._check(a.lanes, a.valid),
            "alloc": lambda: (a.lanes.new_empty(m), a.lanes.new_empty(m)),
            "stream": lambda: build.stream_handle(index),
            "bind": lambda: k1.KSPEC_FINGERPRINT.call,
            "ctypes_call": lambda: f1(a.lanes.data_ptr(), a.valid.data_ptr(), a.hi.data_ptr(),
                                      a.lo.data_ptr(), m, k, index, stream),
            "rc_and_count": lambda: rc_and_count(k1.KSPEC_FINGERPRINT),
            "whole": lambda: k1.fingerprint(a.lanes, a.valid),
        },
        "K2": {
            "checks": lambda: k2._check(a.table, a.q, None),
            "workspace": lambda: k2._workspace(a.table.device, stream, cap, qm),
            "alloc": lambda: (a.q.new_empty(qm, dtype=torch.bool),
                              a.q.new_empty(2, dtype=torch.int32)),
            "stream": lambda: build.stream_handle(index),
            "bind": lambda: k2.KSPEC_PROBE_INSERT.call,
            "ctypes_call": lambda: f2(a.table.data_ptr(), claim.data_ptr(), cap, a.q.data_ptr(),
                                      None, qm, k2.MAX_PROBES, code, slot.data_ptr(),
                                      a.is_new.data_ptr(), a.counts.data_ptr(), index, stream),
            "rc_and_count": lambda: rc_and_count(k2.KSPEC_PROBE_INSERT),
            "read": lambda: a.counts.tolist(),
            "whole": lambda: k2.probe_insert(a.table, a.q),
        },
        "torch_add_n256": {"whole": lambda: torch.add(a.x32, 1)},
        "stream_public": {"whole": lambda: torch.cuda.current_stream(dev).cuda_stream},
    }


def host_split(ops=None) -> dict:
    """{call: {part: [host µs a call, one per repeat]}}: each part of
    `route_parts(ops)` timed alone by timing.host_us over SPLIT_CALLS calls,
    SPLIT_REPEATS times; where a call has parts, "sum_of_parts" adds their
    medians, to hold against the whole call's."""
    out = {}
    for call, fns in route_parts(ops or this_ops()).items():
        rec = {name: [timing.host_us(fn, SPLIT_CALLS) for _ in range(SPLIT_REPEATS)]
               for name, fn in fns.items()}
        if len(rec) > 1:
            rec["sum_of_parts"] = sum(statistics.median(v) for name, v in rec.items()
                                      if name != "whole")
        out[call] = rec
    return out


def split_line(split: dict) -> str:
    """One line of host_split's medians, µs."""
    med = lambda v: statistics.median(v) if isinstance(v, list) else v
    return "; ".join(
        f"{call}: " + ", ".join(f"{part} {med(v):.2f}" for part, v in rec.items())
        for call, rec in split.items())
