"""Kernels K1 and K2 at the shapes check() of configs/Kip320.cfg gives them:
their inputs, and their own, route, host, bound and plain times on the card.

K1 (fingerprint) runs on M = 1,671,168 rows of K = 3 lanes (a full chunk's
lattice), ~10% invalid; K2 (hash insert-or-find) at cap 2^22 with
M = 109,260 keys (the path's largest batch): in-batch duplicates, an eighth
of the keys already in the table.  For each kernel:

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

``scripts/cuda_k1k2_times.py`` prints these; ``chip_smoke.py`` reports them
beside its bit-identity checks.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ..ops import cuda_fingerprint, cuda_hashset, hashset
from ..ops.dedup import pair_key, split_key
from . import timing

K1_M, K1_K = 32768 * 51, 3
K2_CAP, K2_M = 1 << 22, 109260
OWN_LAUNCHES, ROUTE_CALLS, HOST_CALLS = 100, 50, 50


def _spread(times):
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def k1_inputs(dev, m=K1_M, k=K1_K, seed=1, invalid=0.1):
    """int64[m, k] random u32 lanes and a bool[m] mask with a share invalid."""
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


def k2_fixture(dev, cap=K2_CAP, m=K2_M, seed=5):
    """-> (table0, keys, valid): a quarter of the second half duplicates the
    first half, the first eighth already in the table; `valid` masks ~10%
    of the rows for the checks that pass a mask (check() passes none)."""
    rng = np.random.default_rng(seed)
    q = keys(rng, m, dev)
    dup = torch.from_numpy(rng.integers(0, m // 2, size=m // 4)).to(dev)
    q[m // 2 : m // 2 + m // 4] = q[dup]
    valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
    s_hi, s_lo = split_key(q[: m // 8])
    return hashset.table_from_pairs(s_hi, s_lo, min_cap=cap), q, valid


def k1_times(lanes, valid) -> dict:
    k1 = cuda_fingerprint
    m, k = lanes.shape
    # three more lane matrices, so that no call finds its input in L2
    ring = [(x, valid) for x in
            [lanes] + [k1_inputs(lanes.device, m, k, seed)[0] for seed in (2, 3, 4)]]
    k1.launch(*ring[0])  # warm-up
    own =timing.ring_ms(lambda a: k1.launch(*a), lambda: ring, OWN_LAUNCHES)
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


def k2_times(table0, q) -> dict:
    """K2 on the call check() makes, probe_insert(table, keys) with no mask,
    each call on a fresh clone of table0."""
    k2 = cuda_hashset
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
