"""PyTorch port: the open-addressing table and the plain version of kernel
K2 against the JAX package (jnp claim lattice and both Pallas probe
kernels in interpret mode), on the shared probe fixture; and K2's CUDA
protocol (find, insert and claim with epoch-tagged claim words, winner),
replayed step by step on the CPU in random row orders, against the plain
version."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kafka_specification_tpu.ops import hashset as jhashset
from kafka_specification_tpu.ops.pallas_hashset import (
    probe_insert_pallas,
    probe_insert_pallas_hbm,
)
from kafka_specification_tpu.ops.probe_fixture import (
    assert_same_winners,
    live_set,
    make_probe_case,
)
from kafka_specification_tpu_torch import interop
from kafka_specification_tpu_torch.ops import cuda_hashset, hashset
from kafka_specification_tpu_torch.ops.dedup import pair_key, split_key

CPU = torch.device("cpu")


def port_case(case):
    """The fixture's inputs as the port's tensors (table seeded via interop)."""
    table = interop.table_from_jax(case["t_hi0"], case["t_lo0"], CPU)
    q = pair_key(interop.from_u32(case["q_hi"], CPU), interop.from_u32(case["q_lo"], CPU))
    valid = torch.from_numpy(np.array(case["valid"]))
    return table, q, valid


@pytest.mark.parametrize("seed", [5, 7])
def test_plain_probe_same_winners_as_jnp(seed):
    case = make_probe_case(seed=seed)
    table, q, valid = port_case(case)
    table, is_new, n_new, ovf = hashset.probe_insert(table, q, valid)
    assert not bool(ovf)
    t_hi, t_lo = interop.table_to_pairs(table)
    assert_same_winners(case, t_hi, t_lo, is_new.numpy(), int(n_new))
    # same algorithm as the jnp path: the same slots, not only the same set
    np.testing.assert_array_equal(t_hi, np.asarray(case["ref_hi"]))
    np.testing.assert_array_equal(t_lo, np.asarray(case["ref_lo"]))


def test_plain_probe_matches_pallas_kernels():
    case = make_probe_case(seed=11)
    table, q, valid = port_case(case)
    table, is_new, n_new, _ = hashset.probe_insert(table, q, valid)
    t_hi, t_lo = interop.table_to_pairs(table)
    for kern in (probe_insert_pallas, probe_insert_pallas_hbm):
        ph, plo, p_new, p_n, p_ovf = kern(
            case["t_hi0"], case["t_lo0"], case["q_hi"], case["q_lo"],
            case["valid"], block_rows=256, interpret=True,
        )
        assert not bool(p_ovf)
        np.testing.assert_array_equal(is_new.numpy(), np.asarray(p_new))
        assert int(n_new) == int(p_n)
        assert live_set(t_hi, t_lo) == live_set(ph, plo)


def test_wrapper_takes_plain_version_on_cpu():
    case = make_probe_case(seed=5)
    t1, q, valid = port_case(case)
    t2 = t1.clone()
    _, new1, n1, o1 = hashset.probe_insert(t1, q, valid)
    _, new2, n2, o2 = cuda_hashset.probe_insert(t2, q, valid)
    assert torch.equal(t1, t2) and torch.equal(new1, new2)
    assert int(n1) == int(n2) and bool(o1) == bool(o2)


def test_overflow_then_grow_and_rerun_gives_same_novelty():
    """A table far too small overflows; growing it and re-running the same
    batch, OR-ing novelty, gives the winners of a table that never
    overflowed (and of the JAX claim lattice)."""
    rng = np.random.default_rng(3)
    m = 400
    keys = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    keys[m // 2 :] = keys[rng.integers(0, m // 2, size=m - m // 2)]  # duplicates
    valid = rng.random(m) < 0.95
    q = pair_key(interop.from_u32(keys[:, 0], CPU), interop.from_u32(keys[:, 1], CPU))
    tv = torch.from_numpy(valid)

    table = hashset.new_table(16, CPU)
    isnew = torch.zeros(m, dtype=torch.bool)
    overflowed = 0
    while True:
        table, m_new, _n, ovf = hashset.probe_insert(table, q, tv)
        isnew |= m_new
        if not bool(ovf):
            break
        overflowed += 1
        table = hashset.rehash_into(table, 2 * table.shape[0])
    assert overflowed > 0

    _, ref_new, _, ovf = hashset.probe_insert(hashset.new_table(4096, CPU), q, tv)
    assert not bool(ovf)
    assert torch.equal(isnew, ref_new)
    jh, jl = jhashset.new_table(4096)
    _, _, _, j_new, _, _ = jhashset.probe_insert(
        jh, jl, jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]), jnp.asarray(valid)
    )
    np.testing.assert_array_equal(isnew.numpy(), np.asarray(j_new))
    # every valid key is a member exactly once
    hi, lo = hashset.live_pairs(table)
    assert len(hi) == len({tuple(k) for k in keys[valid].tolist()})


def test_table_from_pairs_matches_jax_slot_for_slot():
    rng = np.random.default_rng(9)
    pairs = np.unique(rng.integers(0, 2**32, size=(3000, 2), dtype=np.uint32), axis=0)
    jh, jl = jhashset.table_from_pairs(pairs[:, 0], pairs[:, 1], min_cap=1 << 12)
    table = hashset.table_from_pairs(
        interop.from_u32(pairs[:, 0], CPU),
        interop.from_u32(pairs[:, 1], CPU),
        min_cap=1 << 12,
    )
    t_hi, t_lo = interop.table_to_pairs(table)
    np.testing.assert_array_equal(t_hi, np.asarray(jh))
    np.testing.assert_array_equal(t_lo, np.asarray(jl))


def test_rehash_into_keeps_membership():
    rng = np.random.default_rng(4)
    pairs = np.unique(rng.integers(0, 2**32, size=(700, 2), dtype=np.uint32), axis=0)
    hi = interop.from_u32(pairs[:, 0], CPU)
    lo = interop.from_u32(pairs[:, 1], CPU)
    table = hashset.table_from_pairs(hi, lo, min_cap=1 << 10)
    grown = hashset.rehash_into(table, 1 << 13)
    assert grown.shape[0] == 1 << 13
    assert live_set(*interop.table_to_pairs(grown)) == live_set(*interop.table_to_pairs(table))
    # every key is found again: nothing new
    _, is_new, n_new, ovf = hashset.probe_insert(
        grown, pair_key(hi, lo), torch.ones(len(pairs), dtype=torch.bool)
    )
    assert int(n_new) == 0 and not bool(ovf) and not bool(is_new.any())


def test_new_table_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        hashset.new_table(12, CPU)


def test_kernel_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hashset.launch(
            hashset.new_table(16, CPU), torch.zeros(4, dtype=torch.int64),
            torch.ones(4, dtype=torch.bool),
        )


def test_wrapper_without_mask_is_all_rows_valid():
    case = make_probe_case(seed=7)
    t1, q, _ = port_case(case)
    t2 = t1.clone()
    _, new1, n1, _ = hashset.probe_insert(t1, q, torch.ones(q.shape[0], dtype=torch.bool))
    _, new2, n2, ovf = cuda_hashset.probe_insert(t2, q)
    assert torch.equal(t1, t2) and torch.equal(new1, new2)
    assert int(n1) == n2 and ovf is False


def test_workspace_kept_per_device_and_stream():
    """Two cards' default streams share the stream handle 0, so the key
    holds the device: each (device, stream) has its own claim words and row
    scratch, and its own code."""
    cuda_hashset._CLAIMS.clear()
    cuda_hashset._SLOTS.clear()
    a = cuda_hashset._workspace(torch.device("cpu", 0), 0, 512, 100)
    b = cuda_hashset._workspace(torch.device("cpu", 1), 0, 512, 100)
    assert set(cuda_hashset._CLAIMS) == set(cuda_hashset._SLOTS) == {(0, 0), (1, 0)}
    assert a[0].data_ptr() != b[0].data_ptr() and a[2].data_ptr() != b[2].data_ptr()
    assert a[1] == b[1] == cuda_hashset.FIRST_CODE
    again = cuda_hashset._workspace(torch.device("cpu", 0), 0, 512, 100)
    assert again[0].data_ptr() == a[0].data_ptr() and again[1] == a[1] - 1


def test_workspace_grows_to_the_largest_table_and_batch():
    """One claim array per (device, stream): a smaller table uses the first
    words of a larger array, and a larger table replaces it with fresh
    words; the row scratch grows to the longest batch.  Nothing else is
    kept."""
    cuda_hashset._CLAIMS.clear()
    cuda_hashset._SLOTS.clear()
    dev = torch.device("cpu", 0)
    claim, code, slot = cuda_hashset._workspace(dev, 7, 1024, 300)
    assert claim.shape[0] == 1024 and slot.shape[0] == 512
    assert bool((claim == -1).all())
    claim.fill_(5)  # words an earlier call left
    small, code2, slot2 = cuda_hashset._workspace(dev, 7, 256, 20)
    assert small.data_ptr() == claim.data_ptr() and code2 == code - 1
    assert slot2.data_ptr() == slot.data_ptr()
    big, code3, slot3 = cuda_hashset._workspace(dev, 7, 4096, 513)
    assert big.shape[0] == 4096 and bool((big == -1).all())
    assert code3 == cuda_hashset.FIRST_CODE and slot3.shape[0] == 1024
    assert len(cuda_hashset._CLAIMS) == len(cuda_hashset._SLOTS) == 1


# --- K2's protocol on the card, replayed on the CPU ---------------------

ALL_ONES = (1 << 64) - 1  # a claim word never written (the fill)
EMPTY = -1  # the empty slot, as the port's int64 table holds it
DONE, OVERFLOW = -2, -1  # row states of the kernel's scratch


class Claims:
    """One claim array, shared by the calls on every table of at most its
    capacity (as the wrapper's workspace is); each call's code is one below
    the last."""

    def __init__(self, cap):
        self.words = [ALL_ONES] * cap
        self.code = cuda_hashset.FIRST_CODE

    def next_tag(self):
        tag = self.code << 32
        self.code -= 1
        return tag


def replica_probe_insert(table, q, valid, claims, rng):
    """csrc/hashset.cu's three steps on the CPU.  Step 2's atomics (each
    CAS and each atomicMin, after a plain read of the slot) run one at a
    time in a random interleaving of the rows drawn from `rng`, standing in
    for racing blocks.  Updates `table`; -> (is_new, n_new, overflow)."""
    cap = table.shape[0]
    mask = cap - 1
    tab, keys = table.tolist(), q.tolist()
    home = hashset.home_slot(q, cap).tolist()
    ok = [True] * len(keys) if valid is None else valid.tolist()
    tag = claims.next_tag()

    # 1. find: read-only, so the row order does not matter
    slot = []
    for i, key in enumerate(keys):
        state = OVERFLOW if ok[i] else DONE
        pos = home[i]
        for _ in range(hashset.MAX_PROBES if ok[i] else 0):
            if tab[pos] == key:
                state = DONE
                break
            if tab[pos] == EMPTY:
                state = pos
                break
            pos = (pos + 1) & mask
        slot.append(state)

    # 2. insert and claim, from the empty slot find met, the budget counted
    # from the home slot
    def insert(i):
        pos = slot[i]
        for _ in range((pos - home[i]) & mask, hashset.MAX_PROBES):
            cur = tab[pos]
            yield
            if cur == EMPTY:  # atomicCAS(empty -> key)
                cur = tab[pos]
                if cur == EMPTY:
                    tab[pos] = cur = keys[i]
                yield
            if cur == keys[i]:
                slot[i] = pos
                claims.words[pos] = min(claims.words[pos], tag | i)  # atomicMin
                return
            pos = (pos + 1) & mask
        slot[i] = OVERFLOW

    running = [insert(i) for i, s in enumerate(slot) if s >= 0]
    while running:
        j = int(rng.integers(len(running)))
        try:
            next(running[j])
        except StopIteration:
            running[j] = running[-1]
            running.pop()

    # 3. winner
    is_new = torch.tensor([s >= 0 and claims.words[s] == tag | i for i, s in enumerate(slot)])
    table.copy_(torch.tensor(tab))
    return is_new, int(is_new.sum()), OVERFLOW in slot


def _batch(rng, m, invalid=0.0, dup=True):
    """m keys, a quarter of them copies of the first half, a share invalid."""
    keys = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    if dup:
        keys[m // 2 : m // 2 + m // 4] = keys[rng.integers(0, m // 2, size=m // 4)]
    q = pair_key(interop.from_u32(keys[:, 0], CPU), interop.from_u32(keys[:, 1], CPU))
    return q, torch.from_numpy(rng.random(m) >= invalid)


def _members(table):
    return torch.sort(table[table != EMPTY]).values


def _same_call(t_plain, t_rep, q, valid, claims, rng):
    """One call of each on its own table: identical winners, count,
    overflow and membership."""
    _, p_new, p_n, p_ovf = hashset.probe_insert(t_plain, q, valid)
    r_new, r_n, r_ovf = replica_probe_insert(t_rep, q, valid, claims, rng)
    assert torch.equal(r_new, p_new)
    assert r_n == int(p_n) and r_ovf == bool(p_ovf)
    assert torch.equal(_members(t_rep), _members(t_plain))


def _seeded_table(rng, cap, n):
    q, _ = _batch(rng, n, dup=False)
    return hashset.table_from_pairs(*split_key(q), min_cap=cap), q


def _case_duplicates(rng):
    q, _ = _batch(rng, 256)
    _same_call(hashset.new_table(512, CPU), hashset.new_table(512, CPU), q, None,
               Claims(512), rng)


def _case_preseeded(rng):
    table, seeded = _seeded_table(rng, 512, 32)
    q, _ = _batch(rng, 224)
    q = torch.cat([seeded, q])  # the seeded keys again
    _same_call(table.clone(), table.clone(), q, None, Claims(512), rng)


def _case_invalid(rng):
    table, seeded = _seeded_table(rng, 512, 32)
    q, valid = _batch(rng, 224, invalid=0.2)
    q = torch.cat([seeded, q])
    valid = torch.cat([torch.from_numpy(rng.random(32) >= 0.2), valid])
    _same_call(table.clone(), table.clone(), q, valid, Claims(512), rng)


def _case_successive_calls(rng):
    """Five calls on one table and one claim array: the code falls, the
    claim words are never reset; each batch repeats half of the last."""
    t_plain, t_rep, claims = hashset.new_table(1024, CPU), hashset.new_table(1024, CPU), Claims(1024)
    last = None
    for _ in range(5):
        q, valid = _batch(rng, 96, invalid=0.1)
        if last is not None:
            q[:48] = last[48:]
        _same_call(t_plain, t_rep, q, valid, claims, rng)
        last = q


def _case_two_tables_one_claim_array(rng):
    """Two tables of one capacity, used in turn, share the claim array:
    words left by the other table's calls must lose to this call's."""
    claims = Claims(512)
    tables = [(hashset.new_table(512, CPU), hashset.new_table(512, CPU)) for _ in range(2)]
    for call in range(6):
        t_plain, t_rep = tables[call % 2]
        q, valid = _batch(rng, 64, invalid=0.1)
        _same_call(t_plain, t_rep, q, valid, claims, rng)


def _case_two_capacities_one_claim_array(rng):
    """A table of 256 slots and one of 1024 take turns on one claim array of
    1024 words: the smaller uses its first words, which both have left."""
    claims = Claims(1024)
    tables = [(hashset.new_table(cap, CPU), hashset.new_table(cap, CPU)) for cap in (256, 1024)]
    for call in range(6):
        t_plain, t_rep = tables[call % 2]
        q, valid = _batch(rng, 48, invalid=0.1)
        _same_call(t_plain, t_rep, q, valid, claims, rng)


def _case_overflow_then_growth(rng):
    """A table far too small overflows; grown and re-run, OR-ing novelty
    and summing counts as check() does, the replica gives the plain
    loop's winners, count and membership."""
    q, valid = _batch(rng, 200, invalid=0.05)
    results = []
    for replica in (False, True):
        table, claims = hashset.new_table(32, CPU), None
        isnew, total, growths = torch.zeros(200, dtype=torch.bool), 0, 0
        while True:
            if replica:
                if claims is None or len(claims.words) < table.shape[0]:
                    claims = Claims(table.shape[0])  # the wrapper's fresh, larger array
                new, n, ovf = replica_probe_insert(table, q, valid, claims, rng)
            else:
                table, new, n, ovf = hashset.probe_insert(table, q, valid)
            isnew |= new
            total += int(n)
            if not bool(ovf):
                break
            growths += 1
            table = hashset.rehash_into(table, 2 * table.shape[0])
        assert growths > 0 and total == int(isnew.sum())
        results.append((isnew, _members(table)))
    (p_new, p_mem), (r_new, r_mem) = results
    assert torch.equal(r_new, p_new) and torch.equal(r_mem, p_mem)


PROTOCOL_CASES = {
    "duplicates": _case_duplicates,
    "preseeded": _case_preseeded,
    "invalid": _case_invalid,
    "successive_calls": _case_successive_calls,
    "two_tables_one_claim_array": _case_two_tables_one_claim_array,
    "two_capacities_one_claim_array": _case_two_capacities_one_claim_array,
    "overflow_then_growth": _case_overflow_then_growth,
}


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("case", list(PROTOCOL_CASES))
def test_kernel_protocol_replica_equals_plain(case, seed):
    PROTOCOL_CASES[case](np.random.default_rng(1000 * seed + len(case)))
