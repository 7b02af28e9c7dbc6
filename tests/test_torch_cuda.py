"""PyTorch port on the card: each CUDA kernel against its plain version, and
check() on the card against check() on the CPU.  Marked `cuda`; every test
skips when no card is present.  Run them on a machine with one (JAX is
not needed there, hence no conftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_specification_tpu_torch import check
from kafka_specification_tpu_torch.models import kip320, variants
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.ops import build, cuda_fingerprint, cuda_hashset, cuda_ladder, hashset
from kafka_specification_tpu_torch.engine import pipeline
from kafka_specification_tpu_torch.ops import dedup
from kafka_specification_tpu_torch.ops.dedup import pair_key
from torch_guards import overlap_guard  # noqa: F401  (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_k1_bit_identical_to_plain(card):
    rng = np.random.default_rng(0)
    for m, k in ((1, 1), (1000, 3), (65537, 7)):
        lanes = torch.from_numpy(rng.integers(0, 2**32, size=(m, k), dtype=np.uint32).astype(np.int64)).to(card)
        valid = torch.from_numpy(rng.random(m) < 0.8).to(card)
        before = cuda_fingerprint.LAUNCHES
        hi, lo = cuda_fingerprint.fingerprint(lanes, valid)
        assert cuda_fingerprint.LAUNCHES == before + 1
        p_hi, p_lo = cuda_fingerprint.fingerprint_plain(lanes, valid)
        assert torch.equal(hi, p_hi) and torch.equal(lo, p_lo)


def test_k2_same_winners_as_plain(card):
    rng = np.random.default_rng(1)
    m = 20000
    pairs = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32).astype(np.int64)
    pairs[m // 2 :] = pairs[rng.integers(0, m // 2, size=m - m // 2)]
    q = pair_key(torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])).to(card)
    valid = torch.from_numpy(rng.random(m) < 0.9).to(card)
    seeded = q[: m // 8]
    table0 = hashset.table_from_pairs(*[(seeded >> 32) & 0xFFFFFFFF, seeded & 0xFFFFFFFF], min_cap=1 << 16)
    t_p, new_p, n_p, o_p = hashset.probe_insert(table0.clone(), q, valid)
    t_k, new_k, n_k, o_k = cuda_hashset.probe_insert(table0.clone(), q, valid)
    assert not bool(o_p) and not bool(o_k)
    assert torch.equal(new_p, new_k) and int(n_p) == int(n_k)
    live = lambda t: torch.sort(t[t != -1]).values
    assert torch.equal(live(t_p), live(t_k))


def test_k1_unaligned_view_and_wide_rows(card):
    """A view that starts off a 16-byte boundary takes the 8-byte staging
    path; K = 40 needs more than 48 KB of shared memory a block; K = 114
    does not fit and is refused."""
    rng = np.random.default_rng(2)
    for m, k, start in ((70001, 3, 1), (5000, 40, 0)):
        full = torch.from_numpy(rng.integers(0, 2**32, size=(m + start, k), dtype=np.uint32).astype(np.int64)).to(card)
        lanes = full[start:]
        valid = torch.from_numpy(rng.random(m) < 0.9).to(card)
        hi, lo = cuda_fingerprint.fingerprint(lanes, valid)
        p_hi, p_lo = cuda_fingerprint.fingerprint_plain(lanes, valid)
        assert torch.equal(hi, p_hi) and torch.equal(lo, p_lo)
    with pytest.raises(ValueError, match="lanes"):
        cuda_fingerprint.fingerprint(
            torch.zeros((4, cuda_fingerprint.MAX_LANES + 1), dtype=torch.int64, device=card),
            torch.ones(4, dtype=torch.bool, device=card),
        )


def _k2_keys(rng, m, card):
    pairs = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32).astype(np.int64)
    if m > 1:
        pairs[m // 2 :] = pairs[rng.integers(0, m // 2, size=m - m // 2)]
    return pair_key(torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])).to(card)


def _k2_same(t_plain, t_kern, q, valid):
    _, new_p, n_p, o_p = hashset.probe_insert(t_plain, q, valid)
    new_k, counts = cuda_hashset.launch(t_kern, q, valid)
    n_k, o_k = counts.tolist()
    assert not bool(o_p) and not o_k  # winners are defined only without overflow
    assert torch.equal(new_p, new_k) and int(n_p) == n_k
    live = lambda t: torch.sort(t[t != -1]).values
    assert torch.equal(live(t_plain), live(t_kern))


def test_k2_repeated_calls_alternating_tables(card):
    """Five calls on each of two tables of one capacity, in turn (the claim
    code falls every call and the claim words are never reset), with a
    mask and without, then M = 1 and M = 0."""
    rng = np.random.default_rng(4)
    tables = [(hashset.new_table(1 << 14, card), hashset.new_table(1 << 14, card)) for _ in range(2)]
    for call in range(10):
        q = _k2_keys(rng, 3000, card)
        valid = None if call % 3 == 0 else torch.from_numpy(rng.random(3000) < 0.9).to(card)
        _k2_same(*tables[call % 2], q, valid)
    for m in (1, 0):
        _k2_same(*tables[0], _k2_keys(rng, m, card), None)


def test_k2_workspace_reused_and_remade_on_growth(card):
    """The claim words and the row scratch are kept per (device, stream),
    allocated once and reused; a table larger than the claim words gets
    fresh ones in their place, a longer batch a longer scratch, and nothing
    else is kept."""
    cuda_hashset._CLAIMS.clear()
    cuda_hashset._SLOTS.clear()
    rng = np.random.default_rng(5)
    table = hashset.new_table(1 << 12, card)
    key = (table.device.index, torch.cuda.current_stream(card).cuda_stream)
    cuda_hashset.probe_insert(table, _k2_keys(rng, 500, card))
    claim, code = cuda_hashset._CLAIMS[key]
    slot = cuda_hashset._SLOTS[key]
    assert claim.shape[0] == 1 << 12 and slot.shape[0] == 512
    cuda_hashset.probe_insert(table, _k2_keys(rng, 400, card))
    again, code2 = cuda_hashset._CLAIMS[key]
    assert again.data_ptr() == claim.data_ptr() and code2 == code - 1
    assert cuda_hashset._SLOTS[key].data_ptr() == slot.data_ptr()
    m = slot.shape[0] + 1  # longer than the row scratch
    cap = 2 * max(claim.shape[0], 1 << (4 * m - 1).bit_length())  # room enough not to overflow
    grown = hashset.rehash_into(table, cap)
    _k2_same(grown.clone(), grown, _k2_keys(rng, m, card), None)
    assert cuda_hashset._CLAIMS[key][0].shape[0] == cap > claim.shape[0]
    assert cuda_hashset._SLOTS[key].shape[0] >= m > slot.shape[0]
    assert list(cuda_hashset._CLAIMS) == list(cuda_hashset._SLOTS) == [key]


def test_check_on_card_equals_cpu(card):
    cfg = Config(2, 2, 2, 2)
    on_card, on_cpu = [], []
    r_card = check(kip320.make_model(cfg), device=card, collect_levels=on_card)
    r_cpu = check(kip320.make_model(cfg), device="cpu", collect_levels=on_cpu)
    assert r_card.levels == r_cpu.levels and r_card.total == 5973
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    invs = ("TypeOk", "WeakIsr")
    m = lambda: variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1), invs)
    assert check(m(), device=card).violation.trace == check(m(), device="cpu").violation.trace


def _simulate_both(make, card, **kw):
    """simulate() of make() on the card and on the CPU, walk for walk: the
    states visited after each walk, the total, and the violation with its
    state and trace (or none on both)."""
    from kafka_specification_tpu_torch.engine.simulate import simulate

    walks_card, walks_cpu = [], []
    s_card = simulate(make(), device=card, progress=lambda w, v: walks_card.append((w, v)), **kw)
    s_cpu = simulate(make(), device="cpu", progress=lambda w, v: walks_cpu.append((w, v)), **kw)
    assert walks_card == walks_cpu and s_card.total == s_cpu.total
    assert s_card.stats["device"].startswith("cuda")
    assert (s_card.violation is None) == (s_cpu.violation is None)
    if s_cpu.violation is not None:
        a, b = s_card.violation, s_cpu.violation
        assert (a.invariant, a.depth, a.state, a.trace) == (b.invariant, b.depth, b.state, b.trace)
    return s_card


@pytest.mark.parametrize("backend", ["device", "device-hash"])
def test_async_isr_on_card_equals_cpu(card, backend):
    """AsyncIsr 3r M3 V3 (48,120 states, 3 lanes: hashed fingerprints, K1)
    on the card: every level's rows equal the CPU run's; and a walk of
    simulate equal step for step."""
    from kafka_specification_tpu_torch.models import async_isr

    m = lambda: async_isr.make_model(async_isr.AsyncIsrConfig(3, 3, 3))
    on_card, on_cpu = [], []
    k1 = cuda_fingerprint.LAUNCHES
    r_card = check(m(), device=card, visited_backend=backend, collect_levels=on_card)
    assert cuda_fingerprint.LAUNCHES > k1
    r_cpu = check(m(), device="cpu", visited_backend=backend, collect_levels=on_cpu)
    assert r_card.levels == r_cpu.levels and (r_card.total, r_card.diameter) == (48120, 23)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    _simulate_both(m, card, num_walks=5, max_depth=30, seed=1)


def test_product_cut_on_card_equals_cpu(card):
    """TINY^2 (Kip320 2r L2 R1 E1, two partitions: 18 actions) cut at
    depth 12: the levels are the closed form's, every level's rows equal
    the CPU run's; and a product violation's trace equals the CPU's, in
    check() and in simulate() walk for walk."""
    from kafka_specification_tpu_torch.models.product import product_model

    base = [1, 4, 12, 18, 36, 44, 48, 48, 30, 22, 12, 2]
    m = lambda: product_model(kip320.make_model(Config(2, 2, 1, 1), ("TypeOk",)), 2)
    on_card, on_cpu = [], []
    r_card = check(m(), device=card, max_depth=12, collect_levels=on_card)
    r_cpu = check(m(), device="cpu", max_depth=12, collect_levels=on_cpu)
    assert r_card.levels == r_cpu.levels == np.convolve(base, base)[:13].tolist()
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    invs = ("TypeOk", "WeakIsr")
    v = lambda: product_model(variants.make_model("KafkaTruncateToHighWatermark",
                                                  Config(2, 2, 1, 1), invs), 2)
    assert check(v(), device=card).violation.trace == check(v(), device="cpu").violation.trace
    assert _simulate_both(v, card, num_walks=200, max_depth=30, seed=0).violation is not None


def test_sorted_path_on_card_equals_cpu_with_k1(card):
    """The default path (sorted set, fused, compact order above the gate)
    on Kip320 3r, cut at depth 11 (levels up to 40,629 states, so chunks
    of 8,192 rows and more take action-major order): every level's rows
    equal the CPU run's, and every fingerprint came from K1."""
    cfg = Config(3, 2, 2, 2)
    on_card, on_cpu = [], []
    before = cuda_fingerprint.LAUNCHES
    r_card = check(kip320.make_model(cfg), device=card, max_depth=11, collect_levels=on_card)
    launched = cuda_fingerprint.LAUNCHES - before
    r_cpu = check(kip320.make_model(cfg), device="cpu", max_depth=11, collect_levels=on_cpu)
    assert r_card.stats["visited_backend"] == "device" and r_card.stats["pipeline"] == "fused"
    assert r_card.levels == r_cpu.levels and len(r_card.levels) == 12
    assert r_card.stats["visited_capacity"] == r_cpu.stats["visited_capacity"]
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    # one K1 launch for the inits and one a chunk (one chunk a level here),
    # and one a level for the digest chain's check of the frontier about to
    # be expanded (depths 0-11)
    assert launched == 1 + 11 + 12


def test_host_backend_on_card_equals_cpu(card):
    """visited_backend="host" on Kip320 3r (three lanes: hashed
    fingerprints) cut at depth 11: the card fingerprints (K1), the native
    set on the host dedups; every level's rows equal the CPU run's, K2
    idle."""
    cfg = Config(3, 2, 2, 2)
    on_card, on_cpu = [], []
    k1, k2 = cuda_fingerprint.LAUNCHES, cuda_hashset.LAUNCHES
    r_card = check(kip320.make_model(cfg), device=card, visited_backend="host", max_depth=11,
                   collect_levels=on_card)
    assert cuda_fingerprint.LAUNCHES > k1 and cuda_hashset.LAUNCHES == k2
    r_cpu = check(kip320.make_model(cfg), device="cpu", visited_backend="host", max_depth=11,
                  collect_levels=on_cpu)
    assert r_card.levels == r_cpu.levels and r_card.total == 109_030
    assert r_card.stats["host_fpset_size"] == 109_030
    for a, b in zip(on_card, on_cpu):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("backend", ["device", "device-hash", "host"])
def test_checkpoint_round_trip_on_card(card, backend, tmp_path):
    """A checkpoint written on the card resumes on the card and on the CPU,
    and one written on the CPU resumes on the card: the levels and digest
    chain of an uninterrupted CPU run.  A device-hash resume rebuilds the
    table through K2."""
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    def chain(d):
        return verify_file(str(d / CHECKPOINT_BASENAME))["digest_chain"]

    model = lambda: kip320.make_model(Config(2, 2, 2, 2))  # noqa: E731
    ref = check(model(), device="cpu", visited_backend=backend,
                checkpoint_dir=str(tmp_path / "ref"))
    for first, then in ((card, card), (card, "cpu"), ("cpu", card)):
        d = tmp_path / f"{first}-{then}"
        check(model(), device=first, visited_backend=backend, checkpoint_dir=str(d), max_depth=7)
        k2 = cuda_hashset.LAUNCHES
        res = check(model(), device=then, visited_backend=backend, checkpoint_dir=str(d))
        assert res.levels == ref.levels and res.total == 5973
        assert np.array_equal(chain(d), chain(tmp_path / "ref"))
        if backend == "device-hash" and then == card:
            assert cuda_hashset.LAUNCHES > k2


@pytest.mark.parametrize("pipeline", ["fused", "device"])
def test_disk_tier_on_card_equals_cpu(card, pipeline, monkeypatch, tmp_path):
    """The disk tier with the frontier on the card: Kip320 3r L2 R1 E1
    (6,787 states, 3 lanes: hashed fingerprints) through forced spills and
    merges, cut at depth 9 with a checkpoint and resumed on the card; the
    levels, the spill counts, the spill files byte for byte and the chain
    equal a CPU run's, and K1 ran on the card."""
    import os

    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    monkeypatch.setenv("KSPEC_SPILL_SEG_ROWS", "97")
    monkeypatch.setenv("KSPEC_SPILL_RUNS_PER_MERGE", "2")
    model = lambda: kip320.make_model(Config(3, 2, 1, 1))  # noqa: E731
    # the serial paths: with the overlap layer on, thread timing decides
    # when a background merge is adopted, and with it the run files
    kw = dict(mem_budget="8K", pipeline=pipeline, min_bucket=32, chunk_size=256, compact_gate=32,
              overlap=False)
    runs = {}
    for dev in (card, "cpu"):
        d = tmp_path / str(dev)
        k1 = cuda_fingerprint.LAUNCHES
        check(model(), device=dev, checkpoint_dir=str(d), max_depth=9, **kw)
        res = check(model(), device=dev, checkpoint_dir=str(d), **kw)
        if dev == card:
            assert cuda_fingerprint.LAUNCHES > k1
        files = {}
        for root, _dirs, names in os.walk(d / "spill"):
            for name in names:
                files[os.path.relpath(os.path.join(root, name), d)] = open(
                    os.path.join(root, name), "rb").read()
        runs[str(dev)] = (res, files, verify_file(str(d / CHECKPOINT_BASENAME))["digest_chain"])
    (r_card, f_card, c_card), (r_cpu, f_cpu, c_cpu) = runs[str(card)], runs["cpu"]
    assert r_card.ok and r_card.total == 6787 and r_card.levels == r_cpu.levels
    assert r_card.stats["spill"] == r_cpu.stats["spill"] and r_card.stats["spill"]["merges"] > 0
    assert f_card == f_cpu and np.array_equal(c_card, c_cpu)


def test_fp_stage_launches_k1_never_plain(card, monkeypatch):
    spec = kip320.make_model(Config(3, 2, 2, 2)).spec
    rows = torch.from_numpy(
        np.random.default_rng(4).integers(0, 2**20, size=(5000, spec.num_lanes)).astype(np.int64)
    ).to(card)
    want = cuda_fingerprint.fingerprint_plain(rows, torch.ones(5000, dtype=torch.bool, device=card))

    def no_plain(*a):
        raise AssertionError("the plain fingerprint ran on the card")

    monkeypatch.setattr(cuda_fingerprint, "fingerprint_plain", no_plain)
    before = cuda_fingerprint.LAUNCHES
    hi, lo = pipeline.fp_stage(spec, rows)
    assert cuda_fingerprint.LAUNCHES == before + 1
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])


def test_merge_ranked_at_cap_2_22_equals_cpu(card):
    rng = np.random.default_rng(9)
    cap, n, m = 1 << 22, (1 << 21) + 12345, 100000
    keys = np.unique(rng.integers(-(2**63), 2**63 - 1, size=n + m, dtype=np.int64))
    rng.shuffle(keys)
    old = torch.sort(torch.from_numpy(keys[:n])).values
    new = torch.sort(torch.from_numpy(keys[n:])).values
    set_keys = torch.cat([old, torch.full((cap - old.shape[0],), dedup.PAD)])
    outs = []
    for dev in (card, torch.device("cpu")):
        s, q = set_keys.to(dev), new.to(dev)
        found, rank = dedup.rank_sorted(s, old.shape[0], q)
        assert not bool(found.any())
        merged, size = dedup.merge_ranked(s, old.shape[0], q, rank, 2 * cap)
        outs.append((merged.cpu(), size))
    assert outs[0][1] == outs[1][1] == old.shape[0] + new.shape[0]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[1][0][: outs[1][1]], torch.sort(torch.cat([old, new])).values)


def _ladder_input(kind):
    rng = np.random.default_rng(3)
    if kind == "arange256":
        x = np.arange(256)
    elif kind == "random65536":  # 256 blocks: a rung that races across blocks shows it
        x = rng.integers(0, 2**32, size=65536, dtype=np.uint32)
    elif kind == "clamp_n4_x0_6":
        x = np.concatenate([[6], rng.integers(0, 2**32, size=3, dtype=np.uint32)])
    elif kind == "top_bit_then_ones":
        x = np.full(256, 0xFFFFFFFF, dtype=np.uint32)
        x[0] = 0x80000000
    else:
        x = np.full(256, 0xFFFFFFFF, dtype=np.uint32)
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


@pytest.mark.parametrize(
    "kind", ["arange256", "random65536", "clamp_n4_x0_6", "top_bit_then_ones", "all_ones"]
)
@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_k4_rung_bit_identical_to_plain(card, rung, kind):
    x = _ladder_input(kind).to(card)
    before = cuda_ladder.LAUNCHES[rung]
    got = cuda_ladder.run(rung, x)
    torch.cuda.synchronize()
    assert cuda_ladder.LAUNCHES[rung] == before + 1
    assert torch.equal(got, cuda_ladder.PLAIN[rung](x))


def test_k4_ladder_script_exits_3_when_a_rung_differs(card, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "cuda_kernel_ladder", Path(__file__).resolve().parents[1] / "scripts" / "cuda_kernel_ladder.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--n", "256"]) == 0
    monkeypatch.setitem(cuda_ladder.PLAIN, "dyn_read", cuda_ladder.PLAIN["vec"])
    assert script.main(["--n", "256"]) == 3
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 12 and '"ok": false' in lines[9]


def _u32(rng, n):
    return torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64))


@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_k4_rung_bit_identical_past_the_vectors(card, rung):
    """n = 2^24 + 3 (a tail after the 16-byte vectors, a grid smaller than
    the work), an int32 view one element into its storage (the 4-byte
    path), and pos in the tail and in the last vector."""
    rng = np.random.default_rng(6)
    big = _u32(rng, (1 << 24) + 3).to(card)
    base = _u32(rng, 70002).to(card)
    cases = [(cuda_ladder.to_i32(big), big),
             (cuda_ladder.to_i32(base)[1:], base[1:]),
             (cuda_ladder.to_i32(base[:10])[1:], base[1:10])]
    for n, x0 in ((7, 6), (9, 6), (3, 2)):
        x = _u32(rng, n)
        x[0] = x0
        cases.append((cuda_ladder.to_i32(x.to(card)), x.to(card)))
    for x32, x in cases:
        got = cuda_ladder.from_i32(cuda_ladder.launch(rung, x32))
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_ladder.PLAIN[rung](x)), (x.shape[0], x32.data_ptr() % 16)


def test_stream_handle_is_the_current_stream(card):
    index = card.index if card.index is not None else torch.cuda.current_device()
    assert build.stream_handle(index) == torch.cuda.current_stream(card).cuda_stream
    s = torch.cuda.Stream(card)
    with torch.cuda.stream(s):
        assert build.stream_handle(index) == s.cuda_stream
        assert build.stream_handle(index) == torch.cuda.current_stream(card).cuda_stream
    assert build.stream_handle(index) == torch.cuda.current_stream(card).cuda_stream != s.cuda_stream


def test_k4_rung_runs_on_the_current_stream(card):
    """On a side stream held by a sleep, x is written and then the rung
    launched: a rung launched on any other stream would read x before the
    write and give the wrong bits."""
    n = 1 << 20
    fresh = torch.arange(n, dtype=torch.int32, device=card) * 7 + 1
    x32 = torch.zeros(n, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(card)
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)  # some tens of ms
        x32.copy_(fresh)
        out = cuda_ladder.launch("dyn_read", x32)
    torch.cuda.synchronize()
    x = cuda_ladder.from_i32(fresh)
    assert torch.equal(cuda_ladder.from_i32(out), cuda_ladder.PLAIN["dyn_read"](x))


# --------------------------------------------------------------------------
# the device-resident level pipeline (pipeline="device") on the card: the
# twins of tests/test_torch_device_pipeline.py, held against the CPU run
# --------------------------------------------------------------------------

DEVICE_KW = dict(pipeline="device", min_bucket=32, chunk_size=256, compact_gate=32)


def _recorded_chains(monkeypatch):
    from kafka_specification_tpu_torch.resilience import integrity

    made, base = [], integrity.LevelDigestChain

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(integrity, "LevelDigestChain", Recording)
    return made


def _device_both(make, card, monkeypatch, tmp_path, **kw):
    """check(**DEVICE_KW, **kw) of make() on the card and on the CPU: every
    level's rows, the violation and trace, the stats lines, stats["device"]
    and the digest chain equal.  -> the card's result."""
    import json

    chains = _recorded_chains(monkeypatch)
    runs = []
    for dev in (card, "cpu"):
        levels, path = [], tmp_path / f"stats-{len(runs)}.jsonl"
        res = check(make(), device=dev, collect_levels=levels, stats_path=str(path),
                    **{**DEVICE_KW, **kw})
        lines = [{k: v for k, v in json.loads(line).items() if not k.endswith("ms")
                  and k not in ("ts", "unix")} for line in path.read_text().splitlines()]
        runs.append((res, [x.cpu() for x in levels], lines, chains[-1].to_array()))
    (a, la, sa, ca), (b, lb, sb, cb) = runs
    assert a.levels == b.levels and len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert (a.violation is None) == (b.violation is None)
    if b.violation is not None:
        assert (a.violation.invariant, a.violation.depth, a.violation.trace) == \
            (b.violation.invariant, b.violation.depth, b.violation.trace)
    assert sa == sb and np.array_equal(ca, cb)
    assert a.stats["device"] == b.stats["device"]
    return a


@pytest.mark.parametrize("backend", ["device", "host"])
def test_device_pipeline_on_card_equals_cpu(card, backend, monkeypatch, tmp_path):
    invs = ("TypeOk", "WeakIsr")
    thw = lambda: variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1), invs)
    res = _device_both(thw, card, monkeypatch, tmp_path, visited_backend=backend)
    assert res.violation.depth == 8 and res.stats["device"]["levels"] > 0
    k1 = cuda_fingerprint.LAUNCHES  # 3r packs to three lanes: hashed, by K1
    res = _device_both(lambda: kip320.make_model(Config(3, 2, 2, 2)), card, monkeypatch,
                       tmp_path, visited_backend=backend, max_depth=10)
    assert cuda_fingerprint.LAUNCHES > k1
    assert res.stats["device"]["fallback"] is None and res.total == 68_401


def test_device_pipeline_edges_on_card(card, monkeypatch, tmp_path):
    """device-hash degrades; the un-gated tail chunk; a forced width
    overflow and a forced level-new overflow re-dispatch: each as on the
    CPU."""
    from kafka_specification_tpu_torch.ops import devlevel
    from kafka_specification_tpu_torch.pipeline_registry import backend_fallback_reason

    invs = ("TypeOk", "WeakIsr")
    thw = lambda: variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1), invs)
    res = _device_both(thw, card, monkeypatch, tmp_path, visited_backend="device-hash")
    assert res.stats["device"] == {"levels": 0,
                                   "fallback": backend_fallback_reason("device", "device-hash")}
    tail = dict(min_bucket=16, chunk_size=32)
    assert _device_both(thw, card, monkeypatch, tmp_path, **tail).violation.depth == 8
    real = pipeline.DevicePipeline.widths
    monkeypatch.setattr(pipeline.DevicePipeline, "widths", lambda self, B, counts=None: (
        real(self, B, counts) if counts is not None else (1,) * len(self.model.actions)))
    _device_both(thw, card, monkeypatch, tmp_path)
    monkeypatch.setattr(pipeline.DevicePipeline, "widths", real)
    monkeypatch.setattr(devlevel, "level_new_capacity", lambda T, hw, worst: 8)
    _device_both(thw, card, monkeypatch, tmp_path, **tail)


def test_device_level_helpers_on_card(card):
    """The digest on the card against digest_fps (bit 63 set on many), and
    the fixed-capacity rank and merge against their CPU runs."""
    from kafka_specification_tpu_torch.ops import devlevel
    from kafka_specification_tpu_torch.resilience import integrity

    rng = np.random.default_rng(11)
    fps = rng.integers(0, 2**64, size=200_000, dtype=np.uint64)
    fps[::3] |= np.uint64(1 << 63)
    keep = rng.random(fps.shape[0]) < 0.6
    d = devlevel.masked_digest(torch.from_numpy(fps.view(np.int64)).to(card),
                               torch.from_numpy(keep).to(card))
    assert devlevel.digest_ints(d) == integrity.digest_fps(fps[keep])
    pool = np.unique(rng.integers(-(2**62), 2**62, size=300_000))
    rng.shuffle(pool)
    old, new = np.sort(pool[:100_000]), np.sort(pool[100_000:150_000])
    cap = 1 << 18
    keys = torch.cat([torch.from_numpy(old), torch.full((cap - old.shape[0],), dedup.PAD)])
    newk = torch.cat([torch.from_numpy(new), torch.full((1000,), dedup.PAD)])
    rank = dedup.rank_full(keys, newk)[1]
    for t in (keys, newk, rank):
        assert t.device.type == "cpu"
    want = dedup.merge_full(keys, torch.tensor(old.shape[0]), newk, rank, torch.tensor(new.shape[0]))
    got_rank = dedup.rank_full(keys.to(card), newk.to(card))[1]
    got = dedup.merge_full(keys.to(card), torch.tensor(old.shape[0], device=card), newk.to(card),
                           got_rank, torch.tensor(new.shape[0], device=card))
    assert torch.equal(got_rank.cpu(), rank) and torch.equal(got.cpu(), want)


def test_device_level_queues_without_a_sync(card):
    """A level of Kip320 3r (the frontier at depth 9, one chunk) queued under
    set_sync_debug_mode("error"), K1 launched inside it."""
    from kafka_specification_tpu_torch.engine import bfs
    from kafka_specification_tpu_torch.ops import devlevel

    model = kip320.make_model(Config(3, 2, 2, 2))
    levels = []
    check(model, device=card, pipeline="device", max_depth=9, collect_levels=levels)
    visited = bfs._SortedVisited.fresh(*pipeline.fp_stage(model.spec, torch.cat(levels)), 1 << 16)
    pipe = pipeline.DevicePipeline(model, "device", True, False, 2, 4096)
    B, nc, handled = pipe.plan_level(levels[9].shape[0], 32768, 256)
    widths = pipe.widths(B, np.full(len(model.actions), B * 4.0))
    LN = devlevel.level_new_bound(nc * sum(widths))
    visited.reserve(LN + sum(widths))
    torch.cuda.synchronize()
    k1 = cuda_fingerprint.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = pipe.queue_level(levels[9], handled, B, nc, widths, LN, visited.keys)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_fingerprint.LAUNCHES == k1 + nc
    ovf, kind, _, _, on, *_ = pipe.read_level(st)
    assert not ovf and kind == 0 and on == 28_818


def _run_dir_content(run):
    """The clock-free content of a run directory: file names, manifest
    config and result, stats lines, spans per level and metrics."""
    import json
    import os
    import re

    def records(path):
        with open(path) as fh:
            return [json.loads(line) for line in fh.read().splitlines()]

    clock = ("ts", "unix", "t0", "ms", "span_id", "parent_id", "run_id", "level_ms", "step_ms",
             "host_ms", "dispatch_ms", "wait_ms", "queued_ms", "seconds", "states_per_sec")
    with open(run.manifest_path) as fh:
        man = json.load(fh)
    prom = {}
    with open(run.metrics_prom) as fh:
        for line in fh:
            if not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                prom[re.sub(r',?run_id="[^"]*"', "", key)] = value.strip()
    timed = ("kspec_rss_bytes", "kspec_states_per_sec", "kspec_level_ms", "kspec_step_ms_total",
             "kspec_host_ms_total")
    return {
        "files": sorted(os.listdir(run.dir)),
        "config": {k: v for k, v in man["config"].items() if k != "platform"},
        "status": man["status"],
        "result": {k: v for k, v in man["result"].items() if k not in clock},
        "stats": [{k: v for k, v in r.items() if k not in clock} for r in records(run.stats_path)],
        "spans": [{k: v for k, v in r.items() if k not in clock} for r in records(run.spans_path)],
        "metrics": {k: v for k, v in prom.items() if not k.startswith(timed)},
    }


@pytest.mark.parametrize("pipeline", ["fused", "device"])
def test_run_dir_on_card_equals_cpu(card, pipeline, tmp_path):
    """check(run=) on the card writes the run directory a CPU run writes,
    clock-free field for clock-free field (the platform aside), and K1 ran."""
    from kafka_specification_tpu_torch.obs import RunContext, metrics, tracer

    kw = dict(pipeline=pipeline, min_bucket=32, chunk_size=256, compact_gate=32)
    got = {}
    for dev in (card, "cpu"):
        run = RunContext(str(tmp_path / str(dev)))
        k1 = cuda_fingerprint.LAUNCHES
        res = check(kip320.make_model(Config(3, 2, 1, 1)), device=dev, run=run, **kw)
        assert res.ok and res.total == 6787
        assert tracer.current_tracer() is None and metrics.current_registry() is None
        if dev == card:
            assert cuda_fingerprint.LAUNCHES > k1
        got[str(dev)] = (_run_dir_content(run), run)
    assert got[str(card)][0] == got["cpu"][0]
    import json

    with open(got[str(card)][1].manifest_path) as fh:
        assert json.load(fh)["config"]["platform"] == "gpu"


def test_profiler_window_sees_k1(card, tmp_path):
    """A torch.profiler window of obs/tracer.py around a check on the card
    records one device event of K1's kernel for each counted launch."""
    import json

    from kafka_specification_tpu_torch.obs.tracer import start_profiler, stop_profiler

    prof = start_profiler()
    k1 = cuda_fingerprint.LAUNCHES
    try:
        res = check(kip320.make_model(Config(3, 2, 1, 1)), device=card)
        torch.cuda.synchronize()
    finally:
        stop_profiler(prof, str(tmp_path / "trace.json"))
    launches = cuda_fingerprint.LAUNCHES - k1
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    k1_events = [e for e in events
                 if e.get("cat") == "kernel" and "fingerprint_kernel" in e.get("name", "")]
    assert res.total == 6787 and launches > 0 and len(k1_events) == launches
    assert not torch.autograd.profiler._is_profiler_enabled


@pytest.mark.parametrize("backend", ["device", "host"])
def test_staged_loop_on_the_card_equals_serial(card, backend, tmp_path):
    """The overlap layer's two-slot staged chunk loop on the card: Kip320 3r
    L2 R1 E1 (6,787 states, hashed fingerprints) at chunk_size=256, several
    chunks a level, gives the serial loop's levels, chain and K1 launches
    (their host copies go through page-locked buffers behind an event), and
    the CPU run's levels and chain."""
    import os

    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    model = lambda: kip320.make_model(Config(3, 2, 1, 1))  # noqa: E731
    kw = dict(min_bucket=32, chunk_size=256, visited_backend=backend)
    out = {}
    for dev, on in ((card, True), (card, False), ("cpu", False)):
        d = str(tmp_path / f"{dev}-{on}")
        k1 = cuda_fingerprint.LAUNCHES
        res = check(model(), device=dev, overlap=on, checkpoint_dir=d, **kw)
        chain = verify_file(os.path.join(d, CHECKPOINT_BASENAME))["digest_chain"]
        out[(str(dev), on)] = (res, cuda_fingerprint.LAUNCHES - k1, chain)
    (r_on, k_on, c_on), (r_off, k_off, c_off), (r_cpu, _, c_cpu) = out.values()
    assert r_on.ok and r_on.total == 6787 and r_on.levels == r_off.levels == r_cpu.levels
    assert np.array_equal(c_on, c_off) and np.array_equal(c_on, c_cpu)
    assert k_on == k_off > 0
    assert r_on.stats["overlap"]["staged_chunks_peak"] == 2
    assert r_off.stats["overlap"]["staged_chunks_peak"] == 0


def test_sweep_on_card_equals_cpu_and_repeats_as_hits(card, tmp_path, monkeypatch):
    """A sweep (sweep/) against an in-process daemon on the card: every row
    equals the same sweep on the CPU, K1 launches on the cold sweep, and a
    repeat sweep is all verified cache hits with no launch."""
    from kafka_specification_tpu_torch.service.daemon import Daemon, ServeConfig
    from kafka_specification_tpu_torch.sweep import SweepConfig, load_lattice, run_sweep

    monkeypatch.delenv("KSPEC_FAULT", raising=False)
    thw = (Path(__file__).resolve().parents[1] / "configs"
           / "KafkaTruncateToHighWatermark.cfg").read_text()
    lattice = {"schema": "kspec-sweep-lattice/1", "name": "card",
               "module": "KafkaTruncateToHighWatermark", "cfg_text": thw,
               "axes": [{"name": "max_depth", "kind": "bound", "values": [4, 8, None]}]}
    rows = {}
    for dev in ("cuda", "cpu"):
        svc = str(tmp_path / dev / "svc")
        d = Daemon(ServeConfig(svc, device=dev, linger_s=0.0))
        before = cuda_fingerprint.LAUNCHES
        rec = run_sweep(load_lattice(lattice), SweepConfig(
            sweep_dir=str(tmp_path / dev / "sw1"), service_dir=svc, drive=d.drain_once))
        rows[dev] = {pid: {k: r["verdict"][k] for k in ("distinct_states", "diameter",
                                                          "violation", "exit_code")}
                     for pid, r in rec["points"].items()}
        if dev == "cuda":
            assert cuda_fingerprint.LAUNCHES > before
            before = cuda_fingerprint.LAUNCHES
            rep = run_sweep(load_lattice(lattice), SweepConfig(
                sweep_dir=str(tmp_path / dev / "sw2"), service_dir=svc, drive=d.drain_once))
            assert [(r.get("cache") or {}).get("state_cache")
                    for r in rep["points"].values()] == ["hit"] * 3
            assert cuda_fingerprint.LAUNCHES == before
    assert rows["cuda"] == rows["cpu"]


def test_serve_fleet_on_card_finishes_a_crashed_job_once(card, tmp_path):
    """`cli serve-fleet --daemons 2` on the card with crash@daemon0:1 and
    crash@daemon1:1: the crashed slots restart and the Kip320 2r job is
    finished exactly once; SIGTERM stops the fleet with exit 0."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import time

    from kafka_specification_tpu_torch.service.queue import JobQueue

    repo = Path(__file__).resolve().parents[1]
    svc = str(tmp_path / "svc")
    q = JobQueue(svc)
    cfg = (repo / "configs" / "Kip320.cfg").read_text().replace(
        "Replicas = {b1, b2, b3}", "Replicas = {b1, b2}")
    job = q.submit(cfg, "Kip320")["job_id"]
    env = {**os.environ, "PYTHONPATH": str(repo),
           "KSPEC_FAULT": "crash@daemon0:1,crash@daemon1:1"}
    fleet = subprocess.Popen(
        [sys.executable, "-m", "kafka_specification_tpu_torch.cli", "serve-fleet", svc,
         "--daemons", "2", "--backoff-base", "0.5", "--poll", "0.2"],
        cwd=repo, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        deadline = time.monotonic() + 240
        while q.result(job) is None and time.monotonic() < deadline:
            time.sleep(0.5)
        fleet.send_signal(signal.SIGTERM)
        assert fleet.wait(timeout=60) == 0
    finally:
        if fleet.poll() is None:
            os.killpg(fleet.pid, signal.SIGKILL)
        fleet.communicate()
    rec = q.result(job)
    assert rec is not None and rec["exit_code"] == 0
    events = [json.loads(line) for line in open(os.path.join(svc, "service",
                                                             "fleet-events.jsonl"))]
    assert any(e["event"] == "daemon-restart" and e["why"] == "crash" for e in events)
    assert len([n for n in os.listdir(os.path.join(svc, "results"))
                if n.endswith(".json")]) == 1
    # each daemon on the card reports its peak device memory
    proms = [open(os.path.join(svc, "service", n)).read()
             for n in os.listdir(os.path.join(svc, "service")) if n.endswith(".prom")]
    assert proms and all("kspec_svc_device_peak_bytes" in p for p in proms)


def test_recorded_checkpointed_check_resumes_from_every_crash_state(card, tmp_path):
    """Kip320 2r on the card with a checkpoint every level: cut at depth 5,
    the leg to 6 recorded by durable_io's recorder, and every crash state
    of its ops (resilience/crashcheck/fsmodel) resumed on the card to the
    uncrashed run's levels and digest chain, which are the CPU run's (a
    state where no generation verifies must raise CheckpointCorrupt, and a
    fresh run then gives the same)."""
    from kafka_specification_tpu_torch import durable_io
    from kafka_specification_tpu_torch.engine.bfs import CHECKPOINT_BASENAME
    from kafka_specification_tpu_torch.resilience.checkpoints import (
        CheckpointCorrupt, verify_file)
    from kafka_specification_tpu_torch.resilience.crashcheck.fsmodel import (
        enumerate_crash_states, materialize, snapshot_tree)

    def model():
        return kip320.make_model(Config(2, 2, 1, 1))

    def chain(d):
        return verify_file(str(d / CHECKPOINT_BASENAME))["digest_chain"]

    ref = check(model(), device="cpu", checkpoint_dir=str(tmp_path / "cpu"))
    ck = tmp_path / "ck"
    check(model(), device=card, checkpoint_dir=str(ck), max_depth=5)
    base, dirs = snapshot_tree(str(ck))
    rec = durable_io.OpRecorder(str(ck))
    prev = durable_io.install(rec)
    try:
        check(model(), device=card, checkpoint_dir=str(ck), max_depth=6)
    finally:
        durable_io.install(prev)
    assert [op["op"] for op in rec.ops] == ["write", "rename", "rename", "rename"]
    states = enumerate_crash_states(base, rec.ops)
    assert len(states) >= 10
    for i, st in enumerate(states):
        dest = tmp_path / f"state-{i}"
        materialize(st, dirs, str(dest))
        try:
            res = check(model(), device=card, checkpoint_dir=str(dest))
        except CheckpointCorrupt:
            dest = tmp_path / f"fresh-{i}"
            res = check(model(), device=card, checkpoint_dir=str(dest))
        assert (res.levels, res.total, res.diameter) == (ref.levels, 277, ref.diameter), i
        np.testing.assert_array_equal(chain(dest), chain(tmp_path / "cpu"), err_msg=str(i))


def _sharded(mesh, backend, exchange, **kw):
    from kafka_specification_tpu_torch.parallel import check_sharded

    return check_sharded(kip320.make_model(Config(2, 2, 2, 2)), mesh=mesh, min_bucket=32,
                         chunk_size=256, visited_backend=backend, exchange=exchange, **kw)


@pytest.mark.parametrize("backend,exchange", [("device", "all_to_all"),
                                              ("device-hash", "all_to_all"),
                                              ("host", "all_to_all"), ("device", "all_gather")])
def test_sharded_eight_shards_on_card_equal_cpu(card, backend, exchange, tmp_path):
    """D = 8 shards on cuda:0 against the same D = 8 run on the CPU: levels,
    per-level records, the checkpoint's search arrays; K1 launched where a
    state takes more than two lanes (Kip320 2r takes two: a state is its
    own fingerprint, so no K1), and K2 on device-hash."""
    from kafka_specification_tpu_torch.parallel import ShardMesh
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    cpu = _sharded(ShardMesh(8, "cpu"), backend, exchange, checkpoint_dir=str(tmp_path / "c"))
    k1, k2 = cuda_fingerprint.LAUNCHES, cuda_hashset.LAUNCHES
    gpu = _sharded(ShardMesh(8, card), backend, exchange, checkpoint_dir=str(tmp_path / "g"))
    lanes = kip320.make_model(Config(2, 2, 2, 2)).spec.num_lanes
    assert (cuda_fingerprint.LAUNCHES > k1) == (lanes > 2)
    assert (cuda_hashset.LAUNCHES > k2) == (backend == "device-hash")
    assert gpu.ok and (gpu.levels, gpu.total) == (cpu.levels, cpu.total) == (gpu.levels, 5973)
    a = verify_file(str(tmp_path / "c" / "sharded_checkpoint.npz"))
    b = verify_file(str(tmp_path / "g" / "sharded_checkpoint.npz"))
    for k in ("pending", "pending_lens", "levels", "total", "digest_chain", "mesh_D"):
        assert np.array_equal(a[k], b[k]), k


def test_sharded_violation_trace_on_card_equals_cpu(card):
    from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded

    def run(dev):
        m = variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1),
                                ("TypeOk", "WeakIsr"))
        return check_sharded(m, mesh=ShardMesh(8, dev), min_bucket=8, chunk_size=8)

    cpu, gpu = run("cpu"), run(card)
    assert (gpu.violation.invariant, gpu.violation.depth) == ("WeakIsr", 8)
    assert gpu.violation.trace == cpu.violation.trace and gpu.levels == cpu.levels


def test_fpcompress_on_the_card_equals_the_numpy_twin(card):
    """The exchange codec (ops/fpcompress.py) on cuda tensors: a [D, W]
    batch of seeded buckets (empty, half full, full, clustered) packs to
    pack_np's words, headers and flags, and unpacks to the lanes."""
    from kafka_specification_tpu_torch.ops import fpcompress as fpc

    rng = np.random.default_rng(5)
    W, D = 200, 8
    counts = np.array([0, W // 2, W, 17, 90, 3, 150, 64])
    his, los = [], []
    for d in range(D):
        vals = np.sort(rng.integers(0, 2**64 - 2, size=int(counts[d]), dtype=np.uint64))
        if d == 3:
            vals = np.sort(np.uint64(1 << 40) + rng.integers(0, 1 << 20, size=17).astype(np.uint64))
        full = np.concatenate([vals, np.full(W - vals.shape[0], np.uint64(2**64 - 1))])
        his.append((full >> np.uint64(32)).astype(np.uint32))
        los.append((full & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi, lo = np.stack(his), np.stack(los)
    for NW in (fpc.default_stream_words(W), fpc.BLK):
        t = lambda a: torch.from_numpy(a.astype(np.int64)).to(card)  # noqa: E731
        words, hdr, ovf = fpc.pack_sorted(t(hi), t(lo), t(counts), NW)
        for d in range(D):
            wn, hn, on = fpc.pack_np(hi[d], lo[d], int(counts[d]), NW)
            assert np.array_equal(words[d].cpu().numpy(), wn) and np.array_equal(
                hdr[d].cpu().numpy(), hn) and bool(ovf[d]) == on, (NW, d)
        h2, l2 = fpc.unpack_sorted(words, hdr, W)
        ok = ~ovf.cpu().numpy()
        assert np.array_equal(h2.cpu().numpy()[ok], hi[ok])
        assert np.array_equal(l2.cpu().numpy()[ok], lo[ok])


def _sharded_device(dev, D=8, model=None, **kw):
    from kafka_specification_tpu_torch.parallel import ShardMesh, check_sharded

    m = model or variants.make_model("KafkaTruncateToHighWatermark", Config(2, 2, 1, 1),
                                     ("TypeOk", "WeakIsr"))
    return check_sharded(m, mesh=ShardMesh(D, dev), pipeline="device", min_bucket=8,
                         compact_gate=8, chunk_size=64, **kw)


@pytest.mark.parametrize("backend,exchange,compress", [
    ("device", "all_to_all", "1"), ("device", "all_to_all", "0"), ("device", "all_gather", "0"),
    ("host", "all_to_all", "1"), ("host", "all_to_all", "0")])
def test_sharded_device_level_on_card_equals_cpu(card, backend, exchange, compress,
                                                 monkeypatch):
    """The device-resident sharded level at D = 8 on cuda:0 against the
    same run on the CPU: levels, the verdict and its trace, stats["device"]
    and the launches a level (the model's states take two lanes: each is its
    own fingerprint, so no K1)."""
    monkeypatch.setenv("KSPEC_EXCHANGE_COMPRESS", compress)
    kw = dict(visited_backend=backend, exchange=exchange, stats_path="/dev/null")
    cpu = _sharded_device("cpu", **kw)
    gpu = _sharded_device(card, **kw)
    assert gpu.stats["device"] == cpu.stats["device"] and gpu.stats["device"]["levels"] > 0
    assert (gpu.levels, gpu.total) == (cpu.levels, cpu.total)
    assert gpu.violation.trace == cpu.violation.trace
    assert [lvl["shard_launches"] for lvl in gpu.stats["levels"]] == \
        [lvl["shard_launches"] for lvl in cpu.stats["levels"]]


def test_sharded_device_level_multi_chunk_on_card_equals_cpu(card, tmp_path):
    """Kip320 2r L2 R2 E2 at D = 8, chunks of 64 rows (several a level):
    the device level on the card equals it on the CPU, checkpoint arrays
    included."""
    from kafka_specification_tpu_torch.resilience.checkpoints import verify_file

    def run(dev, d):
        return _sharded_device(dev, model=kip320.make_model(Config(2, 2, 2, 2)),
                               checkpoint_dir=str(tmp_path / d), stats_path="/dev/null")

    cpu, gpu = run("cpu", "c"), run(card, "g")
    assert gpu.ok and (gpu.levels, gpu.total) == (cpu.levels, cpu.total) == (gpu.levels, 5973)
    assert gpu.stats["device"] == cpu.stats["device"]
    a = verify_file(str(tmp_path / "c" / "sharded_checkpoint.npz"))
    b = verify_file(str(tmp_path / "g" / "sharded_checkpoint.npz"))
    for k in ("pending", "pending_lens", "levels", "total", "digest_chain", "vn"):
        assert np.array_equal(a[k], b[k]), k


def test_sharded_device_level_under_nccl_world_size_1(card, monkeypatch):
    """A world-size-1 NCCL group (every exchange and the replicated
    election an NCCL collective) at D = 1: the CPU run's result."""
    from kafka_specification_tpu_torch.parallel import multihost

    cpu = _sharded_device("cpu", D=1)
    monkeypatch.setenv("KSPEC_MULTIHOST", "1")
    try:
        multihost.init_distributed(card)
        assert torch.distributed.get_backend() == "nccl"
        gpu = _sharded_device(card, D=1)
    finally:
        multihost.leave_distributed()
    assert gpu.stats["device"] == cpu.stats["device"] and gpu.stats["device"]["levels"] > 0
    assert (gpu.levels, gpu.violation.trace) == (cpu.levels, cpu.violation.trace)


def _queued_sharded_level(dev, debug_sync):
    """A Kip320 3r level at D = 8 (the frontier at depth 12 dealt to its
    owners, the states to depth 12 in each shard's sorted set) queued on
    the sharded device level at its exact widths (W = T), compressed and
    raw; with `debug_sync` under set_sync_debug_mode("error").  -> the
    two reads."""
    from kafka_specification_tpu_torch.ops import devlevel
    from kafka_specification_tpu_torch.parallel import ShardMesh, sharded

    model = kip320.make_model(Config(3, 2, 2, 2))
    levels = []
    check(model, device=dev, max_depth=12, collect_levels=levels, store_trace=False)
    D = 8
    mesh = ShardMesh(D, dev)
    _, flo = pipeline.fp_stage(model.spec, levels[12])
    pending = [levels[12][(flo % D) == d] for d in range(D)]
    hi, lo = pipeline.fp_stage(model.spec, torch.cat(levels))
    sets = sharded._ShardSets("device", mesh)
    pairs = {}
    for d in range(D):
        m = (lo % D) == d
        pairs[d] = dedup.order_key_to_pair(torch.sort(dedup.order_key(hi[m], lo[m])).values)
    sets.build(pairs, None, cap=1 << 20)
    sdev = sharded.ShardedDeviceLevel(model, mesh, "device", False, 2, 1024, "all_to_all")
    lens = [p.shape[0] for p in pending]
    prev_base = np.concatenate([[0], np.cumsum(lens)])
    B, nc = sdev.plan_level(lens, 16384, 256)
    first = sdev.read_level(sdev.queue_level(pending, lens, prev_base, B, nc, sdev.widths(B),
                                             1 << 16, 1 << 12, False, sets.keys, sets.vn))
    widths = sdev.exact_widths(B, first.agmax.max(axis=0))
    T = sum(widths)
    LN = devlevel.level_new_bound(nc * D * T)
    reads = []
    for compress in (True, False):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if debug_sync else 0)
        try:
            st = sdev.queue_level(pending, lens, prev_base, B, nc, widths, LN, T, compress,
                                  sets.keys, sets.vn)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        reads.append(sdev.read_level(st))
    return reads


def test_sharded_device_level_queues_without_a_sync(card):
    """A sharded device level of Kip320 3r at D = 8 queued under
    set_sync_debug_mode("error"), compressed and raw: no host
    synchronisation between its chunks; each read gives level 13's new
    states and the digests of the same level queued on the CPU."""
    cpu = _queued_sharded_level(torch.device("cpu"), False)
    k1 = cuda_fingerprint.LAUNCHES
    gpu = _queued_sharded_level(card, True)
    assert cuda_fingerprint.LAUNCHES > k1
    for a, b in zip(cpu, gpu):
        assert not b.ovf and b.vkind == 0 and int(b.on.sum()) == 66_432
        for f in ("on", "act_en", "agmax", "sacc", "racc", "dig"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
