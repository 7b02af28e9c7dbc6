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
from kafka_specification_tpu_torch.ops.dedup import pair_key

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
