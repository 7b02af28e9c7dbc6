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
from kafka_specification_tpu_torch.ops import cuda_fingerprint, cuda_hashset, cuda_ladder, hashset
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
