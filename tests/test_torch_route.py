"""PyTorch port: the launch route that every kernel wrapper takes
(``ops/build.py``), held on the CPU.

Nothing launches here.  A tensor subclass tells the wrappers it lies on a
card (``is_cuda``, ``get_device``) while its memory stays on the CPU, and a
fake bound function stands in for each C entry and records the arguments
that the wrapper hands it: the card's index is the tensor's, and the stream
is ``build.stream_handle``'s for that card.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kafka_specification_tpu_torch.ops import (
    build, cuda_fingerprint, cuda_hashset, cuda_ladder, hashset)

REPO = Path(__file__).resolve().parents[1]
ENTRIES = {
    "ladder": cuda_ladder.KSPEC_LADDER,
    "fingerprint": cuda_fingerprint.KSPEC_FINGERPRINT,
    "hashset": cuda_hashset.KSPEC_PROBE_INSERT,
}


class OnCard1(torch.Tensor):
    """A CPU tensor that the wrappers take for one on card 1."""

    card = 1

    @property
    def is_cuda(self):
        return True

    @property
    def is_cpu(self):
        return False

    def get_device(self):
        return self.card


class OnCard0(OnCard1):
    card = 0


def on_card(t, cls=OnCard1):
    return t.as_subclass(cls)


def fake_stream(index):
    return 0x5000 + index


@pytest.fixture
def recorded(monkeypatch):
    """{entry name: [args of each call]}, with every C entry faked to
    return 0 and the stream lookup faked per card."""
    calls = {name: [] for name in ENTRIES}
    for name, entry in ENTRIES.items():
        monkeypatch.setattr(entry, "call", lambda *a, _n=name: calls[_n].append(a) or 0)
    monkeypatch.setattr(build, "stream_handle", fake_stream)
    monkeypatch.setattr(cuda_hashset, "_CLAIMS", {})
    monkeypatch.setattr(cuda_hashset, "_SLOTS", {})
    return calls


# --- importing the port binds and loads nothing ------------------------

IMPORT_PROBE = textwrap.dedent(
    """
    import ctypes, importlib, json, pkgutil
    opened = []
    _init = ctypes.CDLL.__init__
    def _record(self, name, *a, **k):
        opened.append(str(name))
        _init(self, name, *a, **k)
    ctypes.CDLL.__init__ = _record
    import torch
    import kafka_specification_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    from kafka_specification_tpu_torch.ops import build, cuda_fingerprint, cuda_hashset, cuda_ladder
    entries = (cuda_ladder.KSPEC_LADDER, cuda_fingerprint.KSPEC_FINGERPRINT,
               cuda_hashset.KSPEC_PROBE_INSERT)
    print(json.dumps({
        "kspec_libraries_opened": [n for n in opened if "kspec" in n or "kernels" in n],
        "libraries_loaded": sorted(build._loaded),
        "entries_bound": [e.name for e in entries if e.bound()],
        "stream_binding": build._raw_stream is not None,
        "cuda_initialized": torch.cuda.is_initialized(),
    }))
    """
)


@pytest.fixture(scope="module")
def after_import():
    out = subprocess.run([sys.executable, "-c", IMPORT_PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("what, expected", [
    ("kspec_libraries_opened", []),
    ("libraries_loaded", []),
    ("entries_bound", []),
    ("stream_binding", False),
    ("cuda_initialized", False),
])
def test_importing_the_port_resolves_nothing(after_import, what, expected):
    assert after_import[what] == expected


# --- the arguments each wrapper hands its C entry ----------------------

def test_ladder_launches_on_the_tensors_card_with_its_stream(recorded):
    """The fault this pins: kspec_ladder took no device index and launched
    on whatever card was current, with the stream of the tensor's card."""
    x32 = on_card(torch.arange(10, dtype=torch.int32))
    before = cuda_ladder.LAUNCHES["dyn_slice"]
    out = cuda_ladder.launch("dyn_slice", x32)
    (args,) = recorded["ladder"]
    assert args == (cuda_ladder.RUNGS.index("dyn_slice"), x32.data_ptr(), out.data_ptr(),
                    10, 1, 1, fake_stream(1))
    assert cuda_ladder.LAUNCHES["dyn_slice"] == before + 1


def test_ladder_repeated_launches_pass_card_stream_and_reps(recorded):
    x32 = on_card(torch.arange(8, dtype=torch.int32), OnCard0)
    out = on_card(torch.empty(8, dtype=torch.int32), OnCard0)
    cuda_ladder.launch_repeated("vec", x32, out, 7)
    (args,) = recorded["ladder"]
    assert args == (0, x32.data_ptr(), out.data_ptr(), 8, 7, 0, fake_stream(0))


def test_fingerprint_launches_on_the_tensors_card_with_its_stream(recorded):
    lanes = on_card(torch.zeros((5, 3), dtype=torch.int64))
    valid = on_card(torch.ones(5, dtype=torch.bool))
    before = cuda_fingerprint.LAUNCHES
    hi, lo = cuda_fingerprint.fingerprint(lanes, valid)
    (args,) = recorded["fingerprint"]
    assert args == (lanes.data_ptr(), valid.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                    5, 3, 1, fake_stream(1))
    assert cuda_fingerprint.LAUNCHES == before + 1


def test_probe_insert_launches_on_the_tables_card_with_its_stream(recorded):
    table = on_card(hashset.new_table(16, torch.device("cpu")))
    q = on_card(torch.arange(4, dtype=torch.int64))
    before = cuda_hashset.LAUNCHES
    is_new, counts = cuda_hashset.launch(table, q)
    (args,) = recorded["hashset"]
    assert args[0] == table.data_ptr() and args[2] == 16 and args[3] == q.data_ptr()
    assert args[4] is None and args[5] == 4
    assert args[9] == is_new.data_ptr() and args[10] == counts.data_ptr()
    assert args[11:] == (1, fake_stream(1))
    assert cuda_hashset.LAUNCHES == before + 1


def test_a_cuda_error_code_raises(recorded, monkeypatch):
    class Lib:
        @staticmethod
        def kspec_error_string(rc):
            return b"an illegal memory access was encountered"

    monkeypatch.setattr(build, "library", lambda name: Lib)
    monkeypatch.setattr(cuda_ladder.KSPEC_LADDER, "call", lambda *a: 700)
    before = cuda_ladder.LAUNCHES["vec"]
    with pytest.raises(RuntimeError, match="ladder kernel launch .vec.: CUDA error 700"):
        cuda_ladder.launch("vec", on_card(torch.arange(4, dtype=torch.int32)))
    assert cuda_ladder.LAUNCHES["vec"] == before


def test_entry_binds_once_at_its_first_call(monkeypatch):
    seen = []

    class Fn:
        argtypes = restype = None

        def __call__(self, *a):
            seen.append(a)
            return 0

    fn = Fn()

    class Lib:
        kspec_thing = fn

    loads = []
    monkeypatch.setattr(build, "library", lambda name: loads.append(name) or Lib)
    entry = build.Entry("thing", "kspec_thing", [build.ctypes.c_int])
    assert not entry.bound() and loads == []
    assert entry.call(1) == 0 and entry.call(2) == 0
    assert entry.bound() and entry.call is fn and loads == ["thing"]
    assert fn.argtypes == [build.ctypes.c_int] and fn.restype is build.ctypes.c_int
    assert seen == [(1,), (2,)]


# --- every wrapper refuses what its kernel does not take ----------------

def _lanes(m=4, k=3, cls=OnCard1, dtype=torch.int64):
    return on_card(torch.zeros((m, k), dtype=dtype), cls)


def _valid(m=4, cls=OnCard1, dtype=torch.bool):
    return on_card(torch.ones(m, dtype=dtype), cls)


def _table(cap=16, cls=OnCard1):
    return on_card(hashset.new_table(cap, torch.device("cpu")), cls)


def _keys(m=4, cls=OnCard1, dtype=torch.int64):
    return on_card(torch.arange(m, dtype=dtype), cls)


def _x32(n=8, dtype=torch.int32):
    return on_card(torch.arange(n, dtype=dtype))


REFUSALS = {
    "ladder: cpu tensor": (
        lambda: cuda_ladder.launch("vec", torch.zeros(4, dtype=torch.int32)), "CUDA"),
    "ladder: int64": (lambda: cuda_ladder.launch("vec", _x32(dtype=torch.int64)), "int32"),
    "ladder: 2-d": (
        lambda: cuda_ladder.launch("vec", on_card(torch.zeros((2, 2), dtype=torch.int32))),
        r"int32\[n\]"),
    "ladder: empty": (lambda: cuda_ladder.launch("vec", _x32(0)), "1 <= n"),
    "ladder: unknown rung": (lambda: cuda_ladder.launch("dyn_write", _x32()), "unknown rung"),
    "ladder: repeated, non-contiguous": (
        lambda: cuda_ladder.launch_repeated("vec", _x32(16)[::2], _x32(8), 3), "contiguous"),
    "ladder: repeated, out on another card": (
        lambda: cuda_ladder.launch_repeated(
            "vec", _x32(), on_card(torch.empty(8, dtype=torch.int32), OnCard0), 3),
        "one device"),
    "ladder: repeated, out overlaps x": (
        lambda: (lambda x: cuda_ladder.launch_repeated("vec", x[:8], x[4:], 1))(_x32(12)),
        "overlap"),
    "K1: cpu tensor": (
        lambda: cuda_fingerprint.launch(torch.zeros((4, 3), dtype=torch.int64),
                                        torch.ones(4, dtype=torch.bool)), "CUDA"),
    "K1: int32 lanes": (
        lambda: cuda_fingerprint.launch(_lanes(dtype=torch.int32), _valid()), "int64"),
    "K1: non-contiguous lanes": (
        lambda: cuda_fingerprint.launch(_lanes(4, 6)[:, ::2], _valid()), "contiguous"),
    "K1: no lanes": (lambda: cuda_fingerprint.launch(_lanes(4, 0), _valid()), "lanes"),
    "K1: too many lanes": (
        lambda: cuda_fingerprint.launch(_lanes(4, cuda_fingerprint.MAX_LANES + 1), _valid()),
        "lanes"),
    "K1: valid not bool": (
        lambda: cuda_fingerprint.launch(_lanes(), _valid(dtype=torch.uint8)), "valid"),
    "K1: valid too short": (lambda: cuda_fingerprint.launch(_lanes(), _valid(3)), "valid"),
    "K1: valid on another card": (
        lambda: cuda_fingerprint.launch(_lanes(), _valid(cls=OnCard0)), "valid"),
    "K2: cpu tensor": (
        lambda: cuda_hashset.launch(hashset.new_table(16, torch.device("cpu")),
                                    torch.zeros(4, dtype=torch.int64)), "CUDA"),
    "K2: capacity not a power of two": (
        lambda: cuda_hashset.launch(on_card(torch.full((12,), -1, dtype=torch.int64)),
                                    _keys()), "power of two"),
    "K2: non-contiguous table": (
        lambda: cuda_hashset.launch(_table(32)[::2], _keys()), "contiguous"),
    "K2: int32 keys": (lambda: cuda_hashset.launch(_table(), _keys(dtype=torch.int32)), "keys"),
    "K2: keys on another card": (
        lambda: cuda_hashset.launch(_table(), _keys(cls=OnCard0)), "keys"),
    "K2: valid too short": (lambda: cuda_hashset.launch(_table(), _keys(), _valid(3)), "valid"),
    "K2: valid on another card": (
        lambda: cuda_hashset.launch(_table(), _keys(), _valid(cls=OnCard0)), "valid"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_its_kernel_does_not_take(recorded, case):
    call, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        call()
    assert not any(recorded.values())  # nothing reached a C entry


# --- a CPU tensor takes the plain version, whatever the size -----------

def numpy_rung(rung, x):
    """The rung's function on u32 values, written from the Pallas bodies'
    semantics alone: arithmetic mod 2^32, pos = min(x[0] % 7, n - 1)."""
    x = x.astype(np.uint64)
    pos = min(int(x[0]) % 7, x.shape[0] - 1)
    o = x.copy()
    if rung == "vec":
        o = x * 3 + 7
    elif rung == "loop_vec":
        o = x * 4
    elif rung == "static_scalar":
        o[0] = x[0] + 1
    elif rung == "dyn_read":
        o = x + x[pos]
    elif rung == "dyn_slice":
        o[pos] = x[pos] + 1
    else:
        o = x + 1
    return (o % 2**32).astype(np.int64)


# sizes around the 16-byte vectors: all tail, pos in the tail, pos in the
# last vector, and a tail after many vectors
SIZES = [(1, 0), (3, 2), (6, 5), (7, 6), (9, 6), (1027, 13)]


@pytest.mark.parametrize("n, x0", SIZES)
@pytest.mark.parametrize("rung", cuda_ladder.RUNGS)
def test_run_on_a_cpu_tensor_is_the_plain_version(monkeypatch, rung, n, x0):
    for entry in ENTRIES.values():
        monkeypatch.setattr(entry, "call", None)  # a call would raise
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32).astype(np.int64)
    x[0] = x0
    got = cuda_ladder.run(rung, torch.from_numpy(x))
    assert torch.equal(got, cuda_ladder.PLAIN[rung](torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(), numpy_rung(rung, x))
