"""The overlap layer's leak guard for the PyTorch port's tests that run
check(): imported into a test module, ``overlap_guard`` is an autouse
fixture that fails the test if, after it,

- a worker thread of the port's overlap layer (``kspec-io``,
  ``kspec-ckpt``) is still alive (the JAX engine's own workers, which it
  leaves running after an injected crash, are not the port's);
- ``KSPEC_OVERLAP`` or ``KSPEC_TSAN`` is not as the test found it (a
  test's own monkeypatch.setenv is undone first: it is not a leak);
- a class is left armed by the KSPEC_TSAN sanitizer (``disarm_all``
  then disarms it, so the next test starts clean).

The fixture also runs each test with at most the worker's share of the
box's cores as intra-op torch threads (one under the suite's six workers
on eight cores, two in a lone process: more cost more than they give on
the tests' small tensors; ``torch_threads`` does the same for a module
fixture), and with OMP_NUM_THREADS=1 for the processes the test starts.
torch's default, a thread a core in every worker, oversubscribes the
cores: the workers' spinning threads then slow the CPU checks many times
over.  No result depends on the thread count."""

import contextlib
import os

import pytest
import torch

from kafka_specification_tpu_torch.analysis import ownership

GUARDED_ENV = ("KSPEC_OVERLAP", "KSPEC_TSAN")
# pytest-xdist's worker count, in a worker process
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
TORCH_THREADS = max(1, min(2, (os.cpu_count() or 1) // WORKERS))


@contextlib.contextmanager
def torch_threads():
    """TORCH_THREADS intra-op torch threads inside, the count found after."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def overlap_guard(monkeypatch):
    env = {k: os.environ.get(k) for k in GUARDED_ENV}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with torch_threads():
        yield
    monkeypatch.undo()
    threads = ownership.live_worker_threads()
    changed = {k: os.environ.get(k) for k in GUARDED_ENV if os.environ.get(k) != env[k]}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    armed = ownership.armed()
    ownership.disarm_all()
    assert not threads, f"overlap worker threads outlived the test: {threads}"
    assert not changed, f"left set: {changed}"
    assert not armed, f"left armed by KSPEC_TSAN: {armed}"
