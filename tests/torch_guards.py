"""The overlap layer's leak guard for the PyTorch port's tests that run
check(): imported into a test module, ``overlap_guard`` is an autouse
fixture that fails the test if, after it,

- a worker thread of the port's overlap layer (``kspec-io``,
  ``kspec-ckpt``) is still alive (the JAX engine's own workers, which it
  leaves running after an injected crash, are not the port's);
- ``KSPEC_OVERLAP`` or ``KSPEC_TSAN`` is not as the test found it (a
  test's own monkeypatch.setenv is undone first: it is not a leak);
- a class is left armed by the KSPEC_TSAN sanitizer (``disarm_all``
  then disarms it, so the next test starts clean)."""

import os

import pytest

from kafka_specification_tpu_torch.analysis import ownership

GUARDED_ENV = ("KSPEC_OVERLAP", "KSPEC_TSAN")


@pytest.fixture(autouse=True)
def overlap_guard(monkeypatch):
    env = {k: os.environ.get(k) for k in GUARDED_ENV}
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
