"""Random simulation mode (TLC's ``-simulate``), in PyTorch.

Counterpart of ``kafka_specification_tpu/engine/simulate.py``: random walks
from the initial states, the invariants checked at every state of a walk,
the violating walk reported as the counterexample trace.  It draws from
``np.random.default_rng(seed)`` in the JAX package's order, so the two
packages walk the same walks step for step:

  1. per walk, the index of its init state;
  2. per step, the invariants of the current state (the first that fails,
     in model order, ends the run), then one draw
     ``idxs[rng.integers(idxs.size)]`` over the enabled cells after the
     constraint, concatenated in action order, choices in order within an
     action; no enabled cell ends the walk (a deadlock);
  3. a walk that reaches ``max_depth`` has its last state checked too.

A step feeds the one current state through the batched action kernels as
a batch of one (B = 1), on the card unless the caller asks for the CPU.
A walk is sequential by nature (each draw depends on the walk so far), so
the host reads two small arrays per step: the enabled mask with the
invariant verdicts, and the packed successor it decodes for the trace.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.base import Model
from .bfs import CheckResult, Violation, resolve_device
from .pipeline import expand_stage


def _step(model: Model, state):
    """(state dict of int64[1, ...]) -> (invariant verdicts bool[I] + the
    enabled cells after the constraint bool[C], as one host array;
    per-action successor dicts)."""
    oks = [inv.pred(state).all().reshape(1) for inv in model.invariants]
    _, parts = expand_stage(model, state)
    flags = torch.cat(oks + [en[0] for en, _ in parts])
    return flags.cpu().numpy(), [nxt for _, nxt in parts]


def simulate(
    model: Model,
    num_walks: int = 100,
    max_depth: int = 100,
    seed: int = 0,
    progress=None,
    device=None,
) -> CheckResult:
    """Random-walk checking.  Returns a CheckResult whose `total` counts the
    states visited (not necessarily distinct), with levels [] and diameter
    0; `violation` carries the whole violating walk as its trace.

    device: None is the card ("cuda"), which raises when CUDA is absent;
    "cpu" runs the plain kernels on the CPU."""
    dev = resolve_device(device)
    spec = model.spec
    rng = np.random.default_rng(seed)
    n_inv = len(model.invariants)
    act_of = np.concatenate([np.full(a.n_choices, i) for i, a in enumerate(model.actions)])
    col_of = np.concatenate([np.arange(a.n_choices) for a in model.actions])

    def decode(row):
        s = {k: v.numpy() for k, v in spec.unpack(row.cpu()).items()}
        return model.decode(s) if model.decode else s

    def first_bad(inv_ok):
        return model.invariants[int(np.argmax(~inv_ok))].name

    t0 = time.perf_counter()
    visited = 0
    violation: Optional[Violation] = None
    inits = model.init_states()

    for walk in range(num_walks):
        init = inits[rng.integers(len(inits))]
        state = {k: torch.as_tensor(np.asarray(v, np.int64), device=dev).unsqueeze(0)
                 for k, v in init.items()}
        trace = [("<init>", decode(spec.pack(state)[0]))]
        for d in range(max_depth):
            flags, nxts = _step(model, state)
            visited += 1
            inv_ok, en = flags[:n_inv], flags[n_inv:]
            if not inv_ok.all():
                violation = Violation(first_bad(inv_ok), d, trace[-1][1], trace)
                break
            idxs = np.nonzero(en)[0]
            if idxs.size == 0:
                break  # deadlock: the walk ends (as in TLC's simulation)
            pick = int(idxs[rng.integers(idxs.size)])
            a, c = int(act_of[pick]), int(col_of[pick])
            state = {k: v[:, c] for k, v in nxts[a].items()}
            trace.append((model.actions[a].name, decode(spec.pack(state)[0])))
        else:
            # depth limit: the last transition's target has not been
            # checked yet (a violation or deadlock exit checked its state)
            if n_inv:
                inv_ok = np.array([bool(inv.pred(state).all()) for inv in model.invariants])
                visited += 1
                if not inv_ok.all():
                    violation = Violation(first_bad(inv_ok), max_depth, trace[-1][1], trace)
        if violation is not None:
            break
        if progress:
            progress(walk + 1, visited)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return CheckResult(
        model=model.name,
        levels=[],
        total=visited,
        diameter=0,
        violation=violation,
        seconds=dt,
        states_per_sec=visited / max(dt, 1e-9),
        stats={"mode": "simulate", "walks": num_walks, "max_depth": max_depth, "seed": seed,
               "device": str(dev)},
    )
