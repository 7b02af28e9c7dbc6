"""PyTorch port: the encoding gate and the proven field hulls
(kafka_specification_tpu_torch/analysis/) against the JAX package's
analysis, with zero tolerance: on all nine configs the port's hull of every
field equals the JAX package's, lies inside the declared range and holds
every value a BFS of the config reaches; the seeded mutants (an update past
its range, a write outside the write set, a vacuous guard, a read of a
field no action writes, a kernel outside the domain) are found as the JAX
package finds them; check() and the .cfg build_model refuse an unsound model
and KSPEC_ANALYZE=0 overrides; the memo is keyed by structure, not name;
and the abstract values dispatch torch's functions without rebinding a
name anywhere."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_specification_tpu import analysis as janalysis
from kafka_specification_tpu.analysis import encoding as jencoding
from kafka_specification_tpu.engine import bfs as jbfs
from kafka_specification_tpu.models import base as jbase
from kafka_specification_tpu.ops import packing as jpacking
from kafka_specification_tpu.utils import cfg as jcfg
from kafka_specification_tpu_torch import analysis, build_model, check, load_config
from kafka_specification_tpu_torch.analysis import encoding, interval
from kafka_specification_tpu_torch.models import kip320
from kafka_specification_tpu_torch.models.base import Action, EncodingUnsound, Invariant, Model
from kafka_specification_tpu_torch.models.kafka_replication import Config
from kafka_specification_tpu_torch.ops.packing import Field, StateSpec
from kafka_specification_tpu_torch.utils import cfg as tcfg
from torch_guards import overlap_guard  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
# config -> (module, max_depth of the BFS whose values the hull must hold)
CONFIGS = {
    "AsyncIsr": ("AsyncIsr", None),
    "FiniteReplicatedLog": ("FiniteReplicatedLog", None),
    "IdSequence": ("IdSequence", None),
    "KafkaTruncateToHighWatermark": ("KafkaTruncateToHighWatermark", 6),
    "Kip101": ("Kip101", 6),
    "Kip279": ("Kip279", 6),
    "Kip320": ("Kip320", 6),
    "Kip320FirstTry": ("Kip320FirstTry", 6),
    "Kip320Stretch": ("Kip320", 3),
}


def models_of(name):
    module = CONFIGS[name][0]
    path = REPO / "configs" / f"{name}.cfg"
    return jcfg.build_model(module, jcfg.parse_cfg(path.read_text())), \
        build_model(module, load_config(str(path)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_hulls_equal_jax_and_hold_the_reached_values(name):
    jm, tm = models_of(name)
    hulls = analysis.field_hulls(tm, strict=True)
    assert hulls == janalysis.field_hulls(jm, strict=True)
    for f in tm.spec.fields:
        assert f.lo <= hulls[f.name][0] <= hulls[f.name][1] <= f.hi, (f.name, hulls[f.name])
    levels = []
    kw = {"max_depth": CONFIGS[name][1]} if CONFIGS[name][1] else {}
    check(tm, device="cpu", store_trace=False, check_invariants=False, collect_levels=levels, **kw)
    rows = torch.cat(levels)
    for fname, v in tm.spec.unpack(rows).items():
        lo, hi = hulls[fname]
        assert lo <= int(v.min()) and int(v.max()) <= hi, (fname, int(v.min()), int(v.max()))


def test_shipped_models_verify_clean_as_jax():
    """No HIGH finding on any config, the same finding kinds as JAX's."""
    for name in sorted(CONFIGS):
        jm, tm = models_of(name)
        got = sorted((f.kind, f.target) for f in encoding.verify_model_encoding(tm))
        want = sorted((f.kind, f.target) for f in jencoding.verify_model_encoding(jm))
        assert got == want, name


# --------------------------------------------------------------------------
# seeded mutants, written once as JAX kernels (state, choice) and once as
# the port's batched kernels (states[B]) -> [B, n]
# --------------------------------------------------------------------------


def _pair(name, port_actions, jax_actions):
    def tspec():
        return StateSpec([Field("x", (), 0, 3), Field("y", (2,), 0, 3)])

    def jspec():
        return jpacking.StateSpec([jpacking.Field("x", (), 0, 3), jpacking.Field("y", (2,), 0, 3)])

    inits = lambda: [{"x": 0, "y": [0, 0]}]  # noqa: E731
    tm = Model(name=name, spec=tspec(), init_states=inits, actions=port_actions,
               invariants=[Invariant("True", lambda s: s["x"] >= 0)])
    jm = jbase.Model(name=name, spec=jspec(), init_states=inits, actions=jax_actions,
                     invariants=[jbase.Invariant("True", lambda s: s["x"] >= 0)])
    return jm, tm


def _x(s):
    return s["x"].unsqueeze(1)


def _y(s):
    return s["y"].unsqueeze(1)


def overflow_pair(name="mutant-overflow"):
    """x <= 3 -> x + 1: the guard admits x = 3, the update leaves [0, 3]."""
    def t_kernel(s):
        return _x(s) <= 3, {"x": _x(s) + 1, "y": _y(s)}

    def j_kernel(s, c):
        return s["x"] <= 3, {**s, "x": s["x"] + 1}

    w = frozenset({"x"})
    return _pair(name, [Action("Bump", 1, t_kernel, writes=w)],
                 [jbase.Action("Bump", 1, j_kernel, writes=w)])


def frame_pair():
    def t_kernel(s):
        y = torch.where(torch.arange(2) == 0, 0, _y(s))
        return _x(s) <= 2, {"x": torch.minimum(_x(s) + 1, torch.tensor(3)), "y": y}

    def j_kernel(s, c):
        return s["x"] <= 2, {**s, "x": jnp.minimum(s["x"] + 1, 3), "y": s["y"].at[0].set(0)}

    w = frozenset({"x"})
    return _pair("mutant-frame", [Action("Sneaky", 1, t_kernel, writes=w)],
                 [jbase.Action("Sneaky", 1, j_kernel, writes=w)])


def vacuous_pair():
    def t_kernel(s):
        x = _x(s).expand(-1, 2)
        return (x > 3) & (x >= 0), {"x": x, "y": _y(s).expand(-1, 2, 2)}

    def j_kernel(s, c):
        return (s["x"] > 3) & (s["x"] >= 0), {**s, "x": s["x"]}

    return _pair("mutant-vacuous", [Action("Never", 2, t_kernel, writes=frozenset())],
                 [jbase.Action("Never", 2, j_kernel, writes=frozenset())])


def unwritten_pair():
    def t_kernel(s):
        y0 = s["y"][:, 0:1]
        return (y0 <= 3) & (_x(s) <= 2), {"x": torch.minimum(_x(s) + 1, torch.tensor(3)),
                                          "y": _y(s)}

    def j_kernel(s, c):
        return (s["y"][0] <= 3) & (s["x"] <= 2), {**s, "x": jnp.minimum(s["x"] + 1, 3)}

    w = frozenset({"x"})
    return _pair("mutant-unwritten", [Action("ReadsY", 1, t_kernel, writes=w)],
                 [jbase.Action("ReadsY", 1, j_kernel, writes=w)])


def opaque_pair(writes=None, name="mutant-opaque"):
    def t_kernel(s):
        raise RuntimeError("not abstractly executable")

    def j_kernel(s, c):
        raise RuntimeError("not abstractly executable")

    return _pair(name, [Action("Opaque", 1, t_kernel, writes=writes)],
                 [jbase.Action("Opaque", 1, j_kernel, writes=writes)])


def _kinds(findings):
    return sorted((f.kind, f.target, tuple(sorted(f.data.items())) if f.kind != "analysis-skip"
                   else None) for f in findings)


@pytest.mark.parametrize("make", [overflow_pair, frame_pair, vacuous_pair, unwritten_pair,
                                  opaque_pair, lambda: opaque_pair(frozenset({"x"}), "declared")])
def test_mutant_findings_equal_jax(make):
    """Each seeded mutant gives the JAX package's findings: kind, target and
    the machine-readable data (the interval counterexample, the extra
    writes), the skip's reason text aside."""
    jm, tm = make()
    assert _kinds(encoding.analyze_model(tm)) == _kinds(jencoding.analyze_model(jm))


def test_overflow_counterexample():
    _, tm = overflow_pair()
    f = [f for f in encoding.analyze_model(tm) if f.kind == "encoding-overflow"][0]
    assert f.data["field"] == "x" and f.data["declared"] == [0, 3]
    assert f.data["interval"] == [1, 4] and f.data["action"] == "Bump"


def test_check_refuses_unsound_model_and_env_overrides(monkeypatch):
    """check() refuses the unsound mutants before exploring, as the JAX
    engine does; KSPEC_ANALYZE=0 overrides both."""
    for make in (overflow_pair, frame_pair):
        jm, tm = make()
        with pytest.raises(jencoding.EncodingUnsound) as je:
            jbfs.check(jm, max_depth=1, min_bucket=32)
        with pytest.raises(EncodingUnsound) as te:
            check(tm, device="cpu", max_depth=1, min_bucket=32)
        assert [(f.kind, f.data) for f in te.value.findings] == \
            [(f.kind, f.data) for f in je.value.findings]
        assert str(te.value) == str(je.value)
    monkeypatch.setenv("KSPEC_ANALYZE", "0")
    jm, tm = overflow_pair("mutant-overridden")
    res = check(tm, device="cpu", max_depth=1, min_bucket=32)
    assert res.total == jbfs.check(jm, max_depth=1, min_bucket=32).total >= 1


def test_build_model_gates_the_model(monkeypatch):
    """utils/cfg.py::build_model runs the gate on what it built, unless
    KSPEC_ANALYZE=0."""
    seen = []
    monkeypatch.setattr(analysis, "_VERIFIED_MODELS", set())
    monkeypatch.setattr(encoding, "verify_model_encoding", lambda m: seen.append(m.name))
    cfg = load_config(str(REPO / "configs" / "IdSequence.cfg"))
    monkeypatch.setenv("KSPEC_ANALYZE", "0")
    tcfg.build_model("IdSequence", cfg)
    assert seen == []
    monkeypatch.delenv("KSPEC_ANALYZE")
    m = tcfg.build_model("IdSequence", cfg)
    assert seen == [m.name]


def test_build_model_refuses_an_unsound_module(monkeypatch):
    """A module whose kernel writes past its range is refused by the
    build_model (and so by `cli check`, exit 2) with the JAX package's text."""
    from kafka_specification_tpu_torch import cli
    from kafka_specification_tpu_torch.models import id_sequence

    real = id_sequence.make_model

    def bad_make(max_id):
        m = real(max_id)
        a = m.actions[0]

        def kernel(s):
            en, nxt = a.kernel(s)
            return en, {**nxt, "nextId": s["nextId"].unsqueeze(1) + 2}

        m.actions = [Action(a.name, a.n_choices, kernel, writes=a.writes)]
        return m

    monkeypatch.setattr(id_sequence, "make_model", bad_make)
    cfg = load_config(str(REPO / "configs" / "IdSequence.cfg"))
    with pytest.raises(EncodingUnsound, match="encoding-unsound.*'nextId'"):
        tcfg.build_model("IdSequence", cfg)
    assert cli.main(["check", str(REPO / "configs" / "IdSequence.cfg"), "--cpu"]) == 2


def test_memo_keyed_by_structure():
    m = kip320.make_model(Config(2, 2, 1, 1))
    analysis.require_encoding_sound(m)
    assert analysis._model_memo_key(m) in analysis._VERIFIED_MODELS
    import dataclasses

    m2 = dataclasses.replace(kip320.make_model(Config(2, 3, 1, 1)), name=m.name)
    assert analysis._model_memo_key(m2) not in analysis._VERIFIED_MODELS
    # the same kernel code over another base (a product lifts either) differs
    from kafka_specification_tpu_torch.models.product import product_model

    _, sound = overflow_pair("p")
    sound.actions = [Action("Bump", 1, lambda s: (_x(s) <= 2, {"x": _x(s) + 1, "y": _y(s)}),
                            writes=frozenset({"x"}))]
    _, bad = overflow_pair("p")
    pa, pb = product_model(sound, 2), product_model(bad, 2)
    assert pa.name == pb.name
    analysis.require_encoding_sound(pa)
    with pytest.raises(EncodingUnsound):
        analysis.require_encoding_sound(pb)


def test_strict_hulls_refuse_opaque_kernels():
    jm, tm = opaque_pair(frozenset({"x"}), "opaque-hulls")
    with pytest.raises(interval.AnalysisUnsupported):
        analysis.field_hulls(tm, strict=True)
    assert analysis.field_hulls(tm) == janalysis.field_hulls(jm) == {"x": (0, 3), "y": (0, 0)}


def test_where_truthiness_and_abstract_gather():
    out = torch.where(interval.IVal(-5, -1), 100, 0)
    assert (out.lo.item(), out.hi.item()) == (100, 100)
    assert interval.IVal(-2, -1).all().lo.item() == 1
    assert interval.definitely_disabled(interval.IVal(0, 0))
    assert not interval.definitely_disabled(interval.IVal(-2, -1))
    x = interval.IVal(np.array([[1, 5, 9]], dtype=object), np.array([[2, 6, 10]], dtype=object))
    g = x.gather(1, interval.IVal(np.array([[0, 1]], dtype=object),
                                  np.array([[1, 7]], dtype=object)))
    assert g.lo.tolist() == [[1, 5]] and g.hi.tolist() == [[6, 10]]


def test_analysis_rebinds_nothing():
    """The abstract run leaves torch and the model modules as they were,
    and a model's kernels still run on tensors right after it."""
    from kafka_specification_tpu_torch.models import kafka_replication

    before = (torch.where, torch.minimum, kafka_replication.torch)
    m = kip320.make_model(Config(2, 2, 2, 2))
    analysis.field_hulls(m, strict=True)
    assert (torch.where, torch.minimum, kafka_replication.torch) == before
    assert check(m, device="cpu", max_depth=3).levels == [1, 4, 12, 32]
