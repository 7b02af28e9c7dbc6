"""TLC .cfg parsing and model instantiation for the PyTorch port.

The parser is a copy of ``kafka_specification_tpu/utils/cfg.py::parse_cfg``
(the port imports nothing from the JAX package).  ``build_model`` and
``resolved_invariants`` are copies of that module's, for the hand-written
models and their oracle twins (``build_model(..., oracle=True)``):
IdSequence, FiniteReplicatedLog, the five Kafka modules (with the authored
constant ``Partitions = K`` building the K-partition product,
``models/product.py``) and AsyncIsr; every other module raises.

Supported .cfg subset:
  CONSTANT / CONSTANTS   name = value   (ints, model-value sets {a, b, c})
  INVARIANT / INVARIANTS name...
  CONSTRAINT name                        (AsyncIsr only: its bound is the
                                          MaxOffset/MaxVersion constants)
  SPECIFICATION / INIT / NEXT            (parsed, informational)
  CHECK_DEADLOCK TRUE|FALSE
  \\* and (* ... *) comments
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class TlcConfig:
    constants: dict = field(default_factory=dict)  # name -> int | list[str]
    invariants: list = field(default_factory=list)
    constraints: list = field(default_factory=list)
    specification: str | None = None
    check_deadlock: bool = False


_SECTIONS = {
    "CONSTANT": "constants",
    "CONSTANTS": "constants",
    "INVARIANT": "invariants",
    "INVARIANTS": "invariants",
    "CONSTRAINT": "constraints",
    "CONSTRAINTS": "constraints",
    "SPECIFICATION": "specification",
    "INIT": "init",
    "NEXT": "next",
    "CHECK_DEADLOCK": "check_deadlock",
    "SYMMETRY": "symmetry",
}


def _strip_comments(text: str) -> str:
    text = re.sub(r"\(\*.*?\*\)", " ", text, flags=re.S)
    return "\n".join(line.split("\\*")[0] for line in text.splitlines())


def parse_cfg(path_or_text) -> TlcConfig:
    if isinstance(path_or_text, Path):
        text = path_or_text.read_text()
    elif "\n" not in str(path_or_text) and Path(str(path_or_text)).exists():
        text = Path(str(path_or_text)).read_text()
    else:
        text = str(path_or_text)
    cfg = TlcConfig()
    section = None
    for raw in _strip_comments(text).splitlines():
        line = raw.strip()
        if not line:
            continue
        head = line.split()[0].upper()
        if head in _SECTIONS:
            section = _SECTIONS[head]
            rest = line[len(line.split()[0]) :].strip()
            if not rest:
                continue
            line = rest
        if section == "constants":
            m = re.match(r"(\w+)\s*(?:=|<-)\s*(.+)", line)
            if not m:
                raise ValueError(f"cannot parse constant assignment: {line!r}")
            name, val = m.group(1), m.group(2).strip()
            if val.startswith("{"):
                cfg.constants[name] = [
                    v.strip() for v in val.strip("{} ").split(",") if v.strip()
                ]
            elif re.fullmatch(r"-?\d+", val):
                cfg.constants[name] = int(val)
            else:
                cfg.constants[name] = val  # model value (e.g. Leader = r1)
        elif section == "invariants":
            cfg.invariants.extend(line.split())
        elif section == "constraints":
            cfg.constraints.extend(line.split())
        elif section == "specification":
            cfg.specification = line.split()[0]
        elif section == "check_deadlock":
            cfg.check_deadlock = line.strip().upper() == "TRUE"
        # INIT/NEXT/SYMMETRY: parsed and ignored (the corpus uses SPECIFICATION)
    return cfg


SMALL_MODULES = ("IdSequence", "FiniteReplicatedLog")
KAFKA_VARIANTS = ("KafkaTruncateToHighWatermark", "Kip101", "Kip279")
KIP320_MODULES = ("Kip320", "Kip320FirstTry")
MODULES = SMALL_MODULES + KAFKA_VARIANTS + KIP320_MODULES + ("AsyncIsr",)


def _setlen(v) -> int:
    return len(v) if isinstance(v, list) else int(v)


def resolved_invariants(module: str, cfg: TlcConfig) -> tuple:
    """The invariant names, in order, that the model ``build_model`` makes
    for this module and .cfg checks: the .cfg's, else the module's default;
    the small models check their built-in TypeOk whatever the .cfg says."""
    if module in SMALL_MODULES:
        return ("TypeOk",)
    if module in KAFKA_VARIANTS + KIP320_MODULES:
        return tuple(cfg.invariants) or ("TypeOk",)
    if module == "AsyncIsr":
        return tuple(cfg.invariants) or ("TypeOk", "ValidHighWatermark")
    raise KeyError(f"unknown module {module!r}")


def _with_names(model, constants):
    """Record the .cfg's replica model-value names (`Replicas = {b1, b2,
    b3}`) in the model's meta, so traces render with the config's own
    vocabulary (utils/pretty.py)."""
    names = constants.get("Replicas")
    if isinstance(names, list):
        model.meta.setdefault("replica_names", list(names))
    return model


def build_model(module: str, cfg: TlcConfig, oracle: bool = False, analysis_gate: bool = True):
    """The tensor model for a TLA+ module name under a parsed config, with
    the invariants of ``resolved_invariants``; with ``oracle=True`` its
    set-semantics twin instead (``oracle/``: the same invariants, the
    .cfg's replica names, and for ``Partitions = K > 1`` the
    ``product_oracle`` of K copies).  CONSTRAINT is accepted for AsyncIsr
    only, whose bound the MaxOffset/MaxVersion constants already are
    (MaxVersion defaults to MaxOffset); a Kafka module's ``Partitions = K
    > 1`` builds the product of K copies of it.

    The built tensor model passes the encoding gate (``analysis.
    require_encoding_sound``; KSPEC_ANALYZE=0 disables) before it is
    returned, as the JAX package's build_model does: an unsound (config,
    schema) pair raises ``EncodingUnsound`` and ``cli check`` exits 2.
    Oracle twins carry no tensor schema and skip the gate (AsyncIsr's
    shares its N <= 4 cliff check directly); ``analysis_gate=False`` skips
    it too, for ``cli analyze``, which wants every finding and not the
    first HIGH one."""
    built = _build_model(module, cfg, oracle)
    if analysis_gate and not oracle:
        from ..analysis import require_encoding_sound

        require_encoding_sound(built)
    return built


def _build_model(module: str, cfg: TlcConfig, oracle: bool = False):
    if module not in MODULES:
        raise KeyError(f"unknown module {module!r}")
    if cfg.constraints and module != "AsyncIsr":
        raise ValueError(
            f"CONSTRAINT {cfg.constraints} is not supported for module "
            f"{module!r} (only AsyncIsr's bound is defined in this corpus)"
        )
    c = cfg.constants
    if module == "IdSequence":
        from ..models import id_sequence as m

        return (m.make_oracle if oracle else m.make_model)(int(c["MaxId"]))
    if module == "FiniteReplicatedLog":
        from ..models import finite_replicated_log as m

        return (m.make_oracle if oracle else m.make_model)(
            _setlen(c["Replicas"]), int(c["LogSize"]), _setlen(c["LogRecords"])
        )
    invs = resolved_invariants(module, cfg)
    if module == "AsyncIsr":
        from ..models import async_isr as m

        acfg = m.AsyncIsrConfig(
            n_replicas=_setlen(c["Replicas"]),
            max_offset=int(c["MaxOffset"]),
            max_version=int(c.get("MaxVersion", c["MaxOffset"])),
        )
        return _with_names((m.make_oracle if oracle else m.make_model)(acfg, invs), c)
    from ..models.kafka_replication import Config

    kcfg = Config(
        n_replicas=_setlen(c["Replicas"]),
        log_size=int(c["LogSize"]),
        max_records=int(c["MaxRecords"]),
        max_leader_epoch=int(c["MaxLeaderEpoch"]),
    )
    if module in KAFKA_VARIANTS:
        from ..models import variants as m

        built = (m.make_oracle if oracle else m.make_model)(module, kcfg, invs)
    else:
        from ..models import kip320 as m

        if module == "Kip320":
            make = m.make_oracle if oracle else m.make_model
        else:
            make = m.make_first_try_oracle if oracle else m.make_first_try_model
        built = make(kcfg, invs)
    built = _with_names(built, c)
    k = _setlen(c.get("Partitions", 1))
    if k > 1:
        from ..models.product import product_model, product_oracle

        built = (product_oracle if oracle else product_model)(built, k)
    return built
