"""TLA-style rendering of decoded states for counterexample traces.

The port's copy of ``kafka_specification_tpu/utils/pretty.py`` for the
models the port has: the Kafka replication family and AsyncIsr render as
named records, one variable per line, with the .cfg's replica model-value
names where it gave them (``meta["replica_names"]``, else b0..bN-1); a
product renders partition by partition; every other model (IdSequence,
FiniteReplicatedLog) as the repr of its decoded state.
"""

from __future__ import annotations

KAFKA_VARIANTS = ("KafkaTruncateToHighWatermark", "Kip101", "Kip279", "Kip320", "Kip320FirstTry")


def _namer(model_meta: dict):
    """replica index -> display name, honouring the .cfg's model values."""
    names = model_meta.get("replica_names")
    if names:
        return lambda r: names[r] if 0 <= r < len(names) else f"b{r}"
    return lambda r: f"b{r}"


def _set(s, nm):
    return "{" + ", ".join(nm(r) for r in sorted(s)) + "}"


def _opt(v, nm):
    return "None" if v == -1 else nm(v)


def render_kafka_state(state, nm=None) -> str:
    """Decoded KafkaReplication-family state -> TLA-like record text."""
    nm = nm or (lambda r: f"b{r}")
    logs, rstates, nrid, nep, reqs, (qep, qldr, qisr) = state
    log_txt = ", ".join(
        f"{nm(r)} :> <<" + ", ".join(f"[id|->{i}, epoch|->{e}]" for i, e in log) + ">>"
        for r, log in enumerate(logs)
    )
    rs_txt = ", ".join(
        f"{nm(r)} :> [hw|->{hw}, leaderEpoch|->{ep}, leader|->{_opt(ldr, nm)}, isr|->{_set(isr, nm)}]"
        for r, (hw, ep, ldr, isr) in enumerate(rstates)
    )
    req_txt = ", ".join(
        f"[leaderEpoch|->{e}, leader|->{_opt(l, nm)}, isr|->{_set(isr, nm)}]"
        for e, l, isr in sorted(reqs)
    )
    lines = [
        f"replicaLog = ({log_txt})",
        f"replicaState = ({rs_txt})",
        f"nextRecordId = {nrid}",
        f"nextLeaderEpoch = {nep}",
        f"leaderAndIsrRequests = {{{req_txt}}}",
        f"quorumState = [leaderEpoch|->{qep}, leader|->{_opt(qldr, nm)}, isr|->{_set(qisr, nm)}]",
    ]
    return "\n".join("  " + ln for ln in lines)


def render_async_isr_state(state, nm=None) -> str:
    """Decoded AsyncIsr state -> TLA-like record text (AsyncIsr.tla:31-56)."""
    nm = nm or (lambda r: f"b{r}")
    (c_isr, c_ver), (l_isr, l_ver, pend, pver, offs), reqs, upds = state

    def msgs(items):
        return ", ".join(f"[isr|->{_set(isr, nm)}, version|->{v}]"
                         for isr, v in sorted(items, key=str))

    lines = [
        f"controllerState = [isr|->{_set(c_isr, nm)}, version|->{c_ver}]",
        f"leaderState = [isr|->{_set(l_isr, nm)}, version|->{l_ver}, "
        f"pendingIsr|->{_set(pend, nm)}, pendingVersion|->{pver}, "
        f"offsets|->({', '.join(f'{nm(r)} :> {o}' for r, o in enumerate(offs))})]",
        "requests = {" + msgs(reqs) + "}",
        "updates = {" + msgs(upds) + "}",
    ]
    return "\n".join("  " + ln for ln in lines)


def render_state(model_meta: dict, state) -> str:
    """Dispatch on the model family; anything else renders as its repr.  A
    product (meta "partitions") renders each partition under a heading."""
    if "partitions" in model_meta:
        sub_meta = {k: v for k, v in model_meta.items() if k != "partitions"}
        return "\n".join(
            f"  partition {p}:\n" + render_state(sub_meta, sub) for p, sub in enumerate(state)
        )
    variant = model_meta.get("variant", "")
    if variant == "AsyncIsr":
        return render_async_isr_state(state, _namer(model_meta))
    if variant in KAFKA_VARIANTS:
        return render_kafka_state(state, _namer(model_meta))
    return "  " + repr(state)


def render_trace(model_meta: dict, trace) -> str:
    """Numbered TLC-style counterexample trace."""
    out = []
    for i, (action, state) in enumerate(trace):
        head = "Initial predicate" if action == "<init>" else f"Action {action}"
        out.append(f"State {i + 1}: <{head}>")
        out.append(render_state(model_meta, state))
    return "\n".join(out)
