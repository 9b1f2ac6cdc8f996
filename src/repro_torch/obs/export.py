"""Flight-recorder exporters: JSONL (the ``python -m repro_torch.obs`` CLI
input), Chrome-trace/Perfetto JSON, and Prometheus text exposition.

All three operate on a :class:`~repro_torch.sim.metrics.RunResult` that
carries a telemetry recorder (``telemetry=True`` on the engine call);
request-lifecycle anchors (queued/first-token/finish) are joined from
the run's request ledger against the recorder's sampled span rows, so
the simulation hot path never writes them twice.

The port's copy of the reference's ``obs/export.py``: one run's recorder
gives the same rows, the same Perfetto document and the same Prometheus
text in both packages, all but the ``generated_unix`` stamp of the JSONL
header.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.recorder import (KIND_NAMES, REASON_NAMES, SPAN_NAMES,
                                FlightRecorder)


def _require(result) -> FlightRecorder:
    rec = getattr(result, "telemetry", None)
    if rec is None:
        raise ValueError("run carries no telemetry — pass telemetry=True "
                         "(or CHIRON_TELEMETRY=1) to the engine")
    return rec


def _meta(result, rec: FlightRecorder) -> Dict:
    import time
    return {
        "kind": "meta",
        "clusters": list(rec.cluster_names),
        "models": list(rec.model_names),
        "itypes": list(rec.itype_names),
        "duration": result.duration,
        "scale_ups": result.scale_ups,
        "scale_downs": result.scale_downs,
        "failures": result.failures,
        "degradations": result.degradations,
        "span_sample": rec.span_sample,
        "span_seed": rec.span_seed,
        # overload-plane currency: goodput + terminal outcome rates ride
        # in the header so dashboards need no second pass over the rows
        "goodput": result.goodput(),
        **result.outcome_rates(),
        # repro-lint: ok(DET202, export stamp only - never read back into simulation state)
        "generated_unix": time.time(),
    }


def _name(vocab: List[str], code: int) -> Optional[str]:
    return vocab[code] if 0 <= code < len(vocab) else None


def sampled_requests(result, rec: FlightRecorder) -> List[Dict]:
    """One lifecycle record per sampled request row: ledger anchors
    (arrival, first token, finish) plus the recorded admit/preempt
    transitions in time order."""
    led = result.ledger
    spans = rec.spans
    if led is None or not spans.n:
        return []
    rows = np.unique(spans.col("row"))
    t_col = spans.col("t")
    r_col = spans.col("row")
    e_col = spans.col("event")
    i_col = spans.col("instance")
    out = []
    for row in rows:
        if row < 0 or row >= led.n:
            continue
        sel = np.flatnonzero(r_col == row)
        ftt = float(led.first_token_time[row])
        fin = float(led.finish_time[row])
        out.append({
            "kind": "request",
            "row": int(row),
            "model": _name(list(led.models), int(led.model_idx[row])),
            "interactive": bool(led.interactive[row]),
            "arrival": float(led.arrival[row]),
            "first_token": None if np.isnan(ftt) else ftt,
            "finish": None if np.isnan(fin) else fin,
            "state": int(led.state[row]),
            "transitions": [
                {"t": float(t_col[j]), "event": SPAN_NAMES[int(e_col[j])],
                 "instance": int(i_col[j])} for j in sel],
        })
    return out


def to_jsonl(result, path) -> int:
    """Write the full telemetry of a run as JSON lines (one meta header,
    then timeline/signal/cluster/decision/request rows). Returns the
    number of lines written."""
    rec = _require(result)
    n = 0
    with open(path, "w") as fh:
        def emit(obj):
            nonlocal n
            fh.write(json.dumps(obj) + "\n")
            n += 1

        emit(_meta(result, rec))
        tl = result.timeline
        if hasattr(tl, "col"):
            models = tl.queue_models()
            for i in range(len(tl)):
                row = {"kind": "timeline"}
                for name in ("t", "n_interactive", "n_mixed", "n_batch",
                             "chips", "q_interactive", "q_batch",
                             "tokens_per_s"):
                    row[name] = tl.col(name)[i].item()
                row["q_by_model"] = {
                    m: [int(tl.q_interactive_for(m)[i]),
                        int(tl.q_batch_for(m)[i])] for m in models}
                emit(row)
        for row in rec.signals.rows():
            row["kind"] = "signal"
            row["cluster"] = _name(rec.cluster_names, row["cluster"])
            row["model"] = _name(rec.model_names, row["model"])
            emit(row)
        for row in rec.cticks.rows():
            row["kind"] = "cluster"
            row["cluster"] = _name(rec.cluster_names, row["cluster"])
            emit(row)
        for row in rec.decisions.rows():
            row["action"] = KIND_NAMES[row.pop("kind")]
            row["kind"] = "decision"
            row["reason"] = REASON_NAMES[row["reason"]]
            row["cluster"] = _name(rec.cluster_names, row["cluster"])
            row["model"] = _name(rec.model_names, row["model"])
            row["itype"] = _name(rec.itype_names, row["itype"])
            row["peer"] = _name(rec.cluster_names, row["peer"])
            emit(row)
        for row in sampled_requests(result, rec):
            emit(row)
    return n


def to_perfetto(result, path=None) -> Dict:
    """Chrome-trace/Perfetto JSON: counter tracks for queue depth and
    chips (``ph: "C"``) plus complete-event spans (``ph: "X"``) for every
    sampled request — queued, then prefill/decode split at the first
    token when known, with preempt gaps honoured. Times are microseconds
    of simulated time. Writes to ``path`` when given; returns the
    document either way."""
    rec = _require(result)
    us = 1e6
    events = [{"name": "process_name", "ph": "M", "pid": 0,
               "args": {"name": "control-plane"}}]
    tl = result.timeline
    if hasattr(tl, "col"):
        ts = tl.col("t")
        qi = tl.col("q_interactive")
        qb = tl.col("q_batch")
        chips = tl.col("chips")
        for i in range(len(tl)):
            t = float(ts[i]) * us
            events.append({"name": "queue_depth", "ph": "C", "pid": 0,
                           "ts": t, "args": {"interactive": int(qi[i]),
                                             "batch": int(qb[i])}})
            events.append({"name": "chips", "ph": "C", "pid": 0,
                           "ts": t, "args": {"used": int(chips[i])}})
    for req in sampled_requests(result, rec):
        pid = 1
        tid = req["row"]
        end = req["finish"]
        if end is None:
            end = result.duration
        trans = req["transitions"]
        admits = [tr for tr in trans if tr["event"] == "admit"]
        first_admit = admits[0]["t"] if admits else end
        events.append({"name": "queued", "ph": "X", "pid": pid,
                       "tid": tid, "ts": req["arrival"] * us,
                       "dur": max(first_admit - req["arrival"], 0.0) * us,
                       "args": {"model": req["model"]}})
        for k, tr in enumerate(admits):
            nxt = end
            for tr2 in trans:
                if tr2["event"] == "preempt" and tr2["t"] >= tr["t"]:
                    nxt = min(nxt, tr2["t"])
                    break
            ftt = req["first_token"]
            if ftt is not None and tr["t"] <= ftt <= nxt:
                events.append({"name": "prefill", "ph": "X", "pid": pid,
                               "tid": tid, "ts": tr["t"] * us,
                               "dur": max(ftt - tr["t"], 0.0) * us,
                               "args": {"instance": tr["instance"]}})
                events.append({"name": "decode", "ph": "X", "pid": pid,
                               "tid": tid, "ts": ftt * us,
                               "dur": max(nxt - ftt, 0.0) * us,
                               "args": {"instance": tr["instance"]}})
            else:
                events.append({"name": "exec", "ph": "X", "pid": pid,
                               "tid": tid, "ts": tr["t"] * us,
                               "dur": max(nxt - tr["t"], 0.0) * us,
                               "args": {"instance": tr["instance"]}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc


def to_prometheus(result, path=None) -> str:
    """Prometheus text exposition of the run's terminal state: scale
    action counters by kind, final queue depths/chips per cluster, SLO
    attainment gauges. Writes to ``path`` when given; returns the text
    either way."""
    rec = _require(result)
    lines = []

    def metric(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lab = "{" + ",".join(f'{k}="{v}"'
                                 for k, v in labels.items()) + "}" \
                if labels else ""
            lines.append(f"{name}{lab} {value}")

    rep = rec.replay()
    metric("chiron_scale_actions_total", "counter",
           "Control-plane actions by kind over the run",
           [({"action": k}, v) for k, v in rep.items()])
    metric("chiron_slo_attainment", "gauge",
           "Fraction of requests meeting their SLO",
           [({}, result.slo_attainment())])
    metric("chiron_completion_rate", "gauge",
           "Fraction of requests finished",
           [({}, result.completion_rate())])
    metric("chiron_goodput", "gauge",
           "SLO-met completions per second of simulated time",
           [({}, result.goodput())])
    rates = result.outcome_rates()
    metric("chiron_overload_outcome_rate", "gauge",
           "Fraction of submitted requests per overload terminal state",
           [({"outcome": "rejected"}, rates["reject_rate"]),
            ({"outcome": "shed"}, rates["shed_rate"]),
            ({"outcome": "expired"}, rates["expired_rate"])])
    metric("chiron_chip_seconds_total", "counter",
           "Chip-seconds consumed over the run",
           [({}, result.chip_seconds)])
    metric("chiron_peak_chips", "gauge", "Peak chips in use",
           [({}, result.peak_chips)])
    ct = rec.cticks
    if ct.n:
        t_col = ct.col("t")
        c_col = ct.col("cluster")
        final = []
        chips_f = []
        for code, name in enumerate(rec.cluster_names):
            sel = np.flatnonzero(c_col == code)
            if not sel.size:
                continue
            i = int(sel[np.argmax(t_col[sel])])
            final.append(({"cluster": name, "class": "interactive"},
                          int(ct.col("q_interactive")[i])))
            final.append(({"cluster": name, "class": "batch"},
                          int(ct.col("q_batch")[i])))
            chips_f.append(({"cluster": name}, int(ct.col("chips")[i])))
        metric("chiron_queue_depth", "gauge",
               "Queue depth at the final control tick", final)
        metric("chiron_chips_in_use", "gauge",
               "Chips in use at the final control tick", chips_f)
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text
