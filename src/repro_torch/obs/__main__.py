"""Terminal dashboards over a flight-recorder JSONL export.

Usage::

    python -m repro_torch.obs run.jsonl                 # all models
    python -m repro_torch.obs run.jsonl --model llama-8b
    python -m repro_torch.obs run.jsonl --waterfalls 12 --width 100

Renders, per model, the control-plane time series (queue depth vs.
chips vs. IBP/BBP backpressure as unicode sparklines over the run), the
decision ledger (one line per scale action with the term that fired),
and per-request lifecycle waterfalls for the sampled spans
(``.`` queued, ``=`` prefill, ``#`` decode, ``x`` preempted).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

_BLOCKS = " ▁▂▃▄▅▆▇█"


def _spark(values: List[float], width: int) -> str:
    """Downsample ``values`` to ``width`` buckets (max-pooled) and render
    as a block-character sparkline."""
    if not values:
        return ""
    if len(values) > width:
        per = len(values) / width
        values = [max(values[int(i * per):max(int((i + 1) * per),
                                              int(i * per) + 1)])
                  for i in range(width)]
    top = max(values)
    if top <= 0:
        return _BLOCKS[0] * len(values)
    return "".join(_BLOCKS[min(int(v / top * (len(_BLOCKS) - 1) + 0.5),
                               len(_BLOCKS) - 1)] for v in values)


def _load(path: str) -> Dict[str, list]:
    groups: Dict[str, list] = {"meta": [], "timeline": [], "signal": [],
                               "cluster": [], "decision": [],
                               "request": []}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            groups.setdefault(row.get("kind", "?"), []).append(row)
    return groups


def _series(rows: List[dict], key: str) -> List[float]:
    return [float(r[key]) for r in rows]


def _dashboard(groups: Dict[str, list], model: Optional[str],
               width: int, out) -> None:
    signals = groups["signal"]
    models = []
    for r in signals:
        if r["model"] not in models:
            models.append(r["model"])
    if model is not None:
        models = [m for m in models if m == model]
    chips = _series(groups["timeline"], "chips") \
        if groups["timeline"] else _series(groups["cluster"], "chips")
    print("== control plane ==", file=out)
    if chips:
        print(f"  chips      {_spark(chips, width)}  "
              f"(peak {max(chips):.0f})", file=out)
    for m in models:
        rows = [r for r in signals if r["model"] == m]
        if not rows:
            continue
        print(f"  model {m}", file=out)
        for key, label in (("q_interactive", "q_inter "),
                           ("q_batch", "q_batch "),
                           ("ibp", "ibp     "),
                           ("bbp", "bbp     ")):
            vals = [v for v in _series(rows, key) if v == v]  # drop NaN
            if vals:
                print(f"    {label} {_spark(vals, width)}  "
                      f"(max {max(vals):.2f})", file=out)


_OVERLOAD_ACTIONS = ("reject", "shed", "expire", "breaker", "brownout")


def _overload(groups: Dict[str, list], meta: dict, width: int,
              out) -> None:
    """Shed/reject/breaker panel: only rendered when the run carried the
    overload plane (any overload-kind decision rows, or nonzero outcome
    rates in the meta header)."""
    rows = [r for r in groups["decision"]
            if r.get("action") in _OVERLOAD_ACTIONS]
    rates = {k: meta.get(k, 0.0) or 0.0
             for k in ("reject_rate", "shed_rate", "expired_rate")}
    if not rows and not any(rates.values()):
        return
    print("== overload plane ==", file=out)
    print(f"  goodput {meta.get('goodput', 0.0):.2f} req/s   "
          f"rejected {rates['reject_rate']:.1%}   "
          f"shed {rates['shed_rate']:.1%}   "
          f"expired {rates['expired_rate']:.1%}", file=out)
    counts: Dict[str, int] = {}
    for r in rows:
        # shed/expire sweeps are aggregate rows: `count` requests each
        counts[r["action"]] = counts.get(r["action"], 0) \
            + int(r.get("count", 1))
    if counts:
        print("  events     " + "  ".join(
            f"{k}={counts[k]}" for k in _OVERLOAD_ACTIONS if k in counts),
            file=out)
    # per-action activity over time (event counts per time bucket)
    t1 = max((r["t"] for r in rows), default=0.0)
    for action in _OVERLOAD_ACTIONS:
        ts = [r["t"] for r in rows if r["action"] == action]
        if not ts or t1 <= 0:
            continue
        buckets = [0.0] * width
        for t in ts:
            buckets[min(int(t / t1 * (width - 1)), width - 1)] += 1
        print(f"    {action:<8} {_spark(buckets, width)}", file=out)
    trans = [r for r in rows if r["action"] in ("breaker", "brownout")]
    for r in trans[:12]:
        val = r.get("value")
        vs = f" value={val:.3g}" if isinstance(val, float) \
            and val == val else ""
        print(f"  t={r['t']:9.2f}  {r['action']:<8} "
              f"{r.get('reason'):<10} cluster={r.get('cluster')}{vs}",
              file=out)


def _decisions(groups: Dict[str, list], model: Optional[str],
               out, limit: int = 40) -> None:
    rows = groups["decision"]
    if model is not None:
        rows = [r for r in rows if r.get("model") == model]
    print(f"== decision ledger ({len(rows)} actions) ==", file=out)
    shown = rows if len(rows) <= limit else rows[:limit // 2] \
        + rows[-limit // 2:]
    skipped = len(rows) - len(shown)
    for i, r in enumerate(shown):
        if skipped and i == limit // 2:
            print(f"  ... {skipped} more ...", file=out)
        val = r.get("value")
        vs = f" value={val:.3g}" if isinstance(val, float) \
            and val == val else ""
        thr = r.get("threshold")
        ts = f" thr={thr:.3g}" if isinstance(thr, float) \
            and thr == thr else ""
        print(f"  t={r['t']:9.2f}  {r['action']:<9} {r['reason']:<10} "
              f"model={r.get('model')} itype={r.get('itype')} "
              f"chips {r['chips_before']}->{r['chips_after']}{vs}{ts}",
              file=out)


def _waterfalls(groups: Dict[str, list], model: Optional[str],
                n: int, width: int, out) -> None:
    reqs = groups["request"]
    if model is not None:
        reqs = [r for r in reqs if r.get("model") == model]
    print(f"== request waterfalls ({min(n, len(reqs))} of {len(reqs)} "
          f"sampled) ==", file=out)
    for r in reqs[:n]:
        t0 = r["arrival"]
        t1 = r["finish"]
        if t1 is None:
            ends = [tr["t"] for tr in r["transitions"]]
            t1 = max(ends) if ends else t0
        span = max(t1 - t0, 1e-9)

        def x(t: float) -> int:
            return min(int((t - t0) / span * (width - 1)), width - 1)

        bar = ["."] * width                       # queued by default
        ftt = r["first_token"]
        for tr in r["transitions"]:
            if tr["event"] == "admit":
                for i in range(x(tr["t"]), width):
                    bar[i] = "="
                if ftt is not None and ftt >= tr["t"]:
                    for i in range(x(max(ftt, tr["t"])), width):
                        bar[i] = "#"
            else:                                 # preempt: back to queued
                for i in range(x(tr["t"]), width):
                    bar[i] = "."
                bar[x(tr["t"])] = "x"
        ttft = "-" if ftt is None else f"{ftt - t0:7.3f}s"
        print(f"  row {r['row']:>7} {r['model'] or '?':<12} "
              f"|{''.join(bar)}| t0={t0:9.2f} ttft={ttft} "
              f"dur={t1 - t0:8.3f}s", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", help="flight-recorder export "
                    "(repro_torch.obs.export.to_jsonl)")
    ap.add_argument("--model", default=None,
                    help="restrict dashboards/waterfalls to one model")
    ap.add_argument("--width", type=int, default=72)
    ap.add_argument("--waterfalls", type=int, default=8,
                    help="number of sampled requests to render")
    args = ap.parse_args(argv)

    groups = _load(args.jsonl)
    out = sys.stdout
    meta = groups["meta"][0] if groups["meta"] else {}
    print(f"flight recorder: {args.jsonl}", file=out)
    if meta:
        print(f"  clusters={meta.get('clusters')} "
              f"models={meta.get('models')} "
              f"duration={meta.get('duration', 0.0):.1f}s "
              f"scale_ups={meta.get('scale_ups')} "
              f"scale_downs={meta.get('scale_downs')}", file=out)
    _dashboard(groups, args.model, args.width, out)
    _overload(groups, meta, args.width, out)
    _decisions(groups, args.model, out)
    _waterfalls(groups, args.model, args.waterfalls, args.width, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
