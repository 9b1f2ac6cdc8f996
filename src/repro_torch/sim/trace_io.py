"""Trace replay I/O: round-trip ``Trace`` columns to CSV/JSONL files.

Two dialects are understood on load:

- **Native** (what ``save_trace`` writes): one row per request with the
  canonical columns ``arrival, prompt_len, output_len, interactive,
  ttft_slo, itl_slo, model`` (plus ``origin``/``tenant`` when the trace
  carries those vocabularies). Round-trips a synthetic scenario exactly.
- **Azure-LLM-inference style** (azure-public-dataset): ``TIMESTAMP,
  ContextTokens, GeneratedTokens`` — ISO timestamps are vectorized through
  ``numpy.datetime64`` and normalized so the trace starts at t=0; missing
  class/SLO columns are filled from the defaults below.

Column names are matched case-insensitively against the alias table, so
``arrival_time``/``time``/``TIMESTAMP`` all land on the arrival column and
``ContextTokens``/``input_tokens``/``prompt_len`` on the prompt column.

Format is picked by extension: ``.jsonl`` -> JSON lines, anything else is
parsed as CSV; a trailing ``.gz`` on either transparently gzips the file
(``save_trace``/``load_trace``/``stream_trace`` all honour it).

Multi-day production traces stream through :func:`stream_trace`: one file
or a list of files (day-per-file archives concatenate back to back) is
parsed into chunks yielded as a :class:`~repro_torch.sim.workload.TraceStream`,
so replaying never holds the whole file (or its columns) in memory.
Chunks are either fixed row counts (``chunk_requests``) or — with
``window_s > 0`` — wall-clock time windows whose memory tracks the actual
arrival rate (a quiet night costs nearly nothing, a spike is still capped
by ``chunk_requests``). Streamed files must already be arrival-sorted —
the stream validates chunk boundaries; ISO timestamps are normalized
against the stream-global first timestamp.
"""
from __future__ import annotations

import csv
import gzip
import json
import math
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.request import BATCH_TTFT_SLO
from repro_torch.sim.workload import DEFAULT_MODEL, Trace, TraceStream, make_trace

# canonical column -> accepted aliases (lowercased)
_ALIASES: Dict[str, Sequence[str]] = {
    "arrival": ("arrival", "arrival_time", "timestamp", "time", "t"),
    "prompt_len": ("prompt_len", "contexttokens", "context_tokens",
                   "input_tokens", "prompt_tokens", "input_len"),
    "output_len": ("output_len", "generatedtokens", "generated_tokens",
                   "output_tokens", "gen_tokens"),
    "interactive": ("interactive", "is_interactive", "class",
                    "request_type", "type"),
    "ttft_slo": ("ttft_slo", "slo_ttft"),
    "itl_slo": ("itl_slo", "slo_itl"),
    "model": ("model", "model_name", "deployment"),
    "origin": ("origin", "origin_region", "region", "source_region"),
    "tenant": ("tenant", "tenant_id", "customer", "account"),
    "attempt": ("attempt", "retries", "retry_attempt", "attempts"),
}

_INTERACTIVE_WORDS = {"1", "true", "interactive", "chat", "conversation"}


def _canon(name: str) -> Optional[str]:
    low = name.strip().lower()
    for canon, aliases in _ALIASES.items():
        if low in aliases:
            return canon
    return None


def _fmt_path(path: str) -> str:
    """Extension used for format dispatch (``.gz`` is transparent)."""
    return path[:-3] if path.endswith(".gz") else path


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode, newline="" if mode == "r" else None)


def save_trace(trace: Trace, path: str) -> None:
    """Write a trace in the native schema (CSV or ``.jsonl``; ``.gz``
    compresses)."""
    models = trace.models
    origins = trace.origins
    tenants = trace.tenants
    # retry-attempt column only when it carries information — a fresh
    # trace round-trips to the byte-identical file it always did
    attempt = trace.attempt
    if attempt is not None and not attempt.any():
        attempt = None
    att_col = attempt.tolist() if attempt is not None \
        else [0] * trace.n
    cols = zip(trace.arrival.tolist(), trace.prompt_len.tolist(),
               trace.output_len.tolist(), trace.interactive.tolist(),
               trace.ttft_slo.tolist(), trace.itl_slo.tolist(),
               trace.model_idx.tolist(), trace.origin_idx.tolist(),
               trace.tenant_idx.tolist(), att_col)
    with _open(path, "w") as f:
        if _fmt_path(path).endswith(".jsonl"):
            for t, p, o, c, tt, il, m, g, tn, a in cols:
                row = {"arrival": t, "prompt_len": p, "output_len": o,
                       "interactive": bool(c), "ttft_slo": tt,
                       "itl_slo": il, "model": models[m]}
                if origins:
                    row["origin"] = origins[g]
                if tenants:
                    row["tenant"] = tenants[tn]
                if attempt is not None:
                    row["attempt"] = a
                f.write(json.dumps(row) + "\n")
        else:
            w = csv.writer(f, lineterminator="\n")   # RFC-4180 quoting
            header = ["arrival", "prompt_len", "output_len",
                      "interactive", "ttft_slo", "itl_slo", "model"]
            if origins:
                header.append("origin")
            if tenants:
                header.append("tenant")
            if attempt is not None:
                header.append("attempt")
            w.writerow(header)
            for t, p, o, c, tt, il, m, g, tn, a in cols:
                row = [repr(t), p, o, int(c), repr(tt), repr(il), models[m]]
                if origins:
                    row.append(origins[g])
                if tenants:
                    row.append(tenants[tn])
                if attempt is not None:
                    row.append(a)
                w.writerow(row)


def _parse_arrivals(raw: List[str]) -> np.ndarray:
    """Float seconds, or ISO timestamps normalized to seconds from t0."""
    try:
        return np.asarray(raw, dtype=np.float64)
    except ValueError:
        ts = np.array(raw, dtype="datetime64[us]")
        return (ts - ts.min()) / np.timedelta64(1, "s")


def _parse_interactive(raw: List[str]) -> np.ndarray:
    vals = np.array([v.strip().lower() for v in raw])
    return np.isin(vals, list(_INTERACTIVE_WORDS))


def _columns_to_trace(cols: Dict[str, List], n: int, *,
                      interactive_default: bool,
                      batch_ttft_slo: float,
                      model_default: str) -> Trace:
    if "arrival" not in cols or "prompt_len" not in cols \
            or "output_len" not in cols:
        missing = {"arrival", "prompt_len", "output_len"} - set(cols)
        raise ValueError(f"trace is missing required columns: {sorted(missing)}")
    arrival = _parse_arrivals([str(v) for v in cols["arrival"]])
    prompt = np.asarray(cols["prompt_len"], dtype=np.float64).astype(np.int64)
    output = np.asarray(cols["output_len"], dtype=np.float64).astype(np.int64)
    if "interactive" in cols:
        first = cols["interactive"][0]
        if isinstance(first, (bool, np.bool_, int, float)):
            interactive = np.asarray(cols["interactive"]).astype(bool)
        else:
            interactive = _parse_interactive([str(v) for v in
                                              cols["interactive"]])
    else:
        interactive = np.full(n, interactive_default, dtype=bool)
    ttft = np.asarray(cols["ttft_slo"], dtype=np.float64) \
        if "ttft_slo" in cols else None
    itl = np.asarray(cols["itl_slo"], dtype=np.float64) \
        if "itl_slo" in cols else None
    if "model" in cols:
        names = np.array([str(v) for v in cols["model"]])
        models, model_idx = np.unique(names, return_inverse=True)
        models = tuple(models.tolist())
        model_idx = np.asarray(model_idx, dtype=np.int32)
    else:
        models, model_idx = (model_default,), None
    if "origin" in cols:
        onames = np.array([str(v) for v in cols["origin"]])
        origins, origin_idx = np.unique(onames, return_inverse=True)
        origins = tuple(origins.tolist())
        origin_idx = np.asarray(origin_idx, dtype=np.int32)
    else:
        origins, origin_idx = (), None
    if "tenant" in cols:
        tnames = np.array([str(v) for v in cols["tenant"]])
        tenants, tenant_idx = np.unique(tnames, return_inverse=True)
        tenants = tuple(tenants.tolist())
        tenant_idx = np.asarray(tenant_idx, dtype=np.int32)
    else:
        tenants, tenant_idx = (), None
    if "attempt" in cols:
        attempt = np.asarray(cols["attempt"],
                             dtype=np.float64).astype(np.int32)
        if not attempt.any():
            attempt = None
    else:
        attempt = None
    # make_trace owns the class-mask SLO defaulting and the sort — one
    # rule for generated and loaded traces alike
    return make_trace(arrival, prompt, output, interactive,
                      ttft_slo=ttft, itl_slo=itl,
                      batch_ttft_slo=batch_ttft_slo,
                      model_idx=model_idx, models=models,
                      origin_idx=origin_idx, origins=origins,
                      tenant_idx=tenant_idx, tenants=tenants,
                      attempt=attempt)


def _read_columns(rows):
    """Accumulate parsed rows into ``(canonical columns, n)`` (ragged
    rows fail loudly)."""
    cols: Dict[str, List] = {}
    n = 0
    for row in rows:
        for k, v in row.items():
            cols.setdefault(k, []).append(v)
        n += 1
    # ragged rows leave short columns behind; fail loudly rather than shift
    for k, v in cols.items():
        if len(v) != n:
            raise ValueError(f"column {k!r} has {len(v)} values for {n} rows")
    return cols, n


def _iter_rows(path: str):
    """Yield one ``{canonical column -> raw value}`` dict per data row,
    parsing the file incrementally (shared by load and stream paths)."""
    if _fmt_path(path).endswith(".jsonl"):
        with _open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                out = {}
                for k, v in row.items():
                    ck = _canon(k)
                    if ck is not None:
                        out[ck] = v
                yield out
    else:
        with _open(path, "r") as f:
            reader = csv.reader(f)           # RFC-4180: quoted fields safe
            header = next(reader, [])
            keys = [_canon(h) for h in header]
            for row in reader:
                if not row:
                    continue
                yield {k: v for k, v in zip(keys, row) if k is not None}


def load_trace(path: str, *, interactive_default: bool = True,
               batch_ttft_slo: float = BATCH_TTFT_SLO,
               model_default: str = DEFAULT_MODEL,
               max_requests: int = 0) -> Trace:
    """Load a CSV/JSONL trace (optionally ``.gz``) into a sorted
    :class:`Trace`.

    ``max_requests > 0`` truncates after sorting (head of the trace).
    Unknown columns are ignored; missing class/SLO/model columns are
    filled from the defaults.
    """
    cols, n = _read_columns(_iter_rows(path))
    if n == 0:
        raise ValueError(f"empty trace file: {path}")
    tr = _columns_to_trace(cols, n, interactive_default=interactive_default,
                           batch_ttft_slo=batch_ttft_slo,
                           model_default=model_default)
    if max_requests and tr.n > max_requests:
        tr = tr.head(max_requests)
    return tr


def _row_arrival_seconds(raw, t0_iso: List) -> float:
    """Arrival of one raw row in seconds: plain floats pass through, ISO
    timestamps are normalized against the stream's first timestamp
    (``t0_iso`` is a shared one-element mutable cell)."""
    try:
        return float(raw)
    except (TypeError, ValueError):
        ts = np.datetime64(str(raw), "us")
        if not t0_iso:
            t0_iso.append(ts)
        return float((ts - t0_iso[0]) / np.timedelta64(1, "s"))


def stream_trace(path: Union[str, Sequence[str]], *,
                 chunk_requests: int = 65536,
                 window_s: float = 0.0,
                 interactive_default: bool = True,
                 batch_ttft_slo: float = BATCH_TTFT_SLO,
                 model_default: str = DEFAULT_MODEL,
                 max_requests: int = 0) -> TraceStream:
    """Stream one or more CSV/JSONL traces (optionally ``.gz``) as
    arrival-ordered :class:`Trace` chunks.

    The windowed loader for multi-day production traces: at no point is
    the whole file resident — each chunk's columns are built and handed
    to the consumer (the event core's request cursor accepts the stream
    directly) before the next chunk is parsed.

    Chunking policy:

    - ``window_s == 0`` (default): fixed-size chunks of
      ``chunk_requests`` rows.
    - ``window_s > 0``: *time-windowed* chunks — a chunk closes when the
      next row's arrival crosses the current ``window_s`` boundary, so a
      day-long trace streams in wall-clock windows whose memory tracks
      the actual arrival rate rather than a fixed row count.
      ``chunk_requests`` still caps a single window's rows (a traffic
      spike inside one window must not buffer unbounded rows); ISO
      timestamps are normalized against the first row seen.

    ``path`` may be a list of files replayed back to back — day-per-file
    archives concatenate without ever being loaded together; arrival
    order must hold across the file boundary (``TraceStream`` validates
    every chunk boundary and raises otherwise). ``max_requests > 0``
    stops after that many rows.
    """
    if chunk_requests <= 0:
        raise ValueError("chunk_requests must be positive")
    if window_s < 0:
        raise ValueError("window_s must be >= 0")
    paths = [path] if isinstance(path, str) else list(path)
    if not paths:
        raise ValueError("stream_trace needs at least one path")

    def _flush(buf: List[Dict]) -> Trace:
        cols, n = _read_columns(buf)
        return _columns_to_trace(
            cols, n, interactive_default=interactive_default,
            batch_ttft_slo=batch_ttft_slo, model_default=model_default)

    def chunks() -> Iterator[Trace]:
        buf: List[Dict] = []
        served = 0
        window_end = window_s
        t0_iso: List = []
        for p in paths:
            for row in _iter_rows(p):
                raw = row.get("arrival")
                if raw is not None:
                    # normalize ISO timestamps against the stream-global
                    # t0 here (per-chunk normalization would re-zero every
                    # chunk and break cross-chunk arrival ordering)
                    try:
                        arr = float(raw)
                    except (TypeError, ValueError):
                        arr = _row_arrival_seconds(raw, t0_iso)
                        row["arrival"] = arr
                else:
                    arr = 0.0
                if window_s > 0 and arr >= window_end:
                    if buf:
                        yield _flush(buf)
                        served += len(buf)
                        buf = []
                    # jump straight to the window containing ``arr`` —
                    # stepping one window at a time would spin
                    # O(arr/window_s) on large absolute timestamps
                    # (e.g. un-normalized unix-epoch seconds)
                    window_end = (math.floor(arr / window_s) + 1) * window_s
                buf.append(row)
                if max_requests and served + len(buf) >= max_requests:
                    buf = buf[:max_requests - served]
                    yield _flush(buf)
                    return
                if len(buf) >= chunk_requests:
                    yield _flush(buf)
                    served += len(buf)
                    buf = []
        if buf:
            yield _flush(buf)

    return TraceStream(chunks())
