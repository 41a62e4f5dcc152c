"""Durable serving: the write-ahead request journal and crash-safe warm
restart.

The port's copy of ``apex_tpu/serving/journal.py`` (the port imports
nothing of the JAX package); for the same records either package writes
the same bytes, and each reads the other's journal. Every
fault-tolerance layer below — ``rebuild_slots`` isolation, fleet
failover with the emitted-prefix hand-off, host-swap preemption replay —
lives and dies with the process: a SIGKILL loses every in-flight stream,
registered adapter and parked conversation. This module makes the
recovery contract survive the process: a segmented, CRC-framed
append-only log records every durable-relevant host decision, and
:func:`recover_scheduler` rebuilds a fresh engine and scheduler from it,
so client streams continue across a process death with the tokens they
were sent re-derived and suppressed.

Record framing (one record)::

    [u32 payload length][u32 crc32(payload)][payload: compact JSON]

Payloads are JSON objects ``{"seq": n, "kind": k, ...fields}``. Kinds:

- ``meta`` — format version + the engine spec (``model`` and ``engine``
  of :meth:`Engine.describe`), so recovery can refuse an incompatible
  engine before resubmitting anything.
- ``submit`` — prompt/sampling/seed/eos/stop/tenant/adapter plus the
  deadline remaining at submit (absolute clocks do not survive a
  restart; recovery re-bases them).
- ``extend`` — the emitted-prefix snapshot's growth since the last
  journaled length, logged at fetch boundaries: ``{request_id, start,
  tokens, logprobs}``. Absolute start offsets make replaying a record
  twice (a crash between compaction's write and its cleanup) harmless.
- ``finish`` — terminal outcome (eos/length/stop/timeout/error, or
  ``evicted`` when a fleet failover took the work); recovery skips
  finished requests.
- ``park`` / ``resume`` — the host-swap lifecycle; a parked conversation
  recovers as a queued resubmission.
- ``adapter`` / ``prefix`` — pool registrations. Seeded adapters
  re-derive from the recorded seed; explicit-weight registrations record
  ``seed: null`` and recovery counts them as unreplayable (their
  requests are skipped with a counted stat).

Torn-tail recovery: scanning stops at the first incomplete header, short
payload or CRC mismatch; opening a journal for append (and
:func:`scan_journal` with ``repair=True``) truncates the torn segment at
the last complete record and removes any later segments — no duplicate
and no lost committed record. Tokens appended after the last fsync may
be lost with the page cache; recovery re-derives them.

The fsync policy prices durability: ``always`` fsyncs every append,
``batch`` once a fetch boundary (the scheduler's commit point, the
default), ``none`` never. Compacted segments and the manifest are
finalized through :mod:`apex_tpu_torch._atomic`.

Standard library only: scanning and compaction run with no torch
installed; :func:`recover_scheduler` imports the serving stack lazily.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from apex_tpu_torch import _atomic

__all__ = [
    "FORMAT_VERSION", "FSYNC_POLICIES", "Journal", "JournalError",
    "JournalState", "RecoveryReport", "recover_scheduler",
    "replay_into", "replay_state", "scan_journal",
]

#: bump on any incompatible record-schema change; recovery refuses a
#: journal whose meta record claims a newer format
FORMAT_VERSION = 1

FSYNC_POLICIES = ("none", "batch", "always")

#: per-record frame: little-endian u32 payload length + u32 crc32
_FRAME = struct.Struct("<II")

#: a length prefix past this is torn garbage, not a record (the
#: largest real record is a long prompt — a few hundred KiB)
_MAX_RECORD = 64 * 1024 * 1024

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".wal"
_MANIFEST = "journal.json"


class JournalError(ValueError):
    """A journal that cannot be appended to or recovered from."""


def _seg_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def _seg_index(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX)
            and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _encode(rec: Dict[str, Any]) -> bytes:
    # default=str: engine-spec dicts may carry dtype objects; recovery
    # compares the round-tripped JSON on both sides, so stringifying
    # is lossless for the compatibility check
    return json.dumps(rec, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8")


def _segments(path: str) -> List[Tuple[int, str]]:
    """Sorted ``(index, filename)`` of the segment files under
    ``path``."""
    out = []
    for name in os.listdir(path):
        idx = _seg_index(name)
        if idx is not None:
            out.append((idx, name))
    out.sort()
    return out


def _scan_file(full: str) -> Tuple[List[Dict[str, Any]], int, int]:
    """Read one segment: ``(records, good_bytes, torn_bytes)`` —
    scanning stops at the first incomplete or CRC-failing frame."""
    records: List[Dict[str, Any]] = []
    good = 0
    size = os.path.getsize(full)
    with open(full, "rb") as f:
        while True:
            hdr = f.read(_FRAME.size)
            if len(hdr) < _FRAME.size:
                break
            ln, crc = _FRAME.unpack(hdr)
            if ln > _MAX_RECORD:
                break
            payload = f.read(ln)
            if len(payload) < ln or zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                break
            if not isinstance(rec, dict):
                break
            records.append(rec)
            good += _FRAME.size + ln
    return records, good, size - good


def scan_journal(path: str, *,
                 repair: bool = False
                 ) -> Tuple[List[Dict[str, Any]], int]:
    """Read every complete record from the journal at ``path``,
    oldest first: ``(records, truncated_bytes)``. Scanning stops at
    the first bad CRC / torn frame — everything after it (including
    whole later segments) is counted as truncated. With
    ``repair=True`` the torn segment is physically truncated at the
    last complete record and later segments are removed, so a
    subsequent append continues from a clean tail."""
    if not os.path.isdir(path):
        raise JournalError(f"no journal directory at {path}")
    records: List[Dict[str, Any]] = []
    truncated = 0
    torn_at: Optional[int] = None
    for pos, (idx, name) in enumerate(_segments(path)):
        full = os.path.join(path, name)
        if torn_at is not None:
            # everything past the first torn frame is suspect: a later
            # segment could replay state the lost records invalidated
            truncated += os.path.getsize(full)
            if repair:
                os.unlink(full)
            continue
        recs, good, torn = _scan_file(full)
        records.extend(recs)
        if torn:
            truncated += torn
            torn_at = pos
            if repair:
                with open(full, "r+b") as f:
                    f.truncate(good)
    return records, truncated


class Journal:
    """Segmented CRC-framed append-only write-ahead log.

    >>> j = Journal("state/journal", fsync="batch")
    >>> sched = Scheduler(engine, journal=j)

    Opening an existing journal repairs its torn tail (see
    :func:`scan_journal`) and continues appending; ``truncated_bytes``
    reports what the repair dropped. ``segment_bytes`` bounds one
    segment file — rotation seals the current segment (flush + fsync +
    manifest rewrite through :func:`apex_tpu_torch._atomic.atomic_write`)
    and opens the next. ``compact_min_finished`` arms automatic
    compaction: once that many ``finish`` records accumulate,
    :meth:`maybe_compact` (called by the scheduler at fetch
    boundaries) rewrites the live state — registrations plus
    unfinished requests with their merged emitted prefixes — into one
    fresh segment and drops everything finished. ``None`` leaves
    compaction manual (:meth:`compact`)."""

    def __init__(self, path: str, *, fsync: str = "batch",
                 segment_bytes: int = 4 * 1024 * 1024,
                 compact_min_finished: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        if segment_bytes < 4096:
            raise ValueError(
                f"segment_bytes {segment_bytes} < 4096 — rotation "
                f"per record would thrash the manifest")
        self.path = os.path.abspath(path)
        self.fsync_policy = fsync
        self.segment_bytes = int(segment_bytes)
        self.compact_min_finished = compact_min_finished
        self.clock = clock
        os.makedirs(self.path, exist_ok=True)
        records, self.truncated_bytes = scan_journal(self.path,
                                                     repair=True)
        for rec in records:
            if rec.get("kind") == "meta" and int(
                    rec.get("format", 0)) > FORMAT_VERSION:
                raise JournalError(
                    f"journal format {rec['format']} is newer than "
                    f"this build's {FORMAT_VERSION}")
        self._seq = max((int(r.get("seq", 0)) for r in records),
                        default=0)
        #: counters (monotonic; the scheduler mirrors them into
        #: registry metrics and ``summary()``)
        self.appends = 0
        self.rotations = 0
        self.compactions = 0
        self.compaction_errors = 0
        self.fsyncs = 0
        self.fsync_s = 0.0
        self.last_append_bytes = 0
        #: ``(segment_name, records, bytes)`` of the most recently
        #: sealed segment — the journal_rotate event payload
        self.last_sealed: Optional[Tuple[str, int, int]] = None
        self._lag_bytes = 0
        self._finished_since_compact = 0
        segs = _segments(self.path)
        self._bytes_other = sum(
            os.path.getsize(os.path.join(self.path, n))
            for _, n in segs[:-1])
        if segs:
            self._segment_index = segs[-1][0]
            cur = os.path.join(self.path, segs[-1][1])
            self._segment_written = os.path.getsize(cur)
            self._segment_records = 0
            self._f = open(cur, "ab")
        else:
            self._segment_index = 1
            self._segment_written = 0
            self._segment_records = 0
            self._f = open(self._current_path(), "ab")
            self._write_manifest()

    # -- paths ---------------------------------------------------------------

    def _current_path(self) -> str:
        return os.path.join(self.path, _seg_name(self._segment_index))

    def segments(self) -> List[str]:
        """Segment filenames, oldest first."""
        return [n for _, n in _segments(self.path)]

    @property
    def seq(self) -> int:
        """Sequence number of the newest record (0 = empty)."""
        return self._seq

    @property
    def lag_bytes(self) -> int:
        """Bytes appended since the last fsync — the durability lag
        a crash right now could lose (page-cache resident)."""
        return self._lag_bytes

    def bytes_on_disk(self) -> int:
        """Total journal bytes across all segments."""
        return self._bytes_other + self._segment_written

    # -- appending -----------------------------------------------------------

    def append(self, kind: str, **fields: Any) -> int:
        """Append one record; returns its sequence number. Durability
        is the fsync policy's: ``always`` syncs here, ``batch`` at the
        next :meth:`commit`, ``none`` never."""
        if self._f is None:
            raise JournalError("journal is closed")
        self._seq += 1
        rec = {"seq": self._seq, "kind": kind}
        rec.update(fields)
        frame = _frame(_encode(rec))
        self._f.write(frame)
        n = len(frame)
        self.appends += 1
        self.last_append_bytes = n
        self._segment_written += n
        self._segment_records += 1
        self._lag_bytes += n
        if kind == "finish":
            self._finished_since_compact += 1
        if self.fsync_policy == "always":
            self._do_fsync()
        if self._segment_written >= self.segment_bytes:
            self.rotate()
        return self._seq

    def commit(self) -> None:
        """The batch-boundary durability point (the scheduler calls
        this once per fetch): flush buffered frames to the OS, and
        fsync under the ``batch`` policy."""
        if self._f is None or self._lag_bytes == 0:
            return
        if self.fsync_policy == "batch":
            self._do_fsync()
        else:
            self._f.flush()
            if self.fsync_policy == "none":
                # flushed to the page cache; a crash may lose it but a
                # clean reader (compaction, a scanner) sees everything
                self._lag_bytes = 0

    def _do_fsync(self) -> None:
        t0 = self.clock()
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsync_s += max(self.clock() - t0, 0.0)
        self.fsyncs += 1
        self._lag_bytes = 0

    def rotate(self) -> None:
        """Seal the current segment (flush + fsync + manifest rewrite
        through the shared atomic helper) and open the next."""
        if self._f is None:
            raise JournalError("journal is closed")
        self._do_fsync()
        self._f.close()
        self.last_sealed = (_seg_name(self._segment_index),
                            self._segment_records,
                            self._segment_written)
        self._bytes_other += self._segment_written
        self._segment_index += 1
        self._segment_written = 0
        self._segment_records = 0
        self._f = open(self._current_path(), "ab")
        self.rotations += 1
        self._write_manifest()

    def _write_manifest(self) -> None:
        segs = self.segments()
        cur = _seg_name(self._segment_index)
        manifest = {
            "format": FORMAT_VERSION,
            "current": cur,
            "sealed": [n for n in segs if n != cur],
        }
        _atomic.atomic_write(
            os.path.join(self.path, _MANIFEST),
            lambda f: json.dump(manifest, f, indent=1, sort_keys=True),
            text=True)

    # -- compaction ----------------------------------------------------------

    def maybe_compact(self) -> bool:
        """Compact when the armed threshold of finished requests has
        accumulated (no-op when ``compact_min_finished`` is None).
        A failed rewrite (ENOSPC is likely precisely when compacting)
        degrades to a counted error rather than raising: the tail
        segment stays open for appends (see :meth:`compact`), so a
        disk hiccup at a fetch boundary never becomes a serving
        outage; the threshold re-arms after another
        ``compact_min_finished`` finishes."""
        if (self.compact_min_finished is None
                or self._finished_since_compact
                < self.compact_min_finished):
            return False
        try:
            self.compact()
        except OSError:
            self.compaction_errors += 1
            self._finished_since_compact = 0
            return False
        return True

    def compact(self) -> Dict[str, int]:
        """Rewrite the journal's LIVE state into one fresh segment —
        meta, registrations, and every unfinished request as a single
        ``submit`` + merged full-prefix ``extend`` (+ ``park``) — and
        drop finished requests. The new segment is materialised
        through :func:`apex_tpu_torch._atomic.atomic_write` (complete or
        absent, fsynced along with its directory entry) BEFORE old
        segments are removed, and extends carry absolute offsets, so
        a crash anywhere in between replays to the same state. If the
        rewrite itself fails (ENOSPC), the previous tail segment is
        reopened for append and the error re-raised — a failed
        compaction leaves a journal that still journals."""
        if self._f is None:
            raise JournalError("journal is closed")
        self._f.flush()
        records, _ = scan_journal(self.path)
        state = replay_state(records)
        out: List[Dict[str, Any]] = []
        meta = dict(state.meta) if state.meta else {
            "kind": "meta", "format": FORMAT_VERSION}
        out.append(meta)
        out.extend(dict(a) for a in state.adapters)
        out.extend({"kind": "prefix", "tokens": list(t)}
                   for t in state.prefixes)
        dropped = 0
        for rq in state.requests.values():
            if rq["finished"]:
                dropped += 1
                continue
            sub = {k: rq[k] for k in _SUBMIT_FIELDS if k in rq}
            sub["kind"] = "submit"
            out.append(sub)
            if rq["emitted"]:
                out.append({"kind": "extend",
                            "request_id": rq["request_id"], "start": 0,
                            "tokens": list(rq["emitted"]),
                            "logprobs": list(rq["logprobs"])})
            if rq["parked"]:
                out.append({"kind": "park",
                            "request_id": rq["request_id"]})
        for i, rec in enumerate(out):
            rec["seq"] = i + 1
        old = [os.path.join(self.path, n) for n in self.segments()]
        self._f.close()
        self._f = None
        self._segment_index += 1
        new_path = self._current_path()

        def _write(f):
            for rec in out:
                f.write(_frame(_encode(rec)))

        try:
            # atomic_write fsyncs the segment AND its directory entry
            # before returning, so the unlinks below can never outlive
            # the new segment across a power loss
            _atomic.atomic_write(new_path, _write)
        except BaseException:
            # rewrite failed mid-compaction: reopen the previous tail
            # for append so the scheduler's _jlog keeps working — the
            # old segments are all still intact
            self._segment_index -= 1
            self._f = open(old[-1], "ab")
            self._segment_written = os.path.getsize(old[-1])
            raise
        removed = 0
        try:
            for p in old:
                os.unlink(p)
                removed += 1
        finally:
            # even a failed unlink leaves a valid journal (replay is
            # idempotent over leftover old segments) — appends must
            # continue on the compacted tail regardless
            self._f = open(new_path, "ab")
            self._seq = max(self._seq, len(out))
            self._segment_written = os.path.getsize(new_path)
            self._segment_records = len(out)
            self._bytes_other = sum(
                os.path.getsize(os.path.join(self.path, n))
                for _, n in _segments(self.path)
                if os.path.join(self.path, n) != new_path)
            self._lag_bytes = 0
            self.compactions += 1
            self._finished_since_compact = 0
            self._write_manifest()
        return {"records": len(out), "dropped_finished": dropped,
                "segments_removed": removed}

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Flat counters for ``summary()`` / the bench line."""
        return {
            "appends": float(self.appends),
            "bytes": float(self.bytes_on_disk()),
            "lag_bytes": float(self._lag_bytes),
            "fsyncs": float(self.fsyncs),
            "fsync_s": self.fsync_s,
            "rotations": float(self.rotations),
            "compactions": float(self.compactions),
            "compaction_errors": float(self.compaction_errors),
            "segments": float(len(self.segments())),
            "truncated_bytes": float(self.truncated_bytes),
        }

    def close(self) -> None:
        """Flush, fsync (unless policy ``none``), and close."""
        if self._f is None:
            return
        if self.fsync_policy == "none":
            self._f.flush()
        else:
            self._do_fsync()
        self._f.close()
        self._f = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- replaying ---------------------------------------------------------------

#: the submit-record fields recovery rebuilds a Request from (also the
#: compaction rewrite's projection)
_SUBMIT_FIELDS = (
    "order", "request_id", "prompt", "max_tokens", "temperature",
    "top_k", "top_p", "seed", "eos_token_id", "stop", "constrained",
    "deadline_remaining", "tenant", "adapter", "adapter_name",
)


@dataclasses.dataclass
class JournalState:
    """The journal's replayed state: what was registered, and every
    request with its merged emitted prefix and lifecycle flags."""

    meta: Optional[Dict[str, Any]] = None
    #: adapter records in first-registration order (name-deduped)
    adapters: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    #: prefix token lists in first-registration order (deduped)
    prefixes: List[List[int]] = dataclasses.field(default_factory=list)
    #: request_id → submit fields + ``emitted``/``logprobs``/
    #: ``parked``/``finished``/``finish_reason``
    requests: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: extend records whose start offset did not splice (gap after a
    #: mid-journal truncation) — surfaced, never silently dropped
    anomalies: int = 0

    def unfinished(self) -> List[Dict[str, Any]]:
        """Requests recovery must resubmit, in original submit
        order."""
        live = [r for r in self.requests.values()
                if not r["finished"]]
        live.sort(key=lambda r: r.get("order", 0))
        return live


def replay_state(records: List[Dict[str, Any]]) -> JournalState:
    """Fold scanned records into a :class:`JournalState`. Replay is
    idempotent over duplicated suffixes (absolute extend offsets,
    name-keyed registrations), which is what makes compaction
    crash-safe."""
    st = JournalState()
    seen_adapters: Dict[str, int] = {}
    seen_prefixes: Dict[Tuple[int, ...], int] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "meta":
            st.meta = rec
        elif kind == "adapter":
            name = rec.get("name")
            pos = seen_adapters.get(name)
            if pos is None:
                seen_adapters[name] = len(st.adapters)
                st.adapters.append(rec)
            else:
                # a post-recovery re-registration of the same name
                # carries the FRESH engine's id — keep the LATEST
                # record (first-seen order preserved) so the id map
                # matches the latest generation of submit records
                st.adapters[pos] = rec
        elif kind == "prefix":
            key = tuple(int(t) for t in rec.get("tokens", ()))
            if key not in seen_prefixes:
                seen_prefixes[key] = len(st.prefixes)
                st.prefixes.append(list(key))
        elif kind == "submit":
            rid = rec.get("request_id")
            rq = st.requests.get(rid)
            if rq is None:
                rq = st.requests[rid] = {"emitted": [], "logprobs": []}
            for k in _SUBMIT_FIELDS:
                if k in rec:
                    rq[k] = rec[k]
            rq["parked"] = False
            rq["finished"] = False
            rq["finish_reason"] = None
        elif kind == "extend":
            rq = st.requests.get(rec.get("request_id"))
            if rq is None:
                st.anomalies += 1
                continue
            start = int(rec.get("start", 0))
            toks = [int(t) for t in rec.get("tokens", ())]
            lps = list(rec.get("logprobs", ()))
            if start > len(rq["emitted"]):
                st.anomalies += 1
                continue
            rq["emitted"][start:start + len(toks)] = toks
            rq["logprobs"][start:start + len(lps)] = lps
        elif kind == "finish":
            rq = st.requests.get(rec.get("request_id"))
            if rq is not None:
                rq["finished"] = True
                rq["finish_reason"] = rec.get("reason")
                rq["parked"] = False
        elif kind == "park":
            rq = st.requests.get(rec.get("request_id"))
            if rq is not None:
                rq["parked"] = True
        elif kind == "resume":
            rq = st.requests.get(rec.get("request_id"))
            if rq is not None:
                rq["parked"] = False
    return st


@dataclasses.dataclass
class RecoveryReport:
    """What a recovery replayed — the ``recover`` flight event's
    payload and the drill's acceptance evidence."""

    requests: int = 0
    adapters: int = 0
    prefixes: int = 0
    skipped_constrained: int = 0
    #: adapter REGISTRATIONS that could not replay (explicit weights,
    #: ``seed: null`` — not re-derivable)
    skipped_adapters: int = 0
    #: REQUESTS skipped because their journaled adapter id could not
    #: be mapped onto the fresh engine (pinned to an unreplayable
    #: adapter, or the registration record itself was lost to a torn
    #: tail) — running them with guessed weights would violate the
    #: bit-identical contract
    skipped_adapter_requests: int = 0
    truncated_bytes: int = 0
    anomalies: int = 0
    wall_s: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}


def _engine_spec(engine) -> Dict[str, Any]:
    """The describe() subset a journal pins engine compatibility on (the
    model and the engine geometry; the port runs on one device, so no
    ``tp``), round-tripped through the journal's own JSON encoding so
    both sides of the comparison normalise identically."""
    desc = engine.describe()
    spec = {k: desc[k] for k in ("model", "engine", "tp") if k in desc}
    return json.loads(_encode(spec).decode("utf-8"))


def replay_into(scheduler, source, *,
                truncated_bytes: int = 0) -> RecoveryReport:
    """Replay a journal's live state into ``scheduler``: re-register
    seeded adapters and pooled prefixes (idempotent — registering an
    existing name/prefix returns the existing id), then re-submit
    every unfinished request through the
    ``submit(replay_prefix=)`` hook so its stream continues
    bit-identically. ``source`` is a journal directory path or an
    already-scanned record list. Deadlines re-base at the scheduler's
    current clock from the journaled remaining budget. Constrained
    requests (opaque DFA — not serialisable) and requests pinned to an
    explicit-weights adapter (``seed: null`` — not re-derivable) are
    skipped with counted stats.

    Engine adapter ids are assigned sequentially at registration, so
    the fresh engine's ids need not match the journaled ones (any
    skipped ``seed: null`` registration shifts every later id — and
    across a SECOND recovery a re-registration can even reuse a dead
    registration's old id): each request maps back to its adapter by
    NAME (the stable, engine-deduped cross-recovery key its submit
    record carries), falling back to a journaled-id → fresh-id map
    for hand-built records, and a request whose adapter cannot be
    mapped is skipped with a counted stat — never resubmitted against
    whatever adapter happens to occupy the journaled row."""
    if isinstance(source, str):
        records, truncated_bytes = scan_journal(source)
    else:
        records = source
    state = replay_state(records)
    report = RecoveryReport(truncated_bytes=truncated_bytes,
                            anomalies=state.anomalies)
    adapter_ids = {0: 0}        # base weights map to base weights
    adapter_names: Dict[str, int] = {}
    for ad in state.adapters:
        if ad.get("seed") is None:
            report.skipped_adapters += 1
            continue
        aid = int(scheduler.register_adapter(name=ad.get("name"),
                                             seed=int(ad["seed"])))
        if ad.get("name") is not None:
            adapter_names[ad["name"]] = aid
        jid = ad.get("adapter_id")
        if jid is not None:
            adapter_ids[int(jid)] = aid
        report.adapters += 1
    for toks in state.prefixes:
        scheduler.register_prefix(toks)
        report.prefixes += 1
    from apex_tpu_torch.serving.request import Request, SamplingParams
    now = scheduler.clock()
    for rq in state.unfinished():
        if rq.get("constrained"):
            report.skipped_constrained += 1
            continue
        aname = rq.get("adapter_name")
        adapter = (adapter_names.get(aname) if aname is not None
                   else adapter_ids.get(int(rq.get("adapter") or 0)))
        if adapter is None:
            report.skipped_adapter_requests += 1
            continue
        remaining = rq.get("deadline_remaining")
        req = Request(
            request_id=rq["request_id"],
            prompt=list(rq["prompt"]),
            max_tokens=int(rq["max_tokens"]),
            sampling=SamplingParams(
                temperature=rq.get("temperature", 0.0),
                top_k=rq.get("top_k", 0),
                top_p=rq.get("top_p", 1.0),
                seed=rq.get("seed")),
            eos_token_id=rq.get("eos_token_id"),
            deadline=(None if remaining is None
                      else now + float(remaining)),
            stop=rq.get("stop"),
            tenant=rq.get("tenant") or "default",
            adapter=adapter)
        # an empty replay prefix is still a failover hand-off (list,
        # not None): the original submit already charged the tenant's
        # token budget — recovery must not double-bill or throttle it
        scheduler.submit(req, replay_prefix=list(rq["emitted"]),
                         replay_logprobs=list(rq["logprobs"]))
        report.requests += 1
    scheduler._journal_recovered += report.requests
    if scheduler.recorder is not None:
        scheduler.recorder.record(
            "recover", report.requests, report.adapters,
            report.prefixes, report.truncated_bytes)
    if scheduler.telemetry is not None:
        scheduler.telemetry.journal_recovered.inc(report.requests)
    return report


def recover_scheduler(journal_dir: str, engine_factory,
                      *, fsync: str = "batch",
                      segment_bytes: int = 4 * 1024 * 1024,
                      compact_min_finished: Optional[int] = None,
                      strict: bool = True,
                      **scheduler_kwargs) -> Tuple[Any, RecoveryReport]:
    """Crash-safe warm restart: rebuild a fresh engine + scheduler
    from the journal at ``journal_dir`` and return
    ``(scheduler, report)``. The journal's torn tail is repaired, the
    factory engine is (with ``strict=True``) checked
    against the journaled engine spec (:meth:`Engine.describe`
    round-trip — an incompatible engine would silently decode
    different streams), the journal is re-opened for continued
    appends, and :func:`replay_into` resubmits every unfinished
    request. The recovered scheduler journals its own resubmissions,
    so a second crash recovers from the same directory."""
    t0 = time.monotonic()
    records, truncated = scan_journal(journal_dir, repair=True)
    state = replay_state(records)
    engine = engine_factory()
    if strict and state.meta is not None \
            and state.meta.get("engine_spec") is not None:
        want = state.meta["engine_spec"]
        have = _engine_spec(engine)
        if want != have:
            diff = sorted(k for k in set(want) | set(have)
                          if want.get(k) != have.get(k))
            raise JournalError(
                f"engine_factory built an incompatible engine "
                f"(differs at {diff}) — a recovered stream would not "
                f"be bit-identical; pass strict=False to override")
    journal = Journal(journal_dir, fsync=fsync,
                      segment_bytes=segment_bytes,
                      compact_min_finished=compact_min_finished)
    from apex_tpu_torch.serving.scheduler import Scheduler
    sched = Scheduler(engine, journal=journal, **scheduler_kwargs)
    report = replay_into(sched, records, truncated_bytes=truncated)
    report.wall_s = time.monotonic() - t0
    return sched, report
