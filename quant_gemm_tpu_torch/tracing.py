"""Spans of the port's layers, on the profiler's clock.

A span is one piece of work: its name, its start and end in ns on
:func:`now` (Unix time, the clock ``torch.profiler`` stamps its events
with), the span open around it in the same thread when it began (its
parent) and the request it serves (``rid``, -1 for none).  Spans of one
request share its ``rid``.  :func:`span` records one in two cases:

* while a ``torch.profiler`` window is open in the calling thread; the
  span is then also a profiler range (``record_function``) of the same
  name, so the trace shows it beside the kernels launched inside it;
* between :func:`start` and :func:`stop`, for an operator without a
  profiler.

Otherwise opening a span costs a flag check and the profiler's own
enabled check, and allocates nothing.  Under a profiler, a span's start
is the midpoint of two reads around its range's opening and its end a
read just after the range closes: each within a microsecond or two of
the profiler's own stamp of the range (a median on the CPU), so host
spans line up with the device intervals of the same trace.

Recorded spans go to one buffer for the process that keeps the newest
:data:`CAPACITY`; :func:`spans` returns them in the order they ended and
:func:`dropped` counts the ones the buffer lost.  The serving loop's
spans (``models/serve.py``): ``serve.step``, ``serve.admit`` (a request's
admission, with its ``slot`` and ``reused`` prompt tokens),
``serve.prefill.chunk``, ``serve.decode``, ``serve.decode.replay`` and
``serve.sample``; the collectives' (``parallel/sharding.py``):
``collective.*``, ``ppermute.start#t`` / ``ppermute.wait#t`` and
``ring_gemm``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

#: spans the buffer keeps (the newest)
CAPACITY = 1 << 17

#: the spans' clock: ns of Unix time, as ``torch.profiler`` stamps events
now = time.time_ns

_on = False
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_added = 0
_ids = itertools.count()
_lock = threading.Lock()  # the buffer and its count
_local = threading.local()


class Span:
    """One recorded span; ``attrs`` holds what :meth:`note` added."""

    __slots__ = ("name", "rid", "id", "parent", "start_ns", "end_ns",
                 "attrs", "_range")

    def __init__(self, name: str, rid: int):
        self.name, self.rid = name, rid
        self.id = next(_ids)
        self.parent = -1
        self.start_ns = self.end_ns = 0
        self.attrs: dict = {}
        self._range = None

    def note(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            t = now()
            self._range.__enter__()
            # the profiler stamps the range's start inside that call
            self.start_ns = (t + now()) // 2
        else:
            self.start_ns = now()
        return self

    def __exit__(self, *exc) -> bool:
        global _added
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = now()
        _stack().pop()
        with _lock:
            _buffer.append(self)
            _added += 1
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, rid={self.rid}, id={self.id}, "
                f"parent={self.parent}, {self.start_ns}..{self.end_ns}, "
                f"{self.attrs})")


class _Off:
    """The span of an unrecorded piece of work: one object for all."""

    __slots__ = ()

    def note(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, rid: int = -1):
    """A context manager around one piece of work named ``name``; records
    it while a profiler window is open or between :func:`start` and
    :func:`stop`."""
    if not (_on or torch.autograd._profiler_enabled()):
        return _OFF
    return Span(name, rid)


def start() -> None:
    """Record spans from now on, profiler or not."""
    global _on
    _on = True


def stop() -> None:
    """Record spans only inside a profiler window again (what was
    recorded stays in the buffer)."""
    global _on
    _on = False


def spans() -> list:
    """The recorded spans the buffer holds, in the order they ended."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Spans recorded since the last :func:`clear` that the buffer no
    longer holds (it keeps the newest :data:`CAPACITY`)."""
    with _lock:
        return _added - len(_buffer)


def clear() -> None:
    """Empty the buffer."""
    global _added
    with _lock:
        _buffer.clear()
        _added = 0


__all__ = ["CAPACITY", "Span", "span", "start", "stop", "spans", "dropped",
           "clear", "now"]
