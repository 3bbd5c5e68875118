"""One run of one cell: set-up, the measured window, the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its metrics are the entries of
``BENCHMARK.json`` that it reports, each read by ``metrics/<name>.py``
(a function ``read(run)`` returning a number, or None where it finds
nothing to read).  A configuration names its architecture under ``arch``,
whose module is ``archs/<arch>.py``.  Nothing here names a cell, a
configuration, a mix, a metric or an architecture: a later cell adds
files and entries only.

An architecture's module keeps this interface:

- ``program(config, seed, device)``: (the weights' model, the program's
  params, the program's config), the weights drawn on the card from the
  seed;
- ``server(params, program_config, served, device)``: the Server, built
  through the program's normal entry point (``served``: the configuration's
  ``served`` object);
- ``shapes(config)``: an object with ``vocab`` and ``window`` (0: none)
  and the work counts (``work.Work``) ``decode_step(contexts)``,
  ``prefill_chunk(start, n, last)``, ``decode_gemms(m)`` and
  ``chunk_gemms(n, last)``; counts come from shapes and the traffic
  served, never from which kernel ran;
- ``reference(config, model)``: ``logits(seqs, rows, bits=None)``, the
  plain float32 reference over the same seeded blocks (``check.gaps``): a
  function of ``reference/``, or a ``functools.partial`` of one over plain
  values and objects of this package's modules (:func:`reference` refuses
  anything else);
- optionally ``KERNEL_GROUPS``: (label, key) pairs that ``trace.group``
  tries after its own groups and before its fallbacks.

The system under test is the program's Server, driven through ``submit``
and ``step`` by closed-loop clients (``traffic.py``).  Set-up draws the
weights on the card from the seed, builds the Server, warms every step
shape the mix can reach (each prefill chunk length, and decode steps at
contexts from the mix's shortest prompt up to its longest context, capped
by the window), and runs the mix until ``lead_in_finished`` requests have
finished.  The window then runs whole ``step`` calls for ``--seconds``.  A
token's time is when the ``step`` call that produced it returned.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import traffic as traffic_mod

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "quant_gemm_tpu")
#: the share of the window after which a traced run starts its stretch,
#: and the seconds the stretch lasts at least
TRACE_AT, TRACE_SECONDS = 0.4, 2.0


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    arch: object  # the module archs/<config's arch>.py
    mix: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in reported


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files, found by
    name under ``root``."""
    bench = bench if bench is not None else spec(root.parent)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config_path = root / "configs" / f"{w['config']}.json"
    config = load_json(config_path)
    arch = architecture(config, config_path, root)
    mix = traffic_mod.load(w["traffic"], root)
    limits_path = root / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, arch, mix, limits, e2e, per)


def _load(path: Path, name: str):
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    # registered first, as an import would be: dataclasses look their
    # module up by name
    sys.modules[name] = mod
    sp.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}"


def architecture(config: dict, path: Path, root: Path = ROOT):
    """``archs/<arch>.py`` under ``root`` of the configuration file at
    ``path``, which names it under ``arch``."""
    if "arch" not in config:
        raise SystemExit(f"{path} names no architecture: it needs an "
                         f"\"arch\" key, the name of {root / 'archs'}"
                         "/<arch>.py")
    file = root / "archs" / f"{config['arch']}.py"
    if not file.is_file():
        raise SystemExit(f"{path} names the architecture "
                         f"{config['arch']!r}, and {file} does not exist")
    return _load(file, _module_name("arch", config["arch"]))


def reader(metric: str, root: Path = ROOT):
    """``metrics/<metric>.py``'s ``read``."""
    return _load(root / "metrics" / f"{metric}.py",
                 _module_name("metric", metric)).read


def reference(cell_: Cell, model):
    """The cell's plain reference: its architecture's ``reference(config,
    model)``, refused unless it is a function of ``reference/``, whose
    modules import nothing of the program, bound to nothing but plain
    values and objects of this package's modules, so that nothing the
    program made reaches it."""
    fn = cell_.arch.reference(cell_.config, model)
    inner, bound = fn, []
    while isinstance(inner, functools.partial):
        bound += [*inner.args, *inner.keywords.values()]
        inner = inner.func
    home = ROOT / "reference"
    code = getattr(inner, "__code__", None)
    if code is None or home not in Path(code.co_filename).resolve().parents:
        raise SystemExit(f"{cell_.name}: the reference of architecture "
                         f"{cell_.config['arch']!r} is {inner!r}, which is "
                         f"not a function of {home}")
    for value in bound:
        module = type(value).__module__
        if not (isinstance(value, (bool, int, float, str, type(None)))
                or module == "port_bench"
                or module.startswith("port_bench.")):
            raise SystemExit(f"{cell_.name}: the reference of architecture "
                             f"{cell_.config['arch']!r} is bound to a "
                             f"{module}.{type(value).__qualname__}, which "
                             "is neither a plain value nor of port_bench")
    return fn


# ---------------------------------------------------------------------------
# the served requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """A request as the benchmark saw it."""

    rid: int
    client: int
    prompt: list
    max_new: int
    submitted: float
    req: object  # the Server's Request
    times: list = dataclasses.field(default_factory=list)  # per token
    reuse: int = 0  # prompt tokens the Server took from a slot's cache
    admitted_step: int = -1

    @property
    def tokens(self) -> list:
        return self.req.generated


@dataclasses.dataclass
class Step:
    """One ``Server.step`` call."""

    t0: float
    t1: float
    traced: bool
    admitted: list  # Requests admitted in this call
    contexts: list  # tokens each decoded slot attended (window applied)


def _span(name: str):
    from torch.profiler import record_function

    return record_function(name)


class _no_span:
    def __init__(self, name: str):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Client:
    """A closed-loop client: the next turn or session as soon as its
    request finishes."""

    def __init__(self, idx: int, traffic: traffic_mod.Traffic):
        self.idx = idx
        self.traffic = traffic
        self.session = traffic.next_session()


class Loop:
    """The Server under the mix's clients, with the records the metrics
    read."""

    def __init__(self, server, mix: dict, traffic: traffic_mod.Traffic,
                 window: int):
        self.server = server
        self.mix = mix
        self.traffic = traffic
        self.window = window
        self.requests: dict = {}
        self.inflight: list = []
        self.steps: list = []
        self.finished = 0
        self.clients: list = []
        n = server.n_slots
        self._slot_hist: list = [[] for _ in range(n)]
        self._slot_rid: list = [None] * n
        self._cached = server.stats()["cached_prompt_tokens"]
        self.traced = False

    # -- requests ----------------------------------------------------------

    def submit(self, prompt: list, max_new: int, client: int = -1):
        rid = self.server.submit(prompt, max_new=max_new)
        req = self.server.queue[-1]
        if req.rid != rid:
            raise RuntimeError("the Server's queue does not end with the "
                               "request just submitted")
        r = Request(rid, client, list(prompt), max_new, time.perf_counter(),
                    req)
        self.requests[rid] = r
        self.inflight.append(r)
        return r

    def start_clients(self) -> None:
        for i in range(int(self.mix["clients"])):
            c = Client(i, self.traffic)
            self.clients.append(c)
            self._submit_turn(c)

    def _submit_turn(self, c: Client) -> None:
        s = c.session
        self.submit(s.prompt(self.traffic.vocab), s.max_new(), c.idx)

    # -- one step ----------------------------------------------------------

    def step(self) -> Step:
        span = _span if self.traced else _no_span
        t0 = time.perf_counter()
        with span("port_bench.step"):
            self.server.step()
        t1 = time.perf_counter()
        with span("port_bench.client"):
            return self._after(t0, t1)

    def _after(self, t0: float, t1: float) -> Step:
        admitted, contexts, done = [], [], []
        for r in self.inflight:
            n = len(r.tokens)
            new = n - len(r.times)
            if not new:
                continue
            first = not r.times
            r.times.extend([t1] * new)
            if first:
                r.admitted_step = len(self.steps)
                admitted.append(r)
            if n >= 2 and (not first or new >= 2):
                # the decode step fed token n - 2 at position len(prompt)
                # + n - 2 and attended it and everything before
                c = len(r.prompt) + n - 1
                contexts.append(min(c, self.window) if self.window else c)
            if r.req.done:
                done.append(r)
        self._reuse(admitted)
        st = Step(t0, t1, self.traced, admitted, contexts)
        self.steps.append(st)
        if done:
            self.inflight = [r for r in self.inflight if not r.req.done]
            for r in sorted(done, key=lambda r: r.client):
                self.finished += 1
                if r.client >= 0:
                    c = self.clients[r.client]
                    if not c.session.answered(r.prompt, r.tokens):
                        c.session = self.traffic.next_session()
                    self._submit_turn(c)
        return st

    def _reuse(self, admitted: list) -> None:
        """The prompt tokens each admitted request took from its slot's
        cache.  Their sum over a step is the Server's own count
        (``cached_prompt_tokens`` across the step); one request admitted
        alone takes it whole.  Where a step admits several, the count is
        split by where the Server puts each (a free slot whose cache holds
        the longest prefix of its prompt, the last prompt token always
        recomputed, less than a bucket not taken; the slot's earlier
        requests left that prefix there), and the run stops if that split
        does not add up to the Server's count."""
        srv = self.server
        if srv.cache_prompt and admitted:
            cached = srv.stats()["cached_prompt_tokens"]
            delta, self._cached = cached - self._cached, cached
        where = {r.rid: s for s, r in enumerate(srv.slots) if r is not None}
        for r in admitted:
            s = where.get(r.rid)
            if s is None:
                continue
            if srv.cache_prompt:
                hist = self._slot_hist[s]
                n = 0
                for a, b in zip(hist, r.prompt):
                    if a != b:
                        break
                    n += 1
                n = min(n, len(r.prompt) - 1)
                r.reuse = n if n >= srv.bucket else 0
            self._slot_rid[s] = r.rid
        if srv.cache_prompt and admitted:
            if len(admitted) == 1:
                admitted[0].reuse = delta
            elif sum(r.reuse for r in admitted) != delta:
                raise RuntimeError(
                    f"prompt reuse: the Server took {delta} prompt tokens "
                    f"from slot caches in one step, the benchmark's split "
                    f"over its {len(admitted)} admissions adds up to "
                    f"{sum(r.reuse for r in admitted)}")
        for s, rid in enumerate(self._slot_rid):
            r = self.requests.get(rid)
            if r is not None and r.req.done:
                # what the slot's cache holds from position 0: the prompt
                # and every generated token fed back (all but the last)
                self._slot_hist[s] = r.prompt + list(r.tokens[:-1])
                self._slot_rid[s] = None

    def run_until(self, stop) -> None:
        while not stop():
            self.step()


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


def warm(loop: Loop, mix: dict, vocab: int, seed: int, window: int):
    """Run every step shape the mix can reach once, a request at a time:
    a prompt of each prefill chunk length, and decode steps at contexts
    from the shortest first prompt of the mix's pool to its longest
    context (capped by the window), doubling."""
    srv = loop.server
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 99])
    lengths = list(range(srv.bucket, srv.max_chunk + 1, srv.bucket))
    lo, hi = traffic_mod.extent(mix)
    if window:
        hi = min(hi, window)
    ctx = [lo]
    while ctx[-1] * 2 < hi:
        ctx.append(2 ** math.ceil(math.log2(ctx[-1] + 1)))
    if hi > ctx[-1]:
        ctx.append(hi)
    for n in lengths + ctx:
        loop.submit(rng.integers(0, vocab, n).tolist(), 3)
        loop.run_until(lambda: not loop.inflight)
    return {"chunks": lengths, "contexts": ctx}


def copy_probe(device) -> float:
    """GB/s of a 1 GiB device-to-device copy (read and write counted),
    best of 5, by CUDA events."""
    import torch

    n = 1 << 30
    src = torch.empty(n, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = float("inf")
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    del src, dst
    return 2 * n / best / 1e9


def card_info() -> dict:
    import subprocess

    import torch

    out = {"name": torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = q.stdout.strip().splitlines()[0] \
            if q.stdout.strip() else q.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: Cell
    shapes: object  # the architecture's shapes(config): the work counts
    seed: int
    setup_s: float
    t_open: float
    t_close: float
    steps: list  # the window's Step records
    requests: dict  # every Request by id
    stats_open: dict
    stats_close: dict
    stats_trace: Optional[tuple]  # Server.stats() at the stretch's ends
    trace: Optional[object]  # trace.Stretch of a traced run
    max_chunk: int
    info: dict
    trace_steps: list  # the Step records of the traced stretch kept

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def steps_by_end(self) -> dict:
        """The window's Step records by the time their call returned (a
        token's time)."""
        return {s.t1: s for s in self.steps}

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close

    def untraced(self, key: str) -> float:
        """A Server.stats() seconds counter over the window, less the
        traced stretch."""
        v = self.stats_close[key] - self.stats_open[key]
        if self.stats_trace:
            a, b = self.stats_trace
            v -= b[key] - a[key]
        return v

    def chunks(self, r: Request) -> list:
        """(start, tokens, last) of each prefill chunk of ``r``."""
        out, off, n = [], r.reuse, len(r.prompt)
        while off < n:
            k = min(self.max_chunk, n - off)
            out.append((off, k, off + k == n))
            off += k
        return out


def serve(cell_: Cell, seed: int, seconds: float, traced: bool, device,
          t_start: float) -> tuple:
    """Set up, run the window; returns (Run, the weights' model, the
    Server's state to free)."""
    import torch

    from . import trace as trace_mod

    config, mix, arch = cell_.config, cell_.mix, cell_.arch
    phases, t = {}, t_start

    def phase(name):
        nonlocal t
        now = time.perf_counter()
        phases[name] = round(now - t, 3)
        t = now

    info = {"setup_phases_s": phases}
    phase("start")
    model, params, program_config = arch.program(config, seed, device)
    phase("weights")
    server = arch.server(params, program_config, config["served"], device)
    sh = arch.shapes(config)
    tr = traffic_mod.Traffic(mix, seed, sh.vocab)
    loop = Loop(server, mix, tr, sh.window)
    phase("server")
    info["warmed"] = warm(loop, mix, sh.vocab, seed, sh.window)
    graphs_warm = len(server.graphs)
    phase("warm")
    stretch = trace_mod.Stretch(
        device, getattr(arch, "KERNEL_GROUPS", ())) if traced else None
    phase("profiler")
    loop.start_clients()
    lead = int(mix["lead_in_finished"])
    done0 = loop.finished
    loop.run_until(lambda: loop.finished - done0 >= lead)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phase("lead-in")
    first = len(loop.steps)
    stats_open = server.stats()
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    trace_at = t_open + TRACE_AT * seconds
    stats_trace = None
    while True:
        if stretch is not None and not stretch.started \
                and time.perf_counter() >= trace_at:
            a = server.stats()
            stretch.start()
            loop.traced = True
        st = loop.step()
        if stretch is not None and stretch.running \
                and st.t1 - stretch.t_host0 >= TRACE_SECONDS:
            stretch.stop()
            loop.traced = False
            stats_trace = (a, server.stats())
        if st.t1 - t_open >= seconds and not (stretch and stretch.running):
            break
    last = len(loop.steps)
    t_close = loop.steps[-1].t1
    stats_close = server.stats()
    trace_steps = []
    if stretch is not None:
        trace_steps = [st for st in loop.steps[first:] if st.traced]
        trace_steps = _read_stretch(loop, stretch, trace_steps, info)
    info["graphs_captured_in_window"] = len(server.graphs) - graphs_warm
    info["reuse_counted"] = sum(r.reuse for r in loop.requests.values()
                                if first <= r.admitted_step < last)
    info["reuse_by_server"] = (stats_close["cached_prompt_tokens"]
                               - stats_open["cached_prompt_tokens"])
    run = Run(cell_, sh, seed, setup_s, t_open, t_close,
              loop.steps[first:last], loop.requests, stats_open,
              stats_close, stats_trace, stretch, server.max_chunk, info,
              trace_steps)
    return run, model, (server, params, loop)


def _read_stretch(loop: Loop, stretch, steps: list, info: dict) -> list:
    """Read the traced stretch; where the profiler dropped the whole lead
    graph (and so maybe the stretch's first kernels too), take another
    stretch of :data:`TRACE_SECONDS` after the window, up to
    ``trace.LEAD_TRIES`` in all, and raise if none kept any of its lead.
    Returns the Step records of the stretch that was kept."""
    from . import trace as trace_mod

    stretch.read()
    tries = 1
    while stretch.lead_lost == trace_mod.LEAD_KERNELS:
        if tries == trace_mod.LEAD_TRIES:
            raise RuntimeError(
                f"the profiler dropped all {trace_mod.LEAD_KERNELS} lead "
                f"kernels in each of {tries} traced stretches")
        log(f"trace: stretch {tries} lost all {trace_mod.LEAD_KERNELS} "
            "lead kernels; taking another after the window")
        tries += 1
        n0 = len(loop.steps)
        stretch.start()
        loop.traced = True
        while loop.step().t1 - stretch.t_host0 < TRACE_SECONDS:
            pass
        stretch.stop()
        loop.traced = False
        stretch.read()
        steps = loop.steps[n0:]
    info["stretches"] = tries
    return steps


def metrics(run: Run, traced: bool) -> dict:
    """The cell's metrics of this run: its end-to-end ones untraced, its
    per-layer ones traced; a reader that finds nothing is left out."""
    out = {}
    for m in (run.cell.per_layer if traced else run.cell.end_to_end):
        v = reader(m["name"])(run)
        if v is None:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def failed(run: Run) -> tuple:
    """(attempted, failed): the clients' requests in flight at some time
    of the window, and of those the ones that finished short of their
    ``max_new``."""
    att = fail = 0
    for r in run.requests.values():
        end = r.times[-1] if r.req.done else math.inf
        if r.client < 0 or r.submitted > run.t_close or end <= run.t_open:
            continue
        att += 1
        if r.req.done and len(r.tokens) < r.max_new:
            fail += 1
    return att, fail


__all__ = ["Cell", "cell", "architecture", "reader", "spec", "Request",
           "Step", "Loop", "warm",
           "copy_probe", "card_info", "forbidden_modules", "Run", "serve",
           "metrics", "failed", "FORBIDDEN", "log"]
