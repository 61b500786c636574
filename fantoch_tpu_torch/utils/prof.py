"""Function-latency profiling: the fantoch_prof analog.

The port of fantoch_tpu/utils/prof.py; its hot paths are the port's
classes.

Reference: fantoch_prof/src/lib.rs:78-186 — a tracing Subscriber that
turns span enter/exit into per-function latency histograms, printed
periodically by the tracer task (fantoch/src/run/task/tracer.rs:16-44).

Here the span surface is explicit: wrap hot functions with ``@profiled``
or time a region with ``elapsed("name")``; latencies land in a ``Metrics``
histogram registry keyed by name (microseconds).  The runner's
tracer task (``ProcessRuntime`` with ``tracer_show_interval_ms``) prints
``snapshot()`` on an interval.  For device work, prefer
``torch.profiler.record_function`` (wired in executor/graph/batched.py) —
this module covers the host side.

Registry scoping: the registry is a *contextvar*, defaulting to one
process-global ``Metrics``.  A runner that wants its samples isolated
(several ``ProcessRuntime``s share one Python process in the localhost
harness — a module global would blend their latencies) calls
``set_registry(Metrics())`` before spawning its tasks: every task created
afterwards snapshots that context and records into the runner's own
registry, while other runners (and the default scope) stay untouched.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
import time
from typing import Callable, Dict, Iterator, Optional

from fantoch_tpu_torch.core.metrics import Histogram, Metrics

_default_metrics: Metrics = Metrics()
_registry: "contextvars.ContextVar[Metrics]" = contextvars.ContextVar(
    "fantoch_prof_registry", default=_default_metrics
)
_lock = threading.Lock()


def get_registry() -> Metrics:
    """The registry of the current context (the process-global default
    unless a runner installed its own)."""
    return _registry.get()


def set_registry(metrics: Optional[Metrics] = None) -> Metrics:
    """Install ``metrics`` (or a fresh ``Metrics``) as the current
    context's registry; returns it.  Tasks spawned after this call record
    into it (asyncio tasks snapshot the context at creation)."""
    metrics = metrics if metrics is not None else Metrics()
    _registry.set(metrics)
    return metrics


@contextlib.contextmanager
def scoped_registry(metrics: Optional[Metrics] = None) -> Iterator[Metrics]:
    """Context manager: a private registry for the enclosed region."""
    metrics = metrics if metrics is not None else Metrics()
    token = _registry.set(metrics)
    try:
        yield metrics
    finally:
        _registry.reset(token)


@contextlib.contextmanager
def elapsed(name: str) -> Iterator[None]:
    """Time a region into the current registry's histogram for `name`
    (microseconds)."""
    start = time.perf_counter()
    try:
        yield
    finally:
        micros = int((time.perf_counter() - start) * 1e6)
        with _lock:
            _registry.get().collect(name, micros)


def profiled(fn: Callable) -> Callable:
    """Decorator: record every call's latency under the function's name."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with elapsed(name):
            return fn(*args, **kwargs)

    return wrapper


# --- auto-instrumentation (the span-subscriber analog) ---------------------
#
# The reference annotates hot functions with #[instrument] and the
# ProfSubscriber aggregates every span automatically
# (fantoch_prof/src/lib.rs:78-136).  Python's analog: install wrappers
# over the framework's hot-path methods at runtime — no call-site edits,
# one switch to turn the tripwire on.

# (class path, method) pairs covering the reference's instrumented set
# (fantoch's #[instrument] spans sit on the protocol handlers and the
# executor entry points)
_HOT_PATHS = [
    ("fantoch_tpu_torch.protocol.base:Protocol", ("submit", "handle", "handle_event")),
    ("fantoch_tpu_torch.executor.base:Executor", ("handle", "handle_batch")),
    (
        "fantoch_tpu_torch.executor.graph.deps_graph:DependencyGraph",
        ("handle_add", "commands_to_execute"),
    ),
]
_instrumented: list = []


def _wrap_method(cls, name: str) -> None:
    fn = cls.__dict__.get(name)
    if fn is None or getattr(fn, "_prof_wrapped", False):
        return
    wrapped = profiled(fn)
    wrapped._prof_wrapped = True  # type: ignore[attr-defined]
    setattr(cls, name, wrapped)
    _instrumented.append((cls, name, fn))


def auto_instrument(extra: Iterator = ()) -> int:
    """Install latency spans over the framework's hot paths (and any
    ``extra`` (cls, method-names) pairs): every subclass handler inherits
    the span through the base class unless it overrides the method, in
    which case the override is wrapped too.  Returns the number of
    methods instrumented; ``uninstrument()`` restores them."""
    import importlib

    count = 0
    specs = list(_HOT_PATHS)
    for spec in specs:
        path, methods = spec
        module_name, cls_name = path.split(":")
        cls = getattr(importlib.import_module(module_name), cls_name)
        targets = [cls] + [c for c in _all_subclasses(cls)]
        for target in targets:
            for method in methods:
                before = len(_instrumented)
                _wrap_method(target, method)
                count += len(_instrumented) - before
    for cls, methods in extra:
        for method in methods:
            before = len(_instrumented)
            _wrap_method(cls, method)
            count += len(_instrumented) - before
    return count


def _all_subclasses(cls) -> set:
    out = set()
    for sub in cls.__subclasses__():
        out.add(sub)
        out |= _all_subclasses(sub)
    return out


def uninstrument() -> None:
    """Undo auto_instrument (restores the original methods)."""
    while _instrumented:
        cls, name, fn = _instrumented.pop()
        setattr(cls, name, fn)


def snapshot() -> Dict[str, Histogram]:
    """Copy of the current registry's histograms (name -> Histogram)."""
    with _lock:
        out: Metrics = Metrics()
        out.merge(_registry.get())
        return dict(out.collected)


def reset() -> None:
    """Clear the current registry in place (in place, not a rebind: tasks
    that captured this registry at spawn keep recording into it)."""
    with _lock:
        reg = _registry.get()
        reg.collected.clear()
        reg.aggregated.clear()


def format_snapshot() -> str:
    """One line per profiled function (tracer.rs:16-44 output analog)."""
    lines = []
    for name, hist in sorted(snapshot().items()):
        lines.append(
            f"{name}: n={hist.count} mean={hist.mean():.0f}us "
            f"p95={hist.percentile(0.95):.0f}us p99={hist.percentile(0.99):.0f}us"
        )
    return "\n".join(lines)
