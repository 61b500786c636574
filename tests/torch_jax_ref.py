"""The reference-call fixture shared by the port's parity tests.

Import ``jax_ref`` into a test module and name it as a test's argument:
the JAX package's calls in that test then run with jax's duration
listeners wrapped to drop keyword arguments they do not take (a listener
registered by ``subscribe_recompiles`` takes none, and jax 0.9 passes
``fun_name=``; ROADMAP.md Queue C) and with the persistent compile cache
off.  Both are restored after the test.
"""

import inspect

import jax
import pytest
from jax._src import compilation_cache as jax_cache
from jax._src import monitoring as jax_monitoring


def _tolerant(listener):
    """``listener`` called with only the keyword arguments it accepts."""
    try:
        params = inspect.signature(listener).parameters
    except (TypeError, ValueError):
        return listener
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return listener
    names = set(params)

    def call(event, duration, **kwargs):
        return listener(
            event, duration, **{k: v for k, v in kwargs.items() if k in names}
        )

    return call


@pytest.fixture
def jax_ref(monkeypatch):
    monkeypatch.setattr(
        jax_monitoring,
        "_event_duration_secs_listeners",
        [_tolerant(f) for f in jax_monitoring._event_duration_secs_listeners],
    )
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jax_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        jax_cache.reset_cache()
