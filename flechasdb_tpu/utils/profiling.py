"""Profiling helpers.

The reference's observability is event callbacks timed by callers
(SURVEY.md §5); on an accelerator the device timeline matters too, so these wrappers
pair the event API with ``jax.profiler``: wrap a build or query-serving
region in :func:`trace` and inspect the dump with TensorBoard/XProf, or
scope individual phases with :func:`annotate` so they show up as named
ranges on the device timeline.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def trace(logdir: str):
    """Captures a ``jax.profiler`` trace of the enclosed region."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def annotate(name: str):
    """Names the enclosed region on the profiler timeline."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
