"""Profiling hooks: optional ``torch.profiler`` integration for the serving
stack.

``annotate(name)`` wraps a host-side region in a
``torch.profiler.record_function`` scope while a profile runs: the engine
uses it around its ``paged_mixed_step`` / ``paged_sample_step`` /
``paged_verify_accept_step`` dispatches so the trace's kernels line up
with named host regions. When no profile is active the call returns a
shared reusable null context, so the hot loop pays one function call and a
flag check per dispatch, and a profiler that a caller runs on its own sees
no annotation at all.

``start(dir)`` / ``stop()`` bracket a ``torch.profiler`` trace of the host
and, where there is one, the card, written into ``dir`` by
``tensorboard_trace_handler`` (a ``*.pt.trace.json`` Chrome trace that
Perfetto and TensorBoard load); ``profile(dir)`` is the context-manager
form and a no-op when ``dir`` is falsy, which is how the launcher wires
its ``--jax-profile <dir>`` flag (the reference's name, so that one argv
drives both launchers):

    with profiling.profile(args.jax_profile):
        engine.generate(...)
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["annotate", "start", "stop", "profile", "active"]

_active = False
_prof = None
_NULL_CTX = contextlib.nullcontext()


def active() -> bool:
    return _active


def annotate(name: str):
    """``record_function`` scope when a profile is running, else a shared
    null context (reentrant and reusable, safe to hand out every call)."""
    if not _active:
        return _NULL_CTX
    return torch.profiler.record_function(name)


def start(log_dir: str) -> None:
    """Start a trace into ``log_dir`` and turn annotations on."""
    global _active, _prof
    assert not _active, "a profile is already running"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _prof.start()
    _active = True


def stop() -> None:
    """Stop the trace and write it (a no-op when none runs)."""
    global _active, _prof
    if not _active:
        return
    _active = False
    prof, _prof = _prof, None
    prof.stop()


@contextlib.contextmanager
def profile(log_dir: Optional[str]):
    """Bracket a region with a trace when ``log_dir`` is set; a
    transparent no-op otherwise."""
    if not log_dir:
        yield
        return
    start(log_dir)
    try:
        yield
    finally:
        stop()
