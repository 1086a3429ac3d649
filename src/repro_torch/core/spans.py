"""Profiler spans over the program's phases.

``span(name)`` enters ``torch.profiler.record_function(name)`` while a
profiler records, and is otherwise one shared no-op context: with no
profiler a span costs one check and creates no ``RecordFunction``.  There
is no switch: the spans show in any ``torch.profiler.profile``.

The spans (all ``quegel.*``, nested under their round): ``round``
(``SlotRuntime.run_round``), ``admit``, ``step`` and ``sync``
(``QuegelEngine.slot_round``), ``gate`` and ``kernel`` (a tile plan's
``propagate``), ``collect`` and ``retire`` (the runtime's retirement).
"""
from __future__ import annotations

import contextlib

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
