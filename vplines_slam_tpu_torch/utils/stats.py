"""Host stage timers, the periodic statistics stream and device-time spans.

Port of ``vplines_slam_tpu/utils/stats.py`` (``TicToc``, ``StageTimers``,
``Statistics``: the reference's tic_toc.h timers and printStatistics dump),
plus ``DeviceSpans``: CUDA-event spans by name around device work.  Device
work is asynchronous, so a host timer measures the enqueue (and any
blocking transfer) of its stage; a span measures the device time between its
two events.  The frame loops open a span per stage (``frontend``,
``line_frontend``, ``track_step`` or ``vio``) and every kernel launch one
under its kernel's name.  Spans are off unless ``SPANS.start()`` was called,
and then cost two event records each.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Optional

import numpy as np
import torch


class TicToc:
    """Wall-clock ms since construction/tic."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


class StageTimers:
    """Named per-frame stage timers with running means."""

    def __init__(self):
        self.last: dict = {}
        self._sum: dict = {}
        self._n: dict = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.last[name] = ms
            self._sum[name] = self._sum.get(name, 0.0) + ms
            self._n[name] = self._n.get(name, 0) + 1

    def mean(self, name: str) -> float:
        n = self._n.get(name, 0)
        return self._sum.get(name, 0.0) / n if n else 0.0


class Statistics:
    """printStatistics-style running summary: frames, keyframes, loops, path
    length, BA cost and the stage-timer means."""

    def __init__(self, print_every: int = 0, stream=None):
        self.print_every = print_every
        self.stream = stream if stream is not None else sys.stderr
        self.frames = 0
        self.keyframes = 0
        self.loops = 0
        self.path_length = 0.0
        self._last_p = None
        self.last_cost = float("nan")
        self._cost_sum = 0.0
        self._cost_n = 0
        self.timers = StageTimers()

    def update(self, p, is_keyframe: bool, loop_closed: bool, ba_cost=None):
        self.frames += 1
        if is_keyframe:
            self.keyframes += 1
        if loop_closed:
            self.loops += 1
        p = np.asarray(p, float)
        if self._last_p is not None:
            self.path_length += float(np.linalg.norm(p - self._last_p))
        self._last_p = p
        if ba_cost is not None:
            self.last_cost = float(ba_cost)
            self._cost_sum += self.last_cost
            self._cost_n += 1

    def summary(self, p_ic=None, q_ic=None, td: Optional[float] = None) -> str:
        t = self.timers
        stages = " ".join(f"{k}={t.mean(k):.1f}ms" for k in sorted(t._sum.keys()))
        parts = [f"frames={self.frames} kf={self.keyframes} loops={self.loops}",
                 f"path={self.path_length:.2f}m"]
        if self._cost_n:
            parts.append(f"cost last={self.last_cost:.3e} "
                         f"mean={self._cost_sum / self._cost_n:.3e}")
        if p_ic is not None:
            parts.append("p_ic=" + np.array2string(np.asarray(p_ic, float), precision=4,
                                                   separator=","))
        if q_ic is not None:
            parts.append("q_ic=" + np.array2string(np.asarray(q_ic, float), precision=4,
                                                   separator=","))
        if td is not None:
            parts.append(f"td={td * 1e3:.2f}ms")
        if stages:
            parts.append(stages)
        return "[vplines] " + "  ".join(parts)

    def maybe_print(self, p_ic=None, q_ic=None, td=None):
        if self.print_every and self.frames % self.print_every == 0:
            print(self.summary(p_ic=p_ic, q_ic=q_ic, td=td), file=self.stream)


class DeviceSpans:
    """Named CUDA-event spans, grouped by frame.  Off by default, and ``span``
    and ``next_frame`` are then no-ops; between ``start()`` and ``stop()``
    each span records a CUDA event on the current stream at its start and at
    its end, and each ``next_frame()`` (called by the frame loops at a
    frame's start) opens a new group."""

    def __init__(self):
        self.enabled = False
        self.frames: list = []  # per frame: list of (name, start, end)

    def start(self):
        """Drop the spans of any earlier session and record from here on."""
        self.frames = []
        self.enabled = True

    def stop(self):
        self.enabled = False

    def next_frame(self):
        if self.enabled:
            self.frames.append([])

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            if not self.frames:
                self.frames.append([])
            self.frames[-1].append((name, a, b))

    def per_frame_ms(self):
        """Synchronize and return, per frame, {name: summed device ms}."""
        torch.cuda.synchronize()
        out = []
        for spans in self.frames:
            d: dict = {}
            for name, a, b in spans:
                d[name] = d.get(name, 0.0) + a.elapsed_time(b)
            out.append(d)
        return out


SPANS = DeviceSpans()
