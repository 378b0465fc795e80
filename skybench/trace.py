"""The device's side of a traced run, from ``torch.profiler``.

The profiler records the card's activity (kernels, copies, fills) from
the window's open until the last query sent in it has answered. From it
come the device's busy time (the union of every activity's interval),
over the window and over the whole of that span, the time of each
kernel by name and the gaps in which the card ran nothing in the window,
each named by what the clients' queries were doing then.
"""

from __future__ import annotations

import time

# a gap shorter than this is launch spacing, not idleness worth naming
GAP_S = 0.001


class DeviceTrace:
    """Profile the card from ``start()`` to ``stop()``; ``close_window()``
    marks the window's close in between."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None
        self.events: list[tuple[str, float, float]] = []  # name, start, end
        self.host_t0 = self.dev_t0 = None
        self.window_s = 0.0
        # the window and the drain after it: until every query sent answered
        self.span_s = 0.0

    def start(self) -> None:
        torch = self.torch
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA])
        self.prof.__enter__()
        # a marker fill at a known host time ties the two clocks together
        self._marker = torch.empty(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.host_t0 = time.perf_counter()
        self._marker.fill_(1.0)
        torch.cuda.synchronize(self.device)

    def close_window(self) -> None:
        self.window_s = time.perf_counter() - self.host_t0

    def stop(self) -> None:
        self.span_s = time.perf_counter() - self.host_t0
        if not self.window_s:
            self.window_s = self.span_s
        self.prof.__exit__(None, None, None)
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if "cuda" not in str(e.device_type()).lower():
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            evs.append((e.name(), s, s + d))
        evs.sort(key=lambda x: x[1])
        self.prof = None
        # the marker is the first fill the window made
        fills = [s for n, s, _ in evs if "fill" in n.lower()]
        self.dev_t0 = fills[0] if fills else (evs[0][1] if evs else 0.0)
        end = self.dev_t0 + self.span_s
        self.events = [(n, max(s, self.dev_t0), min(t, end))
                       for n, s, t in evs if t > self.dev_t0 and s < end]

    def host_time(self, dev_s: float) -> float:
        return self.host_t0 + (dev_s - self.dev_t0)

    def _in(self, whole: bool) -> list[tuple[str, float, float]]:
        """The activities of the window, or of the whole span."""
        if whole:
            return self.events
        end = self.dev_t0 + self.window_s
        return [(n, s, min(t, end)) for n, s, t in self.events if s < end]

    def busy_intervals(self, whole: bool = False) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, s, t in self._in(whole):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self, whole: bool = False) -> float:
        """Seconds in which the card ran anything: in the window, or
        (``whole``) until the last query sent in it answered."""
        return sum(t - s for s, t in self.busy_intervals(whole))

    def kernel_seconds(self) -> dict[str, tuple[float, int]]:
        """Each activity's name → (seconds in the window, how many were
        recorded)."""
        out: dict[str, list] = {}
        for n, s, t in self._in(False):
            v = out.setdefault(n, [0.0, 0])
            v[0] += t - s
            v[1] += 1
        return {n: (v[0], v[1]) for n, v in out.items()}

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the window, in device time, longest first."""
        cur, end = self.dev_t0, self.dev_t0 + self.window_s
        out = []
        for s, t in self.busy_intervals() + [(end, end)]:
            if s - cur >= GAP_S:
                out.append((cur, s))
            cur = max(cur, t)
        return sorted(out, key=lambda g: g[0] - g[1])
