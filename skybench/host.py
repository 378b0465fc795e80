"""Where this process's CPU went while a window ran: each thread's CPU
seconds, read from ``/proc/self/task`` (nothing is set)."""

from __future__ import annotations

import os
import threading

_TICK = os.sysconf("SC_CLK_TCK")


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def threads() -> dict[int, tuple[str, float]]:
    """Each thread of this process: its name (the Python thread's, else
    the kernel's) and its CPU seconds so far."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in map(int, tids):
        stat = _read(f"/proc/self/task/{tid}/stat")
        if stat is None:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        cpu = (int(fields[11]) + int(fields[12])) / _TICK
        name = names.get(tid) or (_read(f"/proc/self/task/{tid}/comm")
                                  or "?").strip()
        out[tid] = (name, cpu)
    return out


def by_thread(before: dict, after: dict, top: int = 8) -> list:
    """The threads that used the most CPU between two ``threads()``
    readings: [name, seconds], with the rest summed by name."""
    used: dict[str, float] = {}
    for tid, (name, cpu) in after.items():
        base = before.get(tid, (name, 0.0))[1]
        key = name.rstrip("0123456789") or name
        used[key] = used.get(key, 0.0) + cpu - base
    ranked = sorted(used.items(), key=lambda kv: -kv[1])
    return [[n, round(s, 3)] for n, s in ranked[:top]]
