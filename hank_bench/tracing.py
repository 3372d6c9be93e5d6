"""Tracing a window with torch.profiler: the card's operations alone
(CUPTI activity; host-side operator events would double the host's time,
and even CUPTI adds some per launch, so host times come from an untraced
window), the window's edges set by two marker kernels on the card, and
the benchmark's host spans moved onto the trace's clock by the first
marker: the union of device activity, and the idle gaps by the host span
open during each.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def profile(device):
    """Trace the card's activity over the block (on a machine without one,
    the host's); yields the profiler."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if on_card
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def mark(device) -> float:
    """The host clock at the launch of a marker kernel (torch.cuda._sleep's)
    on the idle card; on the CPU, the host clock alone."""
    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda._sleep(1)
    return t


def _events(prof):
    """(name, start_ns, end_ns) of every operation traced on the card, read
    from the profiler's raw results (building its `events()` list takes
    longer)."""
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns()
            yield e.name(), start, start + e.duration_ns()


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """One traced window, from the first marker's start to the second's
    end: the profiler starts on an idle card, and nothing follows the second
    marker, so they are the first and the last operations traced. Times are
    in ns on the profiler's clock; `spans` are the host spans (name, start,
    end) on the perf_counter clock, and `t0`, `t1` the host clock at the
    markers' launches."""

    def __init__(self, prof, spans, t0: float, t1: float):
        ops = sorted(_events(prof), key=lambda op: op[1])
        if len(ops) >= 2:
            (_, self.start, _), (_, _, self.end) = ops[0], ops[-1]
            ops = ops[1:-1]
        elif not ops:                # nothing ran on a card: the host's clock
            self.start, self.end = round(t0 * 1e9), round(t1 * 1e9)
        else:
            raise RuntimeError("the trace holds one operation, not the window's two markers")
        offset = self.start - t0 * 1e9
        self.spans = [(n, round(s * 1e9 + offset), round(e * 1e9 + offset))
                      for n, s, e in spans if t0 <= s and e <= t1]
        self.ops = [(n, max(s, self.start), min(e, self.end)) for n, s, e in ops
                    if e > self.start and s < self.end]
        self.busy = merge((s, e) for _, s, e in self.ops)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def kernel(self, match) -> tuple[int, float]:
        """(launches, device seconds) of the operations whose name `match`
        accepts."""
        hits = [e - s for n, s, e in self.ops if match(n)]
        return len(hits), sum(hits) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the operations that took most time, summed by name."""
        total = {}
        for n, s, e in self.ops:
            total[n] = total.get(n, 0) + (e - s)
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[host span, seconds] of the longest stretches with nothing on the
        card, each named by the innermost benchmark span open at its middle."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:top]:
            mid = (s + e) // 2
            open_ = [(ss, -ee, n) for n, ss, ee in self.spans if ss <= mid <= ee]
            out.append([max(open_)[2] if open_ else "between requests", length * 1e-9])
        return out


def kernel_matcher(base: str, targs: tuple | None = None):
    """A test of a device operation's name for one kernel: its base name and,
    for a template, its arguments ("double", "float", "true", "false"), in
    the demangled form or the mangled one."""
    mangled = {"double": "d", "float": "f", "true": "Lb1E", "false": "Lb0E"}
    if targs is None:
        forms = (f"{base}(", f"{base}E")
    else:
        forms = (f"{base}<{','.join(targs)}>",
                 f"{base}I{''.join(mangled[a] for a in targs)}E")

    def match(name: str) -> bool:
        n = name.replace(" ", "")
        return any(f in n for f in forms)

    return match
