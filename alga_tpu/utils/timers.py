"""Phase timers + run statistics (ref: src/Utils/TimeMeasurer.cpp,
src/StatisticsGenerators/*).  Wall-clock (the reference uses clock() which
over-counts under threads — SURVEY.md §5); metrics collected into a dict
and emitted as one JSON blob."""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._starts: dict[str, float] = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    @contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            dt = self.stop(name)
            print(f"[timer] {name}: {dt:.3f}s", file=sys.stderr)
            # memory watermark between phases (ref main.cpp samples
            # process_mem_usage after every major stage)
            sample_memory(name)

    def report(self) -> dict:
        return dict(sorted(self.totals.items(), key=lambda kv: -kv[1]))


def contig_stats(lengths: list[int]) -> dict:
    """N50-style summary (ref StatisticsGenerator::writeAllStatistics +
    standard assembly metrics)."""
    if not lengths:
        return {"count": 0, "total": 0, "max": 0, "n50": 0, "avg": 0.0}
    ls = sorted(lengths, reverse=True)
    total = sum(ls)
    acc = 0
    n50 = 0
    for x in ls:
        acc += x
        if acc * 2 >= total:
            n50 = x
            break
    return {
        "count": len(ls),
        "total": total,
        "max": ls[0],
        "min": ls[-1],
        "avg": total / len(ls),
        "n50": n50,
    }


def emit_metrics(metrics: dict, stream=sys.stderr) -> None:
    print(json.dumps(metrics, default=float), file=stream)


# ---------------------------------------------------------------------------
# memory watermarks (ref MyUtils::process_mem_usage, MyUtils.cpp:81-104:
# VM/RSS sampled from /proc between every major phase)

_PEAK = {"rss_mb": 0.0, "vm_mb": 0.0, "device_mb": 0.0}


def sample_memory(tag: str = "", stream=sys.stderr, log: bool = True) -> dict:
    """RSS/VM from /proc/self/status + device memory when the accelerator
    backend exposes memory_stats(); tracks process-wide peaks."""
    rss_mb = vm_mb = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss_mb = int(line.split()[1]) / 1024.0
                elif line.startswith("VmSize:"):
                    vm_mb = int(line.split()[1]) / 1024.0
    except OSError:
        pass
    device_mb = 0.0
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            device_mb = stats.get("bytes_in_use", 0) / 1e6
        if not device_mb:
            # backends without memory_stats: account live device buffers
            # ourselves so device memory is still observed
            device_mb = sum(int(a.nbytes) for a in jax.live_arrays()) / 1e6
    except Exception:
        pass
    _PEAK["rss_mb"] = max(_PEAK["rss_mb"], rss_mb)
    _PEAK["vm_mb"] = max(_PEAK["vm_mb"], vm_mb)
    _PEAK["device_mb"] = max(_PEAK["device_mb"], device_mb)
    out = {"rss_mb": round(rss_mb, 1), "vm_mb": round(vm_mb, 1),
           "device_mb": round(device_mb, 1)}
    if log:
        print(f"[mem]{' ' + tag if tag else ''} rss={out['rss_mb']}MB "
              f"vm={out['vm_mb']}MB device={out['device_mb']}MB",
              file=stream)
    return out


def memory_peaks() -> dict:
    out = {k: round(v, 1) for k, v in _PEAK.items()}
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats()
        if stats and "peak_bytes_in_use" in stats:
            out["device_peak_bytes"] = int(stats["peak_bytes_in_use"])
    except Exception:
        pass
    return out


# ---------------------------------------------------------------------------
# hot-loop counters (ref GCPS.h:111-118 GATHER_STATISTICS atomics and
# ACHybrid.h:31-36 alignment counters — psum'd counter dicts here)

COUNTERS: dict[str, int] = {}


def bump(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + int(n)


def counters_report() -> dict:
    return dict(sorted(COUNTERS.items()))


def reset_counters() -> None:
    COUNTERS.clear()


# ---------------------------------------------------------------------------
# progress reporting (ref MyUtils::writeProgress, MyUtils.h:68-86:
# carriage-return percent bars on cerr)

def write_progress(done: int, total: int, label: str,
                   stream=sys.stderr) -> None:
    if total <= 0:
        return
    pct = 100 * done // total
    prev = 100 * (done - 1) // total if done else -1
    if pct != prev or done >= total:
        end = "\n" if done >= total else ""
        print(f"\r[{label}] {pct}% ({done}/{total})", file=stream,
              end=end, flush=True)


# ---------------------------------------------------------------------------
# streaming moment accumulators
# (ref StatisticsGeneratorBigData.h:15-78: per-key n/sum/sumsq/min/max)

class StreamingStats:
    def __init__(self):
        self._acc: dict[str, list] = {}

    def add(self, key: str, value: float) -> None:
        a = self._acc.get(key)
        if a is None:
            self._acc[key] = [1, value, value * value, value, value]
        else:
            a[0] += 1
            a[1] += value
            a[2] += value * value
            if value < a[3]:
                a[3] = value
            if value > a[4]:
                a[4] = value

    def add_array(self, key: str, values) -> None:
        import numpy as _np
        v = _np.asarray(values, dtype=_np.float64)
        if len(v) == 0:
            return
        a = self._acc.setdefault(key, [0, 0.0, 0.0, float("inf"),
                                       float("-inf")])
        a[0] += len(v)
        a[1] += float(v.sum())
        a[2] += float((v * v).sum())
        a[3] = min(a[3], float(v.min()))
        a[4] = max(a[4], float(v.max()))

    def report(self) -> dict:
        out = {}
        for k, (n, s, sq, mn, mx) in sorted(self._acc.items()):
            mean = s / n
            var = max(0.0, sq / n - mean * mean)
            out[k] = {"n": n, "mean": round(mean, 3),
                      "stddev": round(var ** 0.5, 3),
                      "min": mn, "max": mx}
        return out


STREAMING = StreamingStats()
