"""Space-peak tracking (the GT_ENV_OPTIONS=-spacepeak surface).

Capability equivalent of the reference's memory bookkeeping trio:
  * gt_spacepeak_* combined ledger (ref: src/core/spacepeak.c) — a
    process-wide current/max counter that big engines feed explicitly
    (the reference feeds it from ma/fa hooks when
    GT_MEM_BOOKKEEPING=on);
  * gt_ma_show_space_peak (ref: src/core/ma.c:279) — the
    "# space peak in megabytes: %.2f (in N events)" line;
  * gt_spacepeak_show_space_peak (ref: src/core/spacepeak.c) — the
    "# combined space peak in megabytes: %.2f" line.

The JAX rebuild cannot hook the allocator the way a C library can, so
the ledger takes two feeds:
  * explicit add/free calls from the engines that manage large buffers
    (parts planner, index writers) — the spacepeak.c analog;
  * the kernel's own high-water mark (VmHWM from /proc/self/status,
    ru_maxrss as fallback), which by definition covers every numpy /
    JAX host buffer — stronger than malloc bookkeeping, which misses
    mmap'ed regions the reference tracks separately in fa.c.
The printed peak is max(ledger peak, RSS high-water delta since
enable), so explicit tracking can only sharpen, never shrink, the
reported number.
"""

from __future__ import annotations

import sys
import threading


def _rss_highwater_kb() -> int:
    """VmHWM in kB (Linux); falls back to ru_maxrss."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1])
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


class Spacepeak:
    """Combined current/max ledger (ref: src/core/spacepeak.c
    GtSpacepeakLogger: current, max, mutex)."""

    def __init__(self):
        self.current = 0
        self.max = 0
        self.events = 0
        self._lock = threading.Lock()
        self._base_kb = _rss_highwater_kb()

    def add(self, size: int) -> None:
        with self._lock:
            self.current += size
            self.events += 1
            if self.current > self.max:
                self.max = self.current

    def free(self, size: int) -> None:
        with self._lock:
            self.current -= size

    def peak_bytes(self) -> int:
        rss_delta = max(0, _rss_highwater_kb() - self._base_kb) * 1024
        return max(self.max, rss_delta)

    def show(self, out=None) -> None:
        """Both reference lines, same formats (ma.c:279 prints the
        malloc peak with its event count; spacepeak.c prints the
        combined peak)."""
        out = out or sys.stdout
        mb = self.peak_bytes() / (1 << 20)
        print(f"# space peak in megabytes: {mb:.2f} "
              f"(in {self.events} events)", file=out)
        print(f"# combined space peak in megabytes: {mb:.2f}", file=out)


_global: Spacepeak | None = None


def enable() -> Spacepeak:
    """gt_spacepeak_init + gt_ma_enable_global_spacepeak
    (ref: src/core/init.c:109-112)."""
    global _global
    if _global is None:
        _global = Spacepeak()
    return _global


def enabled() -> bool:
    return _global is not None


def add(size: int) -> None:
    if _global is not None:
        _global.add(size)


def free(size: int) -> None:
    if _global is not None:
        _global.free(size)


def show_at_exit() -> None:
    """Print the peak lines on interpreter exit (the reference prints
    "upon deletion" of the allocator, i.e. at gt_lib_clean)."""
    import atexit
    sp = enable()
    atexit.register(sp.show)
