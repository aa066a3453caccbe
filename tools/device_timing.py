"""Kernel timing on the card with CUDA events.

``time_ms`` times one call between two events (host dispatch included);
``device_ms`` a call's device-only time (n calls back to back behind a
spin kernel, so that the window holds device work only); ``cupti_ms`` the
same from torch.profiler's CUPTI records; ``timing`` gives a kernel row
both.  Imports torch and numpy only, so that a script can time any tree of
the port with it (``tools/movement_probe.py``) as ``chip_smoke.py`` does.
"""
import math
import time

import numpy as np
import torch


def time_ms(fn, setup=None, reps=5, warmup=1):
    """Median milliseconds of fn() on the current stream (CUDA events);
    setup() runs before each start event and is not timed."""
    times = []
    for r in range(warmup + reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


#: device-only timing (device_ms): the queued calls hold at least this much
#: device work, and are at most DEVICE_MAX_CALLS
DEVICE_WINDOW_MS = 2.0
DEVICE_MAX_CALLS = 200
_SPIN_CYCLES_PER_MS = []


def _spin_cycles_per_ms():
    """Cycles of torch.cuda._sleep (a spin kernel) per device millisecond,
    measured once with CUDA events."""
    if not _SPIN_CYCLES_PER_MS:
        cycles = 1 << 24
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def _queued_window(fn, n, spin_ms):
    """(ms a call, covered): n back-to-back calls of fn, with no synchronize
    between them, between two CUDA events, all queued behind a spin kernel
    of spin_ms.  covered is False when the card had reached the start event
    before the host finished queuing (the window may then hold host gaps)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    covered = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, covered


def cupti_ms(fn, n=20):
    """Device time a call of fn from torch.profiler's CUPTI records: the
    summed durations of the device activities of n calls, over n; None
    when three profiled runs recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                dt = getattr(ev, "device_time", None)
                total_us += dt if dt is not None else \
                    getattr(ev, "cuda_time", 0.0)
        if total_us > 0:
            return total_us / 1e3 / n
    return None


def device_ms(fn):
    """(ms, how): fn's device-only milliseconds a call (its kernel
    time).  After a warm-up, n calls run
    back to back between two events behind a spin kernel long enough for
    the host to queue all n, so the window holds device work only, host
    dispatch excluded; n is the least that gives DEVICE_WINDOW_MS of device
    work, at most DEVICE_MAX_CALLS.  A call that waits for the card itself
    (the spin then cannot cover the host) is timed from CUPTI instead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    n = 1
    for _ in range(4):
        per_call, covered = _queued_window(fn, n, 2.0 * n * host_ms + 0.5)
        if not covered:
            host_ms *= 4
            continue
        want = DEVICE_MAX_CALLS if per_call <= 0 else min(
            DEVICE_MAX_CALLS, max(1, math.ceil(DEVICE_WINDOW_MS / per_call)))
        if n >= want:
            return per_call, f"events, {n} calls"
        n = want
    ms = cupti_ms(fn)
    if ms is None:
        raise AssertionError("device_ms: neither the queued events nor "
                             "CUPTI gave a device time")
    return ms, "cupti"


def timing(fn, setup=None):
    """A kernel row's times: ``ms`` device only a call (device_ms) and
    ``call_ms`` one call between two events, host dispatch included
    (time_ms), what a caller pays a call.  A kernel that needs setup() before
    each launch (one that works in place) has only its single-call time,
    as both, and the row says so in ``ms_by``."""
    call = time_ms(fn, setup=setup)
    if setup is not None:
        return {"ms": call, "call_ms": call,
                "ms_by": "single call (setup before each launch)"}
    ms, how = device_ms(fn)
    return {"ms": ms, "call_ms": call, "ms_by": how}
