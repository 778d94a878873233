"""Device time from `torch.profiler`: the one reader of a profile's device
events that the smoke script and the stage profiler share."""

from __future__ import annotations

import collections
import re

import torch

DeviceEvent = collections.namedtuple("DeviceEvent", "name start us")


def device_events(prof) -> list:
    """The device events of a finished torch.profiler run as (name, start
    µs, µs), read from its kineto results with the names, filters and
    durations that `prof.events()` gives them, without the Python object per
    event that `prof.events()` builds (tens of seconds of host time for the
    179 k operations of a comp micro-step with the flow). An asynchronous
    event counts with 0 µs; a hidden one is left out."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or _filter_name(e.name()) \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        out.append(DeviceEvent(_rewrite_name(name=e.name(), with_wildcard=True),
                               e.start_ns() / 1e3,
                               0.0 if is_async else (e.end_ns() - e.start_ns()) / 1e3))
    return out


def device_operations(fn, pattern: str = "", warmup: bool = True) -> tuple[int, float]:
    """(count, ms of device time) of the device operations of one call of
    `fn` whose name matches `pattern`, by torch.profiler; after one call
    unprofiled where `warmup`."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [e.us for e in device_events(prof) if re.search(pattern, e.name)]
    return len(found), sum(found) / 1e3
