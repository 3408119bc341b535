"""What the benchmark reads from a torch.profiler trace of a traced block:
the device's busy time as the union of its operations' intervals, the
device time of the operations launched inside each of the benchmark's
ranges, the kernel launches, and the breakdown (the device operations that
took most time, the longest idle gaps by what the host was doing)."""

import bisect

from torch.autograd import DeviceType

TOP = 10


def _union(intervals):
    """Total length and the gaps of the union of (start, end) intervals."""
    busy, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _innermost(cpu, t):
    """The name of the shortest host event that covers time t."""
    best = None
    for s, e, name in cpu:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "(no host event)"


def _inside(starts, ends, t):
    """Whether t lies in one of the sorted, disjoint intervals."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def read_profile(prof, range_names, wall_s):
    """The numbers of one traced block of `wall_s` seconds (host clock).

    A device operation belongs to a range when the host call that launched
    it (the runtime event with the operation's correlation id) lies inside
    one of the range's intervals."""
    device, cpu, launch = [], [], {}
    spans = {name: [] for name in range_names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in range_names or getattr(e, "is_user_annotation",
                                                False):
                continue
            device.append((e.time_range.start, e.time_range.end, e.name,
                           e.id))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.time_range.start, e.time_range.end, e.name))
            if e.name in spans:
                spans[e.name].append((e.time_range.start, e.time_range.end))
            elif e.name.startswith("cu"):
                launch[e.id] = e.time_range.start
    ranges = {}
    for name, iv in spans.items():
        iv.sort()
        # nested calls of one range (an apply inside an apply) count once
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        ranges[name] = {"count": len(iv), "device_s": 0.0,
                        "_iv": ([s for s, _ in merged],
                                [e for _, e in merged])}
    unlinked = 0
    for s, e, _, cid in device:
        t = launch.get(cid)
        if t is None:
            unlinked += 1
            continue
        for r in ranges.values():
            if _inside(*r["_iv"], t):
                r["device_s"] += (e - s) * 1e-6
    for r in ranges.values():
        del r["_iv"]
    busy_us, gaps = _union([(s, e) for s, e, _, _ in device])
    by_name = {}
    for s, e, name, _ in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    kernels = sum(1 for _, _, n, _ in device
                  if not n.startswith(("Memcpy", "Memset")))
    cpu.sort()
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_innermost(cpu, (a + b) / 2), (b - a) * 1e-6]
            for a, b in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": wall_s,
            "kernel_launches": kernels, "device_ops": len(device),
            "unlinked_ops": unlinked, "ranges": ranges,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": idle}}
