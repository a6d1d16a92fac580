"""Reading `jabd.*` spans back from a torch profiler's kineto events, for
the tracing test and the parallel tasks' span trees."""


def host_events(prof):
    return [ev for ev in prof.profiler.kineto_results.events() if not str(ev.device_type()).endswith("CUDA")]


def inside(events, outer):
    """The events of `events` within `outer`'s range, by start."""
    lo, hi = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    return sorted((ev for ev in events if ev is not outer and lo <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= hi),
                  key=lambda ev: ev.start_ns())


def named(events, name):
    return sorted((ev for ev in events if ev.name() == name), key=lambda ev: ev.start_ns())


def span_tree(prof, root):
    """The names of the `jabd.` spans inside each `root` span of a
    profiler's host events, in order of start."""
    host = host_events(prof)
    return [[ev.name() for ev in inside(host, outer) if ev.name().startswith("jabd.")] for outer in named(host, root)]
