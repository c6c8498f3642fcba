"""% of a mesh's wall time in which no operation ran on the device: 100 x
(1 - the busy seconds per mesh of the profiled mesh, the union of the
trace's device intervals, over the mean wall seconds of the meshes that
ran outside the profiler).  The profiled mesh's own interval is not the
denominator: the profiler's host cost per operation stretches it, while
the device's work per mesh stays the same."""

from portbench.harness import unprofiled


def read(readings):
    trace = readings.get("trace")
    items = unprofiled(readings)
    profiled = [i for i in readings.get("items", []) if i["profiled"]]
    if trace is None or not items or not profiled:
        return None
    busy = trace.busy_s() / len(profiled)
    if busy <= 0:
        return None
    wall = sum(i["seconds"] for i in items) / len(items)
    return 100.0 * (1.0 - busy / wall)
