"""% of the profiled steps' interval in which no operation ran on the
device (the union of the trace's device intervals)."""

from portbench.harness import idle_share


def read(readings):
    return idle_share(readings)
