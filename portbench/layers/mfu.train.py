"""% of the bf16 peak: three UNet forwards' matmul and conv work per step
at the cell's batch (the backward counted as twice the forward; remat's
recompute not counted) over the wall time of the steps that ran outside
the profiler."""

from portbench.harness import mfu


def read(readings):
    return mfu(readings)
