"""% of the bf16 peak: the UNet matmul and conv work of each mesh (evals
x batch, fixed by the cell's sampler and steps; ``yardstick``) over the
wall time of the meshes that ran outside the profiler."""

from portbench.harness import mfu


def read(readings):
    return mfu(readings)
