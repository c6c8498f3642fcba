"""% of its roofline: the 5-product bound of every self-attention backward
of the profiled steps (``yardstick.backward_bounds``) over the device time
of the dq and dkv kernels (K2, ``csrc/flash_attention_bwd.cu``) in the
trace."""

from portbench import yardstick


def read(readings):
    trace = readings.get("trace")
    calls = readings.get("attention_backward")
    if trace is None or not calls:
        return None
    device_s = trace.op_seconds(*yardstick.K2_BACKWARD)
    if device_s <= 0:
        return None
    bound = sum(n * yardstick.backward_bounds(B, T, H, D)["backward"][2]
                for B, T, H, D, n in calls)
    return 100.0 * bound / device_s
