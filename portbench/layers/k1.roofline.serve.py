"""% of its roofline: the bound of every self-attention forward of the
profiled mesh (``yardstick.forward_bound`` at the configuration's shapes
and the mesh's eval counts) over the device time of the forward kernel
(K1, ``csrc/flash_attention_fwd.cu``) in the trace."""

from portbench import yardstick


def read(readings):
    trace = readings.get("trace")
    calls = readings.get("attention")
    if trace is None or not calls:
        return None
    device_s = trace.op_seconds(yardstick.K1_FORWARD)
    if device_s <= 0:
        return None
    bound = sum(n * yardstick.forward_bound(B, T, H, D) for B, T, H, D, n in calls)
    return 100.0 * bound / device_s
