"""The least time the B1 (``bias_act``) and B2 (``smooth_upsample``) calls
of the traced window could take, the larger of their byte bound (inputs
read once, outputs written once, 3.35 TB/s) and operation bound (it is
the byte bound), over the device time of the kernels named below."""

UNIT = "%"
KERNELS = ("fused_bias_act_kernel", "smooth_upsample_kernel")


def read(r):
    t = r.trace
    if t is None or not r.kernel_bound_s_per_call:
        return None
    spent = t.seconds_of(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * r.kernel_bound_s_per_call * t.calls / spent
