"""``k1.roofline_pct``: layer ``kernel K1`` (``csrc/edt.cu``). The least
time the traced session's distance fields need (each grid's occupancy bytes
read once and f32 field written once, at 3.35 TB/s; ``roofline.py``) over
the device time of the kernels that computed them, in the profiler's trace.
The count comes from the reference's keyframe refreshes, rasters and
refinements of the session, not from the program's launches."""

from slambench.roofline import kernel_seconds

# device operations that compute the fields: K1's kernel
KERNELS = ("edt_band_kernel",)


def read(data: dict):
    tr, least = data.get("trace"), data.get("least_s")
    if tr is None or least is None or least["k1"] <= 0:
        return None
    spent = kernel_seconds(tr.device_s_by_name, KERNELS)
    return 100.0 * least["k1"] / spent if spent > 0 else None
