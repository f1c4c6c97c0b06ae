"""``k2.roofline_pct``: layer ``kernel K2`` (``csrc/corr_volume.cu``). The
least time the traced session's closure correlation volumes need (each the
larger of its adds at 67 TFLOP/s f32 and its bytes at 3.35 TB/s;
``roofline.py``) over the device time of the kernels that built them, in the
profiler's trace. The count comes from the reference's closure attempts of
the session and their valid beams, not from the program's launches."""

from slambench.roofline import kernel_seconds

# device operations that build the volumes: K2's kernel
KERNELS = ("corr_volume_kernel",)


def read(data: dict):
    tr, least = data.get("trace"), data.get("least_s")
    if tr is None or least is None or least["k2"] <= 0:
        return None
    spent = kernel_seconds(tr.device_s_by_name, KERNELS)
    return 100.0 * least["k2"] / spent if spent > 0 else None
