"""``k4.launches_per_scan``: layer kernel K4, ``csrc/vol_lookup.cu``. The
program's ``k4.launches`` counter (``slambench/spans.py``), the traced
session's K4 launches, over the scans it mapped: an exact count, two a scan
in the PF step (its particles' lookup and its estimate's refinement) and 0
where the main path bypasses the kernel. A program that keeps no such
counter reads None."""

from slambench import spans


def read(data: dict):
    made = spans.counter("k4.launches")
    scans = data.get("scans_traced")
    if made is None or not scans:
        return None
    return made / scans
