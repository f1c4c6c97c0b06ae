"""Small copies of the benchmark's cells for the CPU tests."""

import copy

from slambench import harness


def small_cell(name: str, scans: int | None = None):
    """The cell ``name`` at a size a test run holds: a short log and, for
    graph SLAM, chunks of 32 and closures after 3 keyframes so that closures
    and feedback happen."""
    cell = harness.cell(harness.load_spec(), name)
    cell.config = copy.deepcopy(cell.config)
    if cell.config["system"] == "graph":
        cell.config["tour"]["n_scans"] = scans or 200
        cell.config["chunk_size"] = 32
        cell.config["loop_closure"]["min_gap"] = 3
    else:
        cell.config["tour"]["n_scans"] = scans or 60
    if cell.traffic["kind"] == "paced_stream":
        cell.traffic = dict(cell.traffic, warm_scans=10)
    else:
        cell.traffic = dict(cell.traffic, logs=2)
    return cell
