"""Map and trajectory rendering of the port (``render_map`` and
``map_to_csv``, copies of the JAX package's, so the port imports nothing of
it).

The rendered floor map — magenta points on black, the reference's MATLAB
scatter style (``matlab_map_test.m``) — with the estimated and ground-truth
trajectories overlaid.
"""

from __future__ import annotations

import numpy as np


def render_map(map_xy: np.ndarray, path: np.ndarray | None = None,
               out_path: str = "map_output.png", title: str | None = None,
               gt: np.ndarray | None = None) -> str:
    """Scatter-plot the point map (magenta on black) with optional paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8), facecolor="black")
    ax.set_facecolor("black")
    m = np.asarray(map_xy)
    ax.scatter(m[:, 0], m[:, 1], s=0.5, c="magenta", linewidths=0)
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], c="gray", lw=1.0, label="ground truth")
    if path is not None:
        ax.plot(path[:, 0], path[:, 1], c="cyan", lw=1.0, label="trajectory")
        ax.legend(loc="upper right", facecolor="black", labelcolor="white")
    ax.set_aspect("equal")
    ax.tick_params(colors="white")
    for spine in ax.spines.values():
        spine.set_color("white")
    if title:
        ax.set_title(title, color="white")
    fig.savefig(out_path, dpi=130, facecolor="black", bbox_inches="tight")
    plt.close(fig)
    return out_path


def map_to_csv(map_xy: np.ndarray, out_path: str = "map_output.csv") -> str:
    """The reference's output artifact format (main.c:982-988): x,y a line."""
    np.savetxt(out_path, np.asarray(map_xy), fmt="%f", delimiter=",")
    return out_path
