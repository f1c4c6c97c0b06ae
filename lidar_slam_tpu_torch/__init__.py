"""lidar_slam_tpu_torch — the PyTorch + CUDA port of ``lidar_slam_tpu``.

The layout mirrors the JAX package, so each module's counterpart sits at the
same path there:

core      trig32 sin/cos, SE(2) geometry, sensor model, point map and rasters
io        numpy tour synthesizer (museum, loop, corridor, building) and
          dataset cache
ops       clamped EDT, correlative matching, correlation volume (batched
          over closure candidates), scan-to-scan odometry; the two
          hand-written CUDA kernels (``csrc/``) and their wrappers
models    fidelity scan matcher, FastSLAM particle filter, pose graph, graph
          SLAM with loop closure (scan-matcher or particle-filter frontend),
          state conversion from the JAX package's pytrees
utils     stage timer

Plain tensor code runs on any device. The two kernels (K1 clamped EDT, K2
correlation volume) launch on CUDA tensors only; CPU tensors take their
plain PyTorch versions. The package never imports ``jax``.
"""

__version__ = "0.1.0"
