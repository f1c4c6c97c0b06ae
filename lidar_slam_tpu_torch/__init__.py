"""lidar_slam_tpu_torch — the PyTorch + CUDA port of ``lidar_slam_tpu``.

The layout mirrors the JAX package, so each module's counterpart sits at the
same path there:

core      trig32 sin/cos, SE(2) geometry, sensor model, point map and
          rasters, submap atlas
io        numpy tour synthesizer (museum, loop, corridor, building), dataset
          cache and CSV, the streaming scan server, relay and client
ops       clamped EDT, correlative matching, correlation volume (batched
          over closure candidates), scan-to-scan odometry, landmark
          detection; the two hand-written CUDA kernels (``csrc/``) and their
          wrappers
models    fidelity scan matcher, FastSLAM particle filter, pose graph, graph
          SLAM with loop closure (scan-matcher, particle-filter or submap
          frontend), landmark EKF-FastSLAM and its grid hybrid, submap SLAM,
          landmark bundle adjustment, state conversion from the JAX
          package's pytrees
utils     stage timer and profiling, checkpoint/resume, stall watchdog,
          debug checks, host paging, metrics, rendering

Plain tensor code runs on any device. The two kernels (K1 clamped EDT, K2
correlation volume) launch on CUDA tensors only; CPU tensors take their
plain PyTorch versions. The package never imports ``jax``.
"""

__version__ = "0.1.0"
