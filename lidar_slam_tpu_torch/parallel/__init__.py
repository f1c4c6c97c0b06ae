"""The parallel layer on ``torch.distributed`` (counterpart of
``lidar_slam_tpu.parallel``)."""
