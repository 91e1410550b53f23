"""Visualisation of the port (counterpart of joint_tensorf_tpu/viz/):
videos, camera trajectories, pose plots and pose-gradient maps."""
