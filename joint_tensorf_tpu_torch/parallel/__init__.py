"""Ray-sharded data parallelism over torch.distributed (counterpart of
joint_tensorf_tpu/parallel/)."""
