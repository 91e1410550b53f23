"""The benchmark of joint_tensorf_tpu_torch, the PyTorch and CUDA port:
BAT's training throughput through Trainer.run on one H100.  See
README.md."""
