"""joint_tensorf_tpu_torch — the PyTorch/CUDA port of joint_tensorf_tpu.

The JAX package ``joint_tensorf_tpu`` is the reference; this package mirrors
its subpackages and module names so that each module's counterpart is easy
to find.  Plain tensor code is PyTorch; the TPU's Pallas kernels on the
ported path are hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes`` (``ops/cuda_build.py``).

Ported so far: BAT on the Euclidean path through its whole schedule (the
JAX trainer's default ``tpu:`` path: sample compaction, the dense-grid
density, the two-stage appearance; voxel upsamples, alpha-mask updates,
the bbox shrink), its evaluation (validation, pose error, test-time pose
optimisation, PSNR / SSIM), checkpoints in the JAX package's layout, and
the training (``python -m joint_tensorf_tpu_torch.train``) and evaluation
(``python -m joint_tensorf_tpu_torch.evaluate``) entry points.  Every
Pallas kernel of the JAX package has a CUDA counterpart: the compositor
forward and backward (K1/K2), the row scatter-add (K3), the tile-binned
plane-gradient scatter (K4) and the block-local row scatter (K5).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
