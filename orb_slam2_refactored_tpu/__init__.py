"""Device-resident visual SLAM engine (ORB-SLAM2 capabilities, built from scratch).

A brand-new JAX/XLA implementation of a feature-based visual SLAM
system with monocular, stereo and RGB-D support, local mapping, loop closing,
Sim3 pose-graph optimization and global bundle adjustment.

Reference capability surface: tiantianxuabc/ORB_SLAM2_Refactored
(`/root/reference/include/System.h:39`), re-designed for an accelerator:

- ORB extraction: batched, fully vectorized FAST + IC-angle + rBRIEF over an
  image pyramid, static shapes, jit-compiled once per camera geometry.
- Matching: packed 256-bit descriptors as uint32[8]; Hamming distance as
  one exact bf16 matmul of +-1 bit vectors, masked per matcher (grid window /
  epipolar band / BoW node), one core serving every matcher variant.
- Optimization: Levenberg-Marquardt with Schur-complement landmark
  marginalization written directly in JAX (`lax.while_loop`), sharded over a
  `jax.sharding.Mesh` for multi-chip global BA.
- Pipeline: the reference's four mutex-coordinated threads become a staged
  pipeline over immutable device-resident map state with host-side
  orchestration (no locks).
"""

__version__ = "0.1.0"

# NOTE on precision (NVIDIA H100): an f32 matmul at JAX's default precision
# may run in TF32 (10-bit mantissa) on the tensor cores. The optimizers
# (Hessian assembly in optim/*) force f32 locally via
# jax.default_matmul_precision("highest") context managers. In extraction,
# each matmul was checked on the card against the CPU: the pyramid resize,
# the in-window blur and the IC-angle moments pass precision=HIGHEST (TF32
# moved them past the ORB parity gates); the gray conversion, the separable
# blur and the bit packing stay at default (they matched the CPU on the
# card). The BRIEF and Hamming contractions are explicit bf16 with f32
# accumulation.
