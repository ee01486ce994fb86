"""PyTorch / CUDA port of motionpriorcmax_tpu for NVIDIA Hopper (H100).

The JAX package `motionpriorcmax_tpu` is the reference; this package mirrors
its layout so each module's counterpart is easy to find:

  ops/          plain tensor functions (basis, grids, events, gradients,
                exact KNN, padding, flow error)
  ops/cuda/     the hand-written Hopper kernels' wrappers (JAX: ops/pallas/)
  csrc/         the kernels' CUDA C++ sources
  models/       nn.Modules in NCHW (RAFT-Spline, the flow UNet)
  losses/       the focus (contrast-maximization) loss
  training/     train / validation steps, the flow-training loop, model
                construction, checkpoints and weight conversion
  metrics/      masked flow / trajectory metrics and the metric bank
  config/       Hydra-style YAML composition
  data/         host-side dataset readers (DSEC, EVIMO2), collate, loader
  utils/        the 16-bit PNG reader
  cli/          `python -m motionpriorcmax_tpu_torch.cli flow-train|traj-val`

Entry points run on CUDA unless the caller passes device="cpu".  This
package imports torch and numpy only, never JAX or the JAX package.
"""
