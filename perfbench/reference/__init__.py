"""The plain reference the benchmark holds the port against.

Plain PyTorch, written from the published description of each model and
loss (MotionPriorCMax, ECCV 2024, arXiv:2407.10802; RAFT-Spline, the
reference's `raft-spline` experiments): no kernel, no cache, no batching
trick.  It imports nothing of the program (`motionpriorcmax_tpu_torch`)
and nothing of the JAX package, and takes nothing the program made: the
benchmark hands it the raw inputs (events, voxel grids of the EVIMO2
samples, GT flow) and the weights it drew from the seed, and it works out
the rest itself (voxel grids of DSEC windows, KNN, interpolation, warp,
votes, the optimizer).  Where it starts from the port's plain code it is a
copy.

  nets.py    the DSEC UNet and RAFT-Spline (state-dict names of the port)
  focus.py   the focus loss and the voxel grid
  optim.py   AdamW and the one-cycle schedule
  steps.py   one training step of each model, and RAFT-Spline's request
"""
