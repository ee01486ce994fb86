"""Model construction, train / validation steps, the flow-training loop
and checkpoints (JAX: motionpriorcmax_tpu/training/)."""
