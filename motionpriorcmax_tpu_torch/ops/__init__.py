"""Plain tensor ops of the port (JAX: motionpriorcmax_tpu/ops/)."""
