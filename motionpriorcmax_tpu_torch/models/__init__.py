"""Models of the port (JAX: motionpriorcmax_tpu/models/)."""
