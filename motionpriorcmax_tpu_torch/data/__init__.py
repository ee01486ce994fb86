"""Host-side dataset readers (JAX: motionpriorcmax_tpu/data/)."""
