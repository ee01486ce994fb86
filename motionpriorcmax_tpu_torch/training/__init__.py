"""Model construction, validation step and checkpoint conversion
(JAX: motionpriorcmax_tpu/training/)."""
