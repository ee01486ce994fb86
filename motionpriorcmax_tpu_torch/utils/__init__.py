"""Host utilities (JAX: utils/)."""
