"""Checkpoints, the level digest chain and the per-level heartbeat record
(the port's own copies of the JAX package's jax-free resilience modules)."""
