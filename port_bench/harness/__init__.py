"""The benchmark harness of t1k_tpu_torch: traffic generation, the timed
window, spans and counters, trace reduction, rooflines and the output
check.  Nothing here imports jax, jaxlib or t1k_tpu."""
