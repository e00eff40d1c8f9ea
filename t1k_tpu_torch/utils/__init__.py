"""Per-stage metrics and profiling of the port."""
