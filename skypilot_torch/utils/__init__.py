"""Host-side utilities of the port (on-demand profiling)."""
