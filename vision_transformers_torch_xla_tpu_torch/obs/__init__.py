"""Host-side metric meters, experiment loggers, the profiler and the
stall watchdog."""
