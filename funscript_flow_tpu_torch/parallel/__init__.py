"""Data parallelism over a device list (``dp``) and the time-axis-sharded
signal chain (``signal_sp``)."""
