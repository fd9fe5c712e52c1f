"""The benchmark of ``funscript_flow_tpu_torch`` (see README.md)."""
