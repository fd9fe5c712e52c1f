"""The benchmark harness of ``funscript_flow_tpu_torch``: one cell of
``BENCHMARK.json`` run once (``perfbench/run.py``)."""
