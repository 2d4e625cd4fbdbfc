"""The harness of the port's benchmark (``bench/run.py``)."""
