"""The benchmark of flowhigh_tpu_torch (``run.py``); see PERF.md."""
