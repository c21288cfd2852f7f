"""Benchmark of nmch_tpu_torch on one H100: see BENCHMARK.json and PERF.md."""
