"""The port's counterparts of the repository's ``benchmarks/`` scripts, file
by file (``python -m nmch_tpu_torch.benchmarks.<name>``).  They run on the
card; the tests drive their plain paths on the CPU."""
