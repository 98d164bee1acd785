"""Benchmarks: the reduction microbench (``microbench``)."""
