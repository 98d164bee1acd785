"""Runnable examples of the port: ``cuda_tutorial``, the hand-written CUDA
counterpart of ``examples/pallas_tutorial.py``."""
