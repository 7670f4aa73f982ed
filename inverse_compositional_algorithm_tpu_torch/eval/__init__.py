"""Benchmark, stage profile and accuracy sweeps of the PyTorch port."""
