"""Profiling, image IO and validation helpers of the PyTorch port."""
