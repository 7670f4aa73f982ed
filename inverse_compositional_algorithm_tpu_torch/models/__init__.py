"""Solvers and the user-facing API of the PyTorch port."""
