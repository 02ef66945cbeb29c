"""Numpy helpers shared with the JAX package (verbatim copies)."""
