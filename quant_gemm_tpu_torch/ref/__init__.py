"""Numpy goldens."""
