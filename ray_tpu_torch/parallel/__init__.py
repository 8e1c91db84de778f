"""Parallel attention (only the exact reference in this slice)."""
