"""Serve data plane: the AIMD batch-size controller behind ``batch``."""
