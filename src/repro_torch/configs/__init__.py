"""Configurations of the port (``pim_ml``: the paper's own workloads)."""
