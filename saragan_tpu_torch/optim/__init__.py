"""Optimizers and the parameter EMA of the port."""
