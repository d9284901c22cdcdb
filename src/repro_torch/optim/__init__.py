"""Optimizer pieces of the port."""
