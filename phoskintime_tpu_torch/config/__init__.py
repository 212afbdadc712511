"""Numeric policy (device and dtype) for the port."""
