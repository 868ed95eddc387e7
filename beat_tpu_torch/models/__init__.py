"""Composites and the Problem of the port."""
