"""Logical-axis sharding over a torch DeviceMesh (``partition``)."""
