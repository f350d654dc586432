"""Model code of the port (dense family so far)."""
