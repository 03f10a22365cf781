"""Host utilities of the port (pure Python, no torch)."""
