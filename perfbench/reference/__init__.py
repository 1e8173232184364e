"""Plain references of the configurations (imports nothing of the port)."""
