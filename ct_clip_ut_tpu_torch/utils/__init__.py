"""Host-side utilities of the port (numpy only)."""
