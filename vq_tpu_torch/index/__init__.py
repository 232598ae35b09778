"""Search indexes of the port (flat so far)."""
