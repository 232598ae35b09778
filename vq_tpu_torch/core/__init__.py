"""Framework-level pieces of the port (bit packing)."""
