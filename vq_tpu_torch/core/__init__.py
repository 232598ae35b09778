"""Framework-level pieces of the port (configs, bit packing, FFD layouts)."""
