"""Plain float32 references, one per configuration, found by its name."""
