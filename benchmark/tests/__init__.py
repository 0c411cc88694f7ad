"""CPU tests of the benchmark at small sizes; tests that need the card are
marked ``cuda`` and skip without one."""
