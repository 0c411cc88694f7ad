"""Drivers, one per traffic mode, found by the mode's name."""
