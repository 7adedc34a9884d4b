"""Data substrates of the port."""
