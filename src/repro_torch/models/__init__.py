"""Model code of the port (kind-A decoder, paged path)."""
