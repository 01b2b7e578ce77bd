"""BMP output and mesh handles."""
