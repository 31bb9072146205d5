"""Problem types and the gallery."""
