"""The inference task."""
