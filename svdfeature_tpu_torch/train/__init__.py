"""The training task."""
