"""Data pipeline: text loaders, binary buffers and batch packing (numpy)."""
