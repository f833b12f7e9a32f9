"""The kernels' wrappers with their plain versions, and numeric helpers."""
