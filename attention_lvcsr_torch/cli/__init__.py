"""Command-line front ends: ``run`` and the recipes' tools."""
