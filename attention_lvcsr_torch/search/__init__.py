"""Beam search over the whole-loop decode kernel."""
