"""Kernels and numeric helpers: gru_scan, beam_loop, conv1d, edit distance."""
