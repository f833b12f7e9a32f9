"""Command-line front end (serve)."""
