"""Model family: bottom, encoder, attention, generator, recognizer."""
