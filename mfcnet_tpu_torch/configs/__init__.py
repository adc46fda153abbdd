"""Command-line parsers of the training entry points."""
