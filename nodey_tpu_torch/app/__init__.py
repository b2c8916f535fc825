"""User-facing entry points."""
