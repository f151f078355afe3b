"""The model."""
