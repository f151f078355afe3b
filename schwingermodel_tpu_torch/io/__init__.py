"""Configuration and summary files."""
