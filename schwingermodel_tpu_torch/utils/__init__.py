"""Random numbers, statistics, metrics."""
