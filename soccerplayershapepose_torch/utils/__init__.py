"""Device and precision helpers."""
