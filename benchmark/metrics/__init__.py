"""Per-layer metric readers, one file each, named as the metric."""
