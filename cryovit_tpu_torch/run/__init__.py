"""Runners: feature extraction and inference."""
