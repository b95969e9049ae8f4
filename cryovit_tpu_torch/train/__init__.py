"""The .model artifact."""
