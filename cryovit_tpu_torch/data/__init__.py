"""Host-side preprocessing."""
