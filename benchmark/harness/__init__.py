"""The benchmark's own code: finding cells, configurations, traffic, entries
and metric readers by name; drawing weights and traffic from the seed;
running the window; reading the device trace; the peaks of the card."""
