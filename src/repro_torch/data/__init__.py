"""Device-resident data structures (the ring buffer)."""
