"""Device latency histograms and the host span tracer."""
