"""Host/device overlap for the stream executor's ingest."""
