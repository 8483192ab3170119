"""The paper's core (§IV), ported module by module from ``repro.core``.

  profiles   — AR profile/message encoding (int32 lanes)
  matching   — associative selection (plain torch; armatch on the card)
  sfc        — Hilbert space-filling-curve content routing
  overlay    — location-aware quadtree overlay -> routing table
  routing    — dispatch plans: core-tier compaction, AR route_local
  store      — sharded DHT storage layer (one shard on the device)
  rules      — IF-THEN data-driven rule engine
  serverless — function profiles, store/find/start/stop
  pipeline   — rule-gated edge/core data-driven pipelines
"""
