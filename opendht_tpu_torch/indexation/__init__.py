"""Host-side indexes over a DHT surface: the Prefix Hash Tree."""
