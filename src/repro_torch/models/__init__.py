"""Model configuration and the dense transformer of the serving fleet."""
