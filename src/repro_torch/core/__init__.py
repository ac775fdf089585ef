"""Router core: ELO engine, host vector DB, device state, router, dispatch."""
