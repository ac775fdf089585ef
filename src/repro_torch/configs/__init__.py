"""Router configurations."""
