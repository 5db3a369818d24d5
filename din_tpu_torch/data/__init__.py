"""Request fixtures of the port."""
