"""Service layer of the port (the one-shot smoother service)."""
