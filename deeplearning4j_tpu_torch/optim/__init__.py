"""Optimizers of the port, with optax's interface (``init`` / ``update``)."""
