"""Optimizers of the port: ``adamw`` and the DL4J updaters over
``transforms`` (optax's interface and state, ``init`` / ``update``),
schedules and training listeners."""
