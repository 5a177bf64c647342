"""Multi-device pieces of the port (one device today: the MoE FFN)."""
