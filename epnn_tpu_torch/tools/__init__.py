"""Tools that measure the port on the card (run as modules)."""
