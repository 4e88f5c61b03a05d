"""Plan IR, masks and attention engines of the port's serving path."""
