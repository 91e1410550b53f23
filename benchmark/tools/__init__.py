"""Scripts that measure the benchmark itself on the card (spreads,
controls); the driver's runs do not call them."""
