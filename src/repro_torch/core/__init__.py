"""Plan IR, masks, attention engines and the quantization grids of the
port."""
