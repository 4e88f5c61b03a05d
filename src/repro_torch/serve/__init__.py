"""Continuous-batching serving: paged slab, batcher, engine."""
