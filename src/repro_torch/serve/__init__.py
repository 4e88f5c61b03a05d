"""Serving: the lockstep engine and its caches, the continuous-batching
engine with its paged slab (fp or int8) and batcher."""
