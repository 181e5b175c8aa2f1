"""Model substrate, blocks, paged attention backend and assembly."""
